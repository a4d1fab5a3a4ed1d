"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU
(``device="cpu"``, what the tests pass). Asking for CUDA on a machine
without a GPU raises: nothing quietly continues on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Also pins float32 matrix products and convolutions to full float32
    precision (TF32 off), so the float32 paths compute what the JAX
    reference computes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
