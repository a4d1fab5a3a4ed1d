"""The port's counterpart of ``__graft_entry__.py::entry()``: the flagship
model's forward pass with its example arguments."""

from __future__ import annotations

import torch

from kubegpu_tpu_torch._device import resolve_device
from kubegpu_tpu_torch.workload.model import (TransformerConfig, init_params,
                                              make_forward)


def entry(device=None):
    """``(forward, (params, tokens))``: the reference entry's config on
    tokens ``[2, 128]``, on ``cuda`` unless ``device`` says otherwise. On
    CUDA, attention resolves to the flash kernel (T is a multiple of
    128)."""
    dev = resolve_device(device)
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=8, n_layers=4,
                            d_ff=1024, max_seq=512)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=dev)
    return make_forward(cfg), (params, tokens)
