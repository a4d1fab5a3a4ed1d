#!/usr/bin/env python3
"""Where the Hopper flash forward (K1, ``csrc/flash_fwd_sm90.cu``) spends
its time, on one GPU.

    python3 tools/ablate_flash_sm90.py

Builds the kernel as it is and in variants with one part taken out, each
into its own library under ``build/kubegpu_tpu_torch/ablate/``, and times
every variant through the port's wrapper at the training shape (B=4,
T=2048, H=18, D=128, causal) and the serving shape (B=4, T=1024, H=16),
beside ``scaled_dot_product_attention`` (a yardstick the port never
calls):

- ``as_is``: the kernel;
- ``no_softmax``: the online softmax left out (P is S, unscaled): what
  the products, the copies and the pipeline take alone;
- ``three_stages``: a three-stage K/V ring instead of two.

A variant computes wrong numbers by design; only its time is read. Prints
one JSON line per variant and the card's name and power limit. Needs
CUDA; exits non-zero without.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"train": (4, 2048, 18, 128), "serve": (4, 1024, 16, 128)}


def _variants(src: str) -> dict:
    def cut(a: str, b: str) -> str:
        i, j = src.index(a), src.index(b)
        return src[:i] + src[j:]

    stages = "constexpr int kStages = 2;"
    assert stages in src
    return {"as_is": src,
            "no_softmax": cut("    // Row max of the raw scores",
                              "    // P to bf16"),
            "three_stages": src.replace(stages, "constexpr int kStages = 3;")}


def _compile(name: str, src: str, out: str, flags: list) -> str:
    from kubegpu_tpu_torch.workload.kernels import _build as b

    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "flash_fwd_sm90.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(d, "libflash_fwd_sm90.so")
    proc = subprocess.run([b._nvcc(), *flags, "-I", str(b.CSRC), "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the {name} variant:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_sm90: torch.cuda is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.kernels import _build, flash

    print(cs.smi_line(), flush=True)
    out = os.path.join(str(_build.BUILD_ROOT), "ablate")
    shutil.rmtree(out, ignore_errors=True)
    with open(_build.CSRC / "flash_fwd_sm90.cu") as f:
        variants = _variants(f.read())
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(
            lambda kv: _compile(*kv, out, _build.NVCC_FLAGS),
            variants.items())))
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {k: [torch.randn(s, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(3)]
            for k, s in SHAPES.items()}
    real = _build.load
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            _build.load = (lambda n, lib=lib:
                           lib if n == "flash_fwd_sm90" else real(n))
            row = {"variant": name}
            for k, (q, kk, v) in data.items():
                row[f"{k}_ms"] = cs.time_ms(lambda: flash._launch(
                    q, kk, v, 128 ** -0.5, 0, 0, True, 0))
            print(json.dumps(row), flush=True)
    finally:
        _build.load = real
    row = {"variant": "sdpa"}
    for k, (q, kk, v) in data.items():
        row[f"{k}_ms"] = cs.time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                is_causal=True))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
