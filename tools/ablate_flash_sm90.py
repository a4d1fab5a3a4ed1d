#!/usr/bin/env python3
"""Where the Hopper flash kernels spend their time, on one GPU.

    python3 tools/ablate_flash_sm90.py [--kernels fwd,dq]

Builds a kernel as it is and in variants with one part taken out or
changed, each into its own library under
``build/kubegpu_tpu_torch/ablate/``, and times every variant through the
port's wrapper, beside ``scaled_dot_product_attention`` (a yardstick the
port never calls):

- ``fwd``, the forward (K1, ``csrc/flash_fwd_sm90.cu``), at the training
  shape (B=4, T=2048, H=18, D=128, causal) and the serving shape (B=4,
  T=1024, H=16):
  - ``as_is``: the kernel;
  - ``no_softmax``: the online softmax left out (P is S, unscaled): what
    the products, the copies and the pipeline take alone;
  - ``three_stages``: a three-stage K/V ring instead of two;
- ``dq``, the dQ backward (K2, ``csrc/flash_bwd_dq_sm90.cu``, with the
  delta it computes), at the training shape:
  - ``as_is``: the kernel;
  - ``no_delta``: the delta prologue left out (delta 0, nothing written);
  - ``no_softmax``: the mask, P and dS left out (dS is dP): the products,
    the copies and the pipeline alone;
  - ``no_mask``: the mask pass left out;
  - ``mask_in_loop``: the mask tested element by element inside the exp
    loop, the kernel's first design;
  - ``no_ex2``: P without the exponential;
  - ``two_stages``, ``four_stages``: a K/V ring of two or four stages
    instead of three;
  - ``pingpong``: the two consumer warpgroups take turns to issue their
    products (named barriers), so that one's P and dS run under the
    other's products.

A variant computes wrong numbers by design; only its time is read. Prints
one JSON line per variant and the card's name and power limit. Needs
CUDA; exits non-zero without.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"train": (4, 2048, 18, 128), "serve": (4, 1024, 16, 128)}
LIBS = {"fwd": "flash_fwd_sm90", "dq": "flash_bwd_dq_sm90"}


def _cut(src: str, a: str, b: str) -> str:
    i, j = src.index(a), src.index(b)
    return src[:i] + src[j:]


def _staged(src: str, was: int, now: int) -> str:
    stages = f"constexpr int kStages = {was};"
    assert stages in src
    return src.replace(stages, f"constexpr int kStages = {now};")


def _variants(kernel: str, src: str) -> dict:
    if kernel == "fwd":
        return {"as_is": src,
                "no_softmax": _cut(src, "    // Row max of the raw scores",
                                   "    // P to bf16"),
                "three_stages": _staged(src, 2, 3)}
    return {"as_is": src,
            "no_delta": _cut(src, "  {\n    constexpr int E = D / 32;",
                             "  const float ls0"),
            "no_softmax": _cut(src, "      // Masked scores -inf",
                               "      // dS as bf16 register A operands"),
            "no_mask": _cut(src, "      // Masked scores -inf",
                            "      // P = exp2(S scale2 - lse2)"),
            "mask_in_loop": _mask_in_loop(src),
            "no_ex2": src.replace("dp[nt * 4 + e] = ex2(x) * (",
                                  "dp[nt * 4 + e] = x * ("),
            "two_stages": _staged(src, 3, 2),
            "four_stages": _staged(src, 3, 4),
            "pingpong": _pingpong(src)}


def _mask_in_loop(src: str) -> str:
    """K2 with the mask tested element by element inside the exp loop (its
    first design) instead of in a pass of its own."""
    src = _cut(src, "      // Masked scores -inf",
               "      // P = exp2(S scale2 - lse2)")
    old = ("          const float x = fmaf(sc[nt * 4 + e], scale2, "
           "-(e < 2 ? ls0 : ls1));\n")
    assert src.count(old) == 1
    return src.replace(old, """\
          const int col = k0 + nt * 8 + tg * 2 + (e & 1);
          float x = fmaf(sc[nt * 4 + e], scale2, -(e < 2 ? ls0 : ls1));
          if (masked && !(col < p.Tk && visible(p, e < 2 ? qp0 : qp1,
                                                p.kv_offset + col)))
            x = -INFINITY;
""")


def _pingpong(src: str) -> str:
    """K2 with its two consumer warpgroups taking turns to issue their
    products (named barriers 1 and 2): one's P and dS run while the
    other's products do."""
    def sub(old: str, new: str) -> None:
        nonlocal src
        assert src.count(old) == 1, old
        src = src.replace(old, new)

    sub("using namespace kgt;\n", """using namespace kgt;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\\n" :: "r"(id) : "memory");
}
""")
    sub("  const bool live = w0 < p.Tq;\n",
        "  const bool live = w0 < p.Tq;\n  if (wg == 1) bar_arrive(1);\n")
    sub("      float sc[32], dp[32];\n      wgmma_fence();\n",
        "      float sc[32], dp[32];\n      bar_sync(1 + wg);\n"
        "      wgmma_fence();\n")
    sub("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_acc(sc);",
        "      wgmma_commit();\n      bar_arrive(2 - wg);\n"
        "      wgmma_wait<0>();\n      fence_acc(sc);")
    sub("      wgmma_fence();\n#pragma unroll\n"
        "      for (int kk = 0; kk < BN / 16; ++kk)\n",
        "      bar_sync(1 + wg);\n      wgmma_fence();\n#pragma unroll\n"
        "      for (int kk = 0; kk < BN / 16; ++kk)\n")
    sub("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_acc(dq);\n"
        "    }\n",
        "      wgmma_commit();\n      bar_arrive(2 - wg);\n"
        "      wgmma_wait<0>();\n      fence_acc(dq);\n"
        "    } else {\n      bar_sync(1 + wg);\n      bar_arrive(2 - wg);\n"
        "      bar_sync(1 + wg);\n      bar_arrive(2 - wg);\n    }\n")
    sub("  auto* dqp = ", "  if (wg == 0) bar_sync(1);\n  auto* dqp = ")
    return src


def _compile(kernel: str, name: str, src: str, out: str,
             flags: list) -> str:
    from kubegpu_tpu_torch.workload.kernels import _build as b

    d = os.path.join(out, kernel, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{LIBS[kernel]}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(d, f"lib{LIBS[kernel]}.so")
    proc = subprocess.run([b._nvcc(), *flags, "-I", str(b.CSRC), "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the {kernel} {name} variant:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return lib


def _calls(kernel: str) -> dict:
    """{shape name: a call of the kernel's wrapper on seeded inputs}."""
    import torch

    from kubegpu_tpu_torch.workload.kernels import flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 128 ** -0.5
    calls = {}
    for k, s in SHAPES.items():
        if kernel == "dq" and k != "train":
            continue  # the backward runs in training only
        q, kk, v, do = (torch.randn(s, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(4))
        if kernel == "fwd":
            calls[k] = (lambda q=q, kk=kk, v=v: flash._launch(
                q, kk, v, scale, 0, 0, True, 0))
        else:
            o, lse = flash._launch(q, kk, v, scale, 0, 0, True, 0)
            calls[k] = (lambda q=q, kk=kk, v=v, o=o, do=do, lse=lse:
                        flash.flash_bwd_dq(q, kk, v, o, do, lse, None, scale))
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernels", default="fwd,dq",
                    help="comma-separated subset of fwd,dq")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_sm90: torch.cuda is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.kernels import _build

    print(cs.smi_line(), flush=True)
    out = os.path.join(str(_build.BUILD_ROOT), "ablate")
    shutil.rmtree(out, ignore_errors=True)
    jobs = []
    for kernel in kernels:
        with open(_build.CSRC / f"{LIBS[kernel]}.cu") as f:
            jobs += [(kernel, name, src)
                     for name, src in _variants(kernel, f.read()).items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(
            lambda job: _compile(*job, out, _build.NVCC_FLAGS), jobs))
    _build.build_all()
    real = _build.load
    try:
        for kernel in kernels:
            calls = _calls(kernel)
            for (k, name, _), path in zip(jobs, libs):
                if k != kernel:
                    continue
                lib = ctypes.CDLL(path)
                _build.load = (lambda n, lib=lib, want=LIBS[kernel]:
                               lib if n == want else real(n))
                row = {"kernel": kernel, "variant": name}
                for shape, call in calls.items():
                    row[f"{shape}_ms"] = cs.time_ms(call)
                print(json.dumps(row), flush=True)
                _build.load = real
    finally:
        _build.load = real
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"kernel": "sdpa", "variant": "forward"}
    for k, s in SHAPES.items():
        q, kk, v = (torch.randn(s, generator=gen, device="cuda")
                    .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        row[f"{k}_ms"] = cs.time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kk, v, is_causal=True))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
