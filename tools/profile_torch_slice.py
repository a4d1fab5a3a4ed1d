#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving slice, on one GPU.

    python3 tools/profile_torch_slice.py [--out DIR]

Builds the model of chip_smoke.py (the serving benchmark's width, random
weights from a seed) and runs, under ``torch.profiler`` (CPU and CUDA
activities):

- ``forward``: three full-width forward passes on tokens [4, 1024]
  (attention through the flash kernel);
- ``serve``: one drain of the benchmark's traffic through the fused
  ``DecodeServer`` (after a warm-up drain), with the admit prefills and the
  decode chunks labelled.

For each it prints one JSON line: the wall time, the summed device time of
all kernels, the device's busy share of the wall (kernel time over wall;
overlapping kernels would count twice, and this path runs one stream),
the device time per label, and the kernels that take the most device
time. The forward's Chrome trace goes to ``--out`` (the serve drain's
would exceed what a chip run brings back). Needs CUDA; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(prof, wall_s: float, name: str, labels=()) -> dict:
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernel events only: the aten ops that launch them carry
    # the same device time and would count it twice, and a label's
    # device-side range spans the kernels inside it
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in labels]
    total_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    by_label = {}
    for lab in labels:
        hit = [e for e in events if e.key == lab]
        by_label[lab] = {
            "calls": sum(e.count for e in hit),
            "host_ms": sum(e.cpu_time_total for e in hit) / 1e3,
            "device_ms": sum(getattr(e, "device_time_total",
                                     getattr(e, "cuda_time_total", 0.0))
                             for e in hit) / 1e3}
    return {"phase": name, "wall_ms": wall_s * 1e3,
            "device_kernel_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e3 / (wall_s * 1e3),
            "labels": by_label,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_ms": dev_us(e) / 1e3} for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "kubegpu_tpu_torch", "profile"),
        help="where the forward's Chrome trace goes")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_slice: torch.cuda is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params, make_forward)
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = TransformerConfig(**cs.MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    # -- forward
    tokens = torch.randint(0, cfg.vocab, cs.FORWARD_TOKENS,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    fwd = make_forward(cfg)
    with torch.no_grad():
        fwd(params, tokens)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fwd(params, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out, "forward.json"))
    print(json.dumps(_summary(prof, wall, "forward")), flush=True)

    # -- serve
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in np.linspace(16, cfg.max_seq // 2,
                                    cs.SERVE_REQUESTS)]

    class Labelled(DecodeServer):
        def _admit(self, slot, req):
            with record_function("admit_prefill"):
                return super()._admit(slot, req)

        def _fused_step(self, active):
            with record_function("decode_chunk"):
                return super()._fused_step(active)

    def drain():
        srv = Labelled(cfg, params, slots=cs.SERVE_SLOTS)
        rids = [srv.submit(p, max_new=cs.SERVE_MAX_NEW) for p in prompts]
        srv.run()
        torch.cuda.synchronize()
        return sum(len(srv.result(r)) for r in rids)

    drain()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n_tok = drain()
        wall = time.perf_counter() - t0
    row = _summary(prof, wall, "serve", ("admit_prefill", "decode_chunk"))
    row["tokens"] = n_tok
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
