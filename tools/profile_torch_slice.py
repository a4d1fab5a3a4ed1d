#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving and training
paths, on one GPU.

    python3 tools/profile_torch_slice.py [--out DIR] [--sections LIST]

Builds the models of chip_smoke.py (random weights from a seed) and runs,
under ``torch.profiler`` (CPU and CUDA activities):

- ``forward``: three full-width forward passes on tokens [4, 1024]
  (attention through the flash kernel);
- ``serve``: one drain of the benchmark's traffic through the fused
  ``DecodeServer`` (after a warm-up drain), with the admit prefills and the
  decode chunks labelled;
- ``train``: one full-width AdamW step of ``make_train_step`` at the
  headline training config (chip_smoke's ``TRAIN_MODEL``, batch 4, T =
  2048, after a warm-up step), with the device time split into GEMMs, K1,
  K2 (on the sm90 instance with the row term delta it computes, which the
  mma instance leaves to PyTorch's reductions and copies), K3, the
  optimizer, copies and casts, reductions and other elementwise kernels.

For each it prints one JSON line: the wall time, the summed device time of
all kernels, the device's busy share of the wall (kernel time over wall;
overlapping kernels would count twice, and this path runs one stream),
the device time per label, and the kernels that take the most device
time. The forward's and the train step's Chrome traces go to ``--out``
(the serve drain's would exceed what a chip run brings back). Needs CUDA;
exits non-zero without.
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
    # (nor user ranges such as the optimizer's "Optimizer.step#...")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in labels
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
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
                             "device_ms": dev_us(e) / 1e3} for e in top],
            "by_category_ms": {
                cat: sum(dev_us(e) for e in kernels
                         if _category(e.key) == cat) / 1e3
                for cat in sorted({_category(e.key) for e in kernels})}}


def _category(kernel: str) -> str:
    """The kind of a device kernel, from its name."""
    name = kernel.lower()
    for cat, keys in (("K1 flash_fwd", ("flash_fwd",)),
                      ("K2 flash_bwd_dq", ("flash_bwd_dq",)),
                      ("K3 flash_bwd_dkv", ("flash_bwd_dkv",)),
                      ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
                      ("optimizer", ("multi_tensor", "adam")),
                      ("copy_cast", ("copy",)),
                      ("reduce", ("reduce",))):
        if any(k in name for k in keys):
            return cat
    return "elementwise_other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "kubegpu_tpu_torch", "profile"),
        help="where the Chrome traces go")
    ap.add_argument("--sections", default="forward,serve,train",
                    help="comma-separated subset of forward,serve,train")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profile_torch_slice: torch.cuda is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import TransformerConfig, init_params

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = TransformerConfig(**cs.MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    if "forward" in sections:
        _forward(cfg, params, dev, acts, args.out)
    if "serve" in sections:
        _serve(cfg, params, acts)
    del params
    torch.cuda.empty_cache()
    if "train" in sections:
        _train(dev, acts, args.out)
    return 0


def _forward(cfg, params, dev, acts, out) -> None:
    import torch
    from torch.profiler import profile

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import make_forward

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
    prof.export_chrome_trace(os.path.join(out, "forward.json"))
    print(json.dumps(_summary(prof, wall, "forward")), flush=True)


def _serve(cfg, params, acts) -> None:
    import numpy as np
    import torch
    from torch.profiler import profile, record_function

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.serve import DecodeServer

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


def _train(dev, acts, out) -> None:
    import numpy as np
    import torch
    from torch.profiler import profile

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    cfg = TransformerConfig(**cs.TRAIN_MODEL)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(0), cfg)
    step = make_train_step(cfg, optimizer=optimizer)
    batches = [torch.from_numpy(cs.bigram_tokens(
        cfg.vocab, cs.TRAIN_BATCH * (cs.TRAIN_SEQ + 1), seed=i).astype(
            np.int64).reshape(cs.TRAIN_BATCH, -1)).to(dev) for i in range(2)]
    params, opt_state, loss = step(params, opt_state, batches[0])
    loss.item()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batches[1])
        loss.item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out, "train_step.json"))
    row = _summary(prof, wall, "train")
    row.update(model=cs.TRAIN_MODEL, batch=cs.TRAIN_BATCH,
               seq=cs.TRAIN_SEQ, loss=loss.item())
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
