#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving and training
paths, on one GPU.

    python3 tools/profile_torch_slice.py [--out DIR] [--sections LIST]
        [--temperature T] [--spec] [--remat MODE]

Builds the models of chip_smoke.py (random weights from a seed) and runs,
under ``torch.profiler`` (CPU and CUDA activities):

- ``forward``: three full-width forward passes on tokens [4, 1024]
  (attention through the flash kernel);
- ``serve``: one drain of the benchmark's traffic through the fused
  ``DecodeServer`` (after a warm-up drain), labelled by the program's own
  ranges (``kgt.serve.admit``, ``kgt.serve.decode``, ``kgt.serve.commit``
  and, inside them, ``kgt.model.attn`` and ``kgt.model.ffn``/``moe``:
  `kubegpu_tpu_torch.obs.trace.device_span`); ``--temperature`` > 0
  samples with chip_smoke's top-k and top-p, ``--spec`` decodes
  speculatively with chip_smoke's 1-layer draft (``DRAFT_MODEL``,
  lookahead 4, 4 rounds a dispatch);
- ``train``: one full-width AdamW step of ``make_train_step`` at the
  headline training config (chip_smoke's ``TRAIN_MODEL``, batch 4, T =
  2048, after a warm-up step; ``--remat`` none, dots or full), with the
  device time split into GEMMs, K1,
  K2 (on the sm90 instance with the row term delta it computes, which the
  mma instance leaves to PyTorch's reductions and copies), K3, the
  optimizer, copies and casts, reductions and other elementwise kernels;
- ``lora``: the same for one LoRA step (``make_lora_train_step``, rank 16
  on wq and wv, the base frozen; chip_smoke's ``train_lora`` phase);
- ``moe``: the same for one AdamW step of chip_smoke's ``MOE_MODEL`` (the
  ``moe`` preset's 4 experts, top-2, at the serving width) at batch 4,
  T = 2048;
- ``ring``: one pass of ring attention (forward and backward over every
  virtual rank in this process, chip_smoke's ``ring_pass``) at the
  training shape, sp = 4 and 2, after a warm-up pass.

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


# the program's ranges on the serving path, outermost first
SERVE_LABELS = ("kgt.serve.admit", "kgt.serve.decode", "kgt.serve.commit",
                "kgt.model.attn", "kgt.model.ffn", "kgt.model.moe")


def _summary(prof, wall_s: float, name: str, labels=()) -> dict:
    """``labels`` are host ranges: each one's calls, host time and the
    device time of the kernels launched inside it, at any depth (a
    kernel under ``kgt.serve.admit`` and ``kgt.model.attn`` counts for
    both)."""
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
    by_label = {lab: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
                for lab in labels}
    for e in prof.events():
        row = by_label.get(e.name)
        if row is None or e.device_type != DeviceType.CPU:
            continue        # the range's mirror on the device's line
        row["calls"] += 1
        row["host_ms"] += e.cpu_time_total / 1e3
        row["device_ms"] += e.device_time_total / 1e3
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
                    help="comma-separated subset of forward,serve,train,"
                         "lora,moe,ring")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="serve: > 0 samples (top-k/top-p of chip_smoke)")
    ap.add_argument("--spec", action="store_true",
                    help="serve: speculative with chip_smoke's draft")
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"],
                    help="train: the rematerialisation mode")
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
        _serve(cfg, params, acts, args.temperature, args.spec)
    del params
    torch.cuda.empty_cache()
    if "train" in sections:
        _train(dev, acts, args.out, args.remat)
    if "lora" in sections:
        _lora(dev, acts, args.out)
    if "moe" in sections:
        _moe(dev, acts, args.out)
    if "ring" in sections:
        _ring(dev, acts)
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


def _serve(cfg, params, acts, temperature: float, spec: bool) -> None:
    import torch
    from torch.profiler import profile

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    prompts = cs._serve_prompts(cfg)
    kw = {}
    if temperature > 0:
        kw.update(cs.SAMPLING, temperature=temperature)
    if spec:
        dcfg = TransformerConfig(**cs.DRAFT_MODEL)
        kw.update(draft_cfg=dcfg, lookahead=cs.SPEC_LOOKAHEAD,
                  spec_rounds=cs.SPEC_ROUNDS, draft_params=init_params(
                      torch.Generator(device=params["embed"].device)
                      .manual_seed(1), dcfg))

    def drain():
        srv = DecodeServer(cfg, params, slots=cs.SERVE_SLOTS, **kw)
        rids = [srv.submit(p, max_new=cs.SERVE_MAX_NEW) for p in prompts]
        srv.run()
        torch.cuda.synchronize()
        return sum(len(srv.result(r)) for r in rids)

    drain()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n_tok = drain()
        wall = time.perf_counter() - t0
    row = _summary(prof, wall, "serve", SERVE_LABELS)
    row.update(tokens=n_tok, temperature=temperature, spec=spec)
    print(json.dumps(row), flush=True)


def _batches(dev, vocab: int, n: int = 2) -> list:
    """``n`` training batches [B, T + 1] of chip_smoke's bigram chain."""
    import numpy as np
    import torch

    import chip_smoke as cs

    return [torch.from_numpy(cs.bigram_tokens(
        vocab, cs.TRAIN_BATCH * (cs.TRAIN_SEQ + 1), seed=i).astype(
            np.int64).reshape(cs.TRAIN_BATCH, -1)).to(dev) for i in range(n)]


def _profile_step(step, batches, acts, out, name, **info) -> None:
    """One step on ``batches[1]`` under the profiler after a warm-up step
    on ``batches[0]``; ``step(batch)`` returns the loss."""
    import torch
    from torch.profiler import profile

    import chip_smoke as cs

    step(batches[0]).item()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = step(batches[1]).item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out, f"{name}.json"))
    row = _summary(prof, wall, name.split("_step")[0])
    row.update(batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ, loss=loss, **info)
    print(json.dumps(row), flush=True)


def _train(dev, acts, out, remat: str) -> None:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    cfg = TransformerConfig(**cs.TRAIN_MODEL, remat=remat)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(0), cfg)
    step = make_train_step(cfg, optimizer=optimizer)
    _profile_step(lambda b: step(params, opt_state, b)[2],
                  _batches(dev, cfg.vocab), acts, out, f"train_step_{remat}",
                  model=cs.TRAIN_MODEL, remat=remat)


def _lora(dev, acts, out) -> None:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.lora import (init_lora,
                                                 make_lora_train_step)
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import init_sharded, param_leaves

    cfg = TransformerConfig(**cs.TRAIN_MODEL)
    params, _, _ = init_sharded(torch.Generator(device=dev).manual_seed(0),
                                cfg, init_optimizer=False)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), params,
                     cs.LORA_RANK)
    optimizer = cs._lora_optimizer()
    opt_state = optimizer(param_leaves(lora))
    step = make_lora_train_step(cfg, None, cs.LORA_RANK, optimizer)
    _profile_step(lambda b: step(lora, opt_state, params, b)[2],
                  _batches(dev, cfg.vocab), acts, out, "lora_step",
                  model=cs.TRAIN_MODEL, rank=cs.LORA_RANK)


def _moe(dev, acts, out) -> None:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.train import make_train_step

    cfg = TransformerConfig(**{**cs.MOE_MODEL, "max_seq": cs.TRAIN_SEQ})
    params = init_params(torch.Generator(device=dev).manual_seed(6), cfg)
    step, state = make_train_step(cfg), [None]

    def run(batch):
        _, state[0], loss = step(params, state[0], batch)
        return loss

    _profile_step(run, _batches(dev, cfg.vocab), acts, out, "moe_step",
                  model=cs.MOE_MODEL)


def _ring(dev, acts) -> None:
    import torch
    from torch.profiler import profile

    import chip_smoke as cs

    b, t, h, d = cs.TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(9)
    leaves = [x.requires_grad_() for x in cs.case_qkv(
        gen, dev, b, t, t, h, d, torch.bfloat16)]
    do = torch.randn((b, t, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    for sp in (4, 2):
        cs.ring_pass(leaves, do, sp, d ** -0.5)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            cs.ring_pass(leaves, do, sp, d ** -0.5)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        row = _summary(prof, wall, f"ring_sp{sp}")
        row.update(shape=list(cs.TRAIN_SHAPE), sp=sp)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())

