#!/usr/bin/env python3
"""The sharded serving path at world size 1 against the unsharded one, in
turns, on one GPU, and what each collective of the sharded decode step
costs.

    python3 tools/mesh_serve_ab.py [--pairs 5] [--calls 500] [--profile]

Builds chip_smoke.py's serving config (``MODEL``, bf16, random weights
from seed 0, the serve phase's params) and its (1, 1, 1) mesh over a
world-size-1 NCCL process group (a ``file://`` store in a temporary
directory), where every collective runs on a group of one. Then:

1. ``calls``: the host time per call of each collective the sharded
   decode step makes, at its decode shapes (``[4, 1, d_model]`` bf16 for
   the row-parallel outputs, ``[4, 1, vocab/tp]`` for the logits), over
   ``--calls`` calls ended by a synchronise: a raw ``dist.all_reduce``,
   `spmd.reduce_from`, `spmd.copy_to`, `spmd.gather_last` and
   `decode.gather_rows`, beside a plain ``clone`` of the same tensor;
2. ``step``: one greedy decode step of `decode.make_forward_step` over 4
   rows (host clock, ended by a synchronise; ``enqueue``: the host clock
   before that synchronise), with and without the mesh, ``--pairs`` pairs
   of rounds of 20 steps, the order alternating;
3. ``drain``: the serve phase's greedy drain (8 requests of 64 tokens on
   4 slots) through `DecodeServer` with and without the mesh, in the same
   alternating turns, tokens/s of each;
4. with ``--profile``: ``torch.profiler``'s host operations over 20
   decode steps of each side: the top 20 by self CPU time, and the CUDA
   runtime calls (launches, copies, event and stream waits and
   synchronisations) with their counts.

Prints one JSON line a part, the card's name and power limit first.
Needs CUDA; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_us(fn, calls: int) -> float:
    """Microseconds a call of ``fn`` over ``calls`` calls ended by a
    synchronise, after 20 warm-up calls."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("mesh_serve_ab: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.decode import (gather_rows, init_cache,
                                                   make_forward_step)
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)

    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = TransformerConfig(**cs.MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tmp = tempfile.mkdtemp(prefix="kgtpu-mesh-serve-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0)
    try:
        mesh = spmd.make_mesh(1, 1, 1, 1, device=dev)
        local = spmd.shard_params(params, cfg, mesh)
        dt = cfg.compute_dtype()
        rows, s = cs.SERVE_SLOTS, cfg.max_seq
        act = torch.randn((rows, 1, cfg.d_model), device=dev).to(dt)
        logits = torch.randn((rows, 1, cfg.vocab), device=dev).to(dt)
        group = mesh.get_group(spmd.AXIS_MODEL)
        with torch.no_grad():
            calls = {name: _host_us(fn, args.calls) for name, fn in (
                ("clone", lambda: act.clone()),
                ("all_reduce", lambda: dist.all_reduce(act, group=group)),
                ("reduce_from", lambda: spmd.reduce_from(mesh, act)),
                ("copy_to", lambda: spmd.copy_to(mesh, act)),
                ("gather_last", lambda: spmd.gather_last(mesh, logits)),
                ("gather_rows", lambda: gather_rows(mesh, logits)))}
        print(json.dumps({"part": "calls", "shape_act": list(act.shape),
                          "shape_logits": list(logits.shape),
                          "calls": args.calls, "host_us": calls}),
              flush=True)

        sides = {"plain": (make_forward_step(cfg), params, None),
                 "mesh": (make_forward_step(cfg, mesh), local, mesh)}
        caches = {k: init_cache(cfg, rows, s, dev, m)
                  for k, (_, _, m) in sides.items()}
        tok = torch.ones((rows, 1), dtype=torch.long, device=dev)
        # the middle of the cache, where a drain decodes
        pos = torch.full((rows,), s // 2, dtype=torch.long, device=dev)

        def step_round(side: str, n: int = 20) -> list:
            """``n`` steps' (ms, enqueue ms)."""
            step, p, _ = sides[side]
            out = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(p, caches[side], tok, pos)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                out.append(((time.perf_counter() - t0) * 1e3,
                            (t1 - t0) * 1e3))
            return out

        def drain(side: str) -> float:
            _, p, m = sides[side]
            kw = {"mesh": m} if m is not None else {}
            return cs._drain(cfg, p, cs._serve_prompts(cfg),
                             **kw)["tokens_per_s"]

        for side in sides:
            step_round(side, 5)
            drain(side)
        steps = {k: [] for k in sides}
        drains = {k: [] for k in sides}
        for i in range(args.pairs):
            order = ("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")
            for side in order:
                steps[side] += step_round(side)
            for side in order:
                drains[side].append(drain(side))
        print(json.dumps({"part": "step", "rows": rows, "pairs": args.pairs,
                          "ms_median": {k: statistics.median(
                              x[0] for x in v) for k, v in steps.items()},
                          "ms_quartiles": {
                              k: statistics.quantiles([x[0] for x in v],
                                                      n=4)[::2]
                              for k, v in steps.items()},
                          "enqueue_ms_median": {k: statistics.median(
                              x[1] for x in v) for k, v in steps.items()}}),
              flush=True)
        print(json.dumps({"part": "drain", "pairs": args.pairs,
                          "tokens_per_s": drains,
                          "median": {k: statistics.median(v)
                                     for k, v in drains.items()},
                          "pairs_mesh_slower": sum(
                              m < p for m, p in zip(drains["mesh"],
                                                    drains["plain"]))}),
              flush=True)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            def row(e):
                return {"name": e.key, "calls": e.count,
                        "self_cpu_us": e.self_cpu_time_total,
                        "device_us": getattr(e, "self_device_time_total",
                                             0)}

            for side in sides:
                step_round(side, 5)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step_round(side)
                events = prof.key_averages()
                top = sorted(events, key=lambda e: -e.self_cpu_time_total)
                print(json.dumps({
                    "part": "profile", "side": side, "steps": 20,
                    "top_host": [row(e) for e in top[:20]],
                    "cuda_runtime": [row(e) for e in events
                                     if e.key.startswith(("cuda", "cu"))
                                     and not e.key.startswith("cutlass")]}),
                      flush=True)
    finally:
        dist.destroy_process_group()
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
