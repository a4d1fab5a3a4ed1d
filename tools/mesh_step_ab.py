#!/usr/bin/env python3
"""The sharded train step at world size 1 against the single-device step,
in turns, on one GPU.

    python3 tools/mesh_step_ab.py [--pairs 10] [--steps 3]

Builds chip_smoke.py's training config (``TRAIN_MODEL``, batch 4, T =
2048, random weights from a seed) twice: once for ``make_train_step``
without a mesh, once over the (1, 1, 1) mesh of a world-size-1 NCCL
process group (a ``file://`` store in a temporary directory), where every
collective of the sharded path runs on a group of one. After a warm-up
step of each it times ``--pairs`` pairs of rounds of ``--steps`` AdamW
steps, the order alternating (single then mesh, mesh then single, ...),
each step on the host clock around a step that ends in reading its loss.
Prints one JSON line: each side's median step ms and quartiles over all
timed steps, the median of each pair's difference, and how many pairs the
mesh side's round was slower. Needs CUDA; exits non-zero without.
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


def _quartiles(xs) -> list:
    q = statistics.quantiles(xs, n=4)
    return [q[0], q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("mesh_step_ab: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = TransformerConfig(**cs.TRAIN_MODEL)
    batches = [torch.from_numpy(cs.bigram_tokens(
        cfg.vocab, cs.TRAIN_BATCH * (cs.TRAIN_SEQ + 1), seed=i).astype(
            "int64").reshape(cs.TRAIN_BATCH, -1)).to(dev) for i in range(2)]
    with tempfile.TemporaryDirectory(prefix="kgtpu-mesh-ab-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = spmd.make_mesh(1, 1, 1, 1, device="cuda")
            sides = {}
            for name, m in (("single", None), ("mesh", mesh)):
                params, opt, optimizer = init_sharded(
                    torch.Generator(device=dev).manual_seed(0), cfg, m)
                step = make_train_step(cfg, m, optimizer)
                sides[name] = [step, params, opt]

            def run(name, n) -> list:
                step, params, opt = sides[name]
                out = []
                for i in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, opt, loss = step(params, opt, batches[i % 2])
                    loss.item()                      # waits for the step
                    out.append((time.perf_counter() - t0) * 1e3)
                sides[name][1:] = [params, opt]
                return out

            run("single", 1)
            run("mesh", 1)
            times = {"single": [], "mesh": []}
            diffs, mesh_slower = [], 0
            for p in range(args.pairs):
                order = ("single", "mesh") if p % 2 == 0 \
                    else ("mesh", "single")
                got = {name: run(name, args.steps) for name in order}
                for name in got:
                    times[name] += got[name]
                d = statistics.median(got["mesh"]) - \
                    statistics.median(got["single"])
                diffs.append(d)
                mesh_slower += d > 0
        finally:
            dist.destroy_process_group()
    print(json.dumps({
        "tool": "mesh_step_ab", "model": cs.TRAIN_MODEL,
        "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ, "pairs": args.pairs,
        "steps_per_round": args.steps,
        "single_step_ms_median": statistics.median(times["single"]),
        "single_step_ms_quartiles": _quartiles(times["single"]),
        "mesh_step_ms_median": statistics.median(times["mesh"]),
        "mesh_step_ms_quartiles": _quartiles(times["mesh"]),
        "pair_diff_ms_median": statistics.median(diffs),
        "pairs_mesh_slower": mesh_slower,
        "single_step_ms": times["single"], "mesh_step_ms": times["mesh"]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
