#!/usr/bin/env python3
"""Greedy serving of two checkouts of the repository, in turns, on one GPU.

    python3 tools/serve_ab.py DIR_A DIR_B [--pairs N]

Each run is a fresh process in one checkout that builds chip_smoke.py's
serving model from its seed and runs that checkout's own
``chip_smoke.serve_phase`` (a warm-up drain, the timed fused drain of 8
requests of 64 tokens on 4 slots, then the per-token oracle's drain).
Pair ``i`` runs A then B when ``i`` is even, B then A when odd, so a
drift of the host's load over the call falls on both sides. Prints one
JSON line a run (fused tokens/s, the oracle's, TTFT and ITL p50), then
the card's name and power limit and a summary: each side's median and
quartiles and the number of pairs B won. Needs CUDA in each checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = """
import json, torch, chip_smoke as cs
from kubegpu_tpu_torch.workload.model import TransformerConfig, init_params
dev = torch.device("cuda")
cfg = TransformerConfig(**cs.MODEL)
params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
row = cs.serve_phase(dev, cfg, params)
print("RESULT " + json.dumps({k: row[k] for k in (
    "tokens_per_s", "oracle_tokens_per_s", "ttft_p50_ms", "itl_p50_ms",
    "fused_equals_oracle")}))
"""


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=checkout,
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"serve run in {checkout} failed "
                           f"(exit {proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def quartiles(xs: list) -> list:
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("a", help="checkout A (e.g. the parent commit)")
    ap.add_argument("b", help="checkout B (e.g. the change)")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    got = {"a": [], "b": []}
    for i in range(args.pairs):
        for side in ("a", "b") if i % 2 == 0 else ("b", "a"):
            row = run(os.path.abspath(getattr(args, side)))
            got[side].append(row["tokens_per_s"])
            print(json.dumps({"pair": i, "side": side, **row}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({
        "pairs": args.pairs,
        "a_tokens_per_s_q1_median_q3": quartiles(got["a"]),
        "b_tokens_per_s_q1_median_q3": quartiles(got["b"]),
        "b_wins": sum(b > a for a, b in zip(got["a"], got["b"]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
