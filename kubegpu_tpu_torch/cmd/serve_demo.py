"""Serving demo binary: continuous-batching greedy decode over synthetic
requests, on one device.

The port's counterpart of ``kubegpu_tpu/cmd/serve_demo.py``: builds a
model from --seed, submits requests with mixed prompt lengths, drives the
slot-based `DecodeServer`, and prints one JSON line of stats. Runs on
CUDA unless --device says otherwise. Speculative decoding, sampling, the
prefix cache and checkpoints come with later slices and are refused.

Examples:
    python -m kubegpu_tpu_torch.cmd.serve_demo --requests 8 --slots 4
    python -m kubegpu_tpu_torch.cmd.serve_demo --device cpu --d-model 32
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256, help="model max_seq")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--spec-server", action="store_true")
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--lookahead", type=int, default=4)
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.prefix_cache < 0:
        ap.error("--prefix-cache must be >= 0")
    later = [flag for flag, on in (
        ("--speculative", args.speculative),
        ("--spec-server", args.spec_server),
        ("--prefix-cache", args.prefix_cache > 0),
        ("--checkpoint-dir", args.checkpoint_dir is not None),
        ("--temperature > 0", args.temperature > 0)) if on]
    if later:
        ap.error(f"{', '.join(later)}: not in this slice of the port "
                 "(sampling, speculation and the prefix cache come with "
                 "slice 4, checkpoints with slice 5)")

    import numpy as np
    import torch

    from kubegpu_tpu_torch import metrics
    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.workload.model import TransformerConfig, init_params
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    dev = resolve_device(args.device)
    cfg = TransformerConfig(vocab=args.vocab, d_model=args.d_model,
                            n_heads=args.n_heads, n_layers=args.n_layers,
                            d_ff=4 * args.d_model, max_seq=args.seq)
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg)
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab,
                                             int(rng.integers(4, 24)))]
               for _ in range(args.requests)]

    t0 = time.perf_counter()
    srv = DecodeServer(cfg, params, slots=args.slots,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p)
    rids = [srv.submit(p, max_new=args.max_new) for p in prompts]
    srv.run()
    outs = [srv.result(r) for r in rids]
    wall = time.perf_counter() - t0
    stats = {"mode": "serve", "slots": args.slots,
             "data_plane": "fused" if srv.fused else "hostloop",
             "chunk": srv.chunk,
             "tokens": sum(len(o) for o in outs),
             "device": str(dev) if dev.type == "cpu"
             else torch.cuda.get_device_name(dev)}
    if metrics.SERVE_TTFT_MS.n:
        stats["ttft_p50_ms"] = round(metrics.SERVE_TTFT_MS.percentile(0.5), 3)
        stats["itl_p50_ms"] = round(metrics.SERVE_ITL_MS.percentile(0.5), 3)
    stats.update({
        "requests": args.requests,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(stats["tokens"] / wall, 1),
        "first_output": outs[0][:8],
    })
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
