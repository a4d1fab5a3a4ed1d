"""Serving demo binary: continuous-batching decode over synthetic
requests, on one device or as a gang over several.

The port's counterpart of ``kubegpu_tpu/cmd/serve_demo.py``: builds a
model from --seed (or restores its params from a train_demo
--checkpoint-dir), submits requests with mixed prompt lengths, drives the
slot-based `DecodeServer`, and prints one JSON line of stats with the
reference's keys. With --speculative the requests run one at a time
through speculative decoding with a smaller draft model built from
--seed + 1; with --spec-server the server itself decodes speculatively.
--temperature samples (truncated by --top-k/--top-p); --prefix-cache N
keeps the K/V of served prompts. Runs on CUDA unless --device says
otherwise.

Serving is a gang workload like training: under torchrun every rank
joins one process group (NCCL on CUDA, gloo on the CPU) and serves over a
(1, 1, world) mesh, the heads and the FFN split over ``model``. Every
rank builds the params (and the draft) from --seed and keeps its shards,
or restores its shards from --checkpoint-dir, all ranks agreeing that
they read it; every rank drives the same host loop on the same requests,
and rank 0 prints the JSON line, with ``"processes"``.

Examples:
    python -m kubegpu_tpu_torch.cmd.serve_demo --requests 8 --slots 4
    python -m kubegpu_tpu_torch.cmd.serve_demo --temperature 0.8 --top-p 0.9
    python -m kubegpu_tpu_torch.cmd.serve_demo --speculative --draft-layers 1
    python -m kubegpu_tpu_torch.cmd.serve_demo --device cpu --d-model 32
    torchrun --nproc-per-node 2 -m kubegpu_tpu_torch.cmd.serve_demo \
        --device cpu --d-model 32 --spec-server
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
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="compute dtype; float32 makes a gang's streams "
                         "equal to one device's")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="restore params saved by train_demo (full "
                         "fine-tune checkpoints only)")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding with a draft model "
                         "(greedy, or sampled when --temperature is set)")
    ap.add_argument("--spec-server", action="store_true",
                    help="speculative mode inside the continuous-batching "
                         "server: per-slot draft proposals, one batched "
                         "verify")
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--lookahead", type=int, default=4,
                    help="draft tokens per speculative round (k)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="retain K/V of the last N served prompts; "
                         "requests extending one prefill only the "
                         "remainder")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.prefix_cache < 0:
        ap.error("--prefix-cache must be >= 0")
    if args.prefix_cache and args.speculative:
        ap.error("--prefix-cache applies to the server modes only "
                 "(plain or --spec-server); --speculative is the "
                 "single-stream path with no admission cache")

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubegpu_tpu_torch import metrics
    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.model import TransformerConfig, init_params
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    dev = resolve_device(args.device)
    # a gang's ranks join one process group (no-op single-process) and
    # serve over a model-parallel mesh; the batch stays whole on every
    # rank (dp = 1), as the reference's serve_demo keeps it
    multiproc = spmd.distributed_init_from_env(device=dev)
    world = dist.get_world_size() if multiproc else 1
    mesh = spmd.make_mesh(world, dp=1, sp=1, tp=world, device=dev) \
        if world > 1 else None
    if mesh is not None:
        dev = spmd.mesh_device(mesh)

    def build(tree_cfg, seed):
        """The params from ``seed``, as this rank's shards over a mesh."""
        tree = init_params(torch.Generator(device=dev).manual_seed(seed),
                           tree_cfg)
        return tree if mesh is None else \
            spmd.shard_params(tree, tree_cfg, mesh)

    cfg = TransformerConfig(vocab=args.vocab, d_model=args.d_model,
                            n_heads=args.n_heads, n_layers=args.n_layers,
                            d_ff=4 * args.d_model, max_seq=args.seq,
                            dtype=args.dtype)
    params = build(cfg, args.seed)
    restored_step = None
    if args.checkpoint_dir:
        from kubegpu_tpu_torch.workload.checkpoint import (
            adamw_template, restore_checkpoint, train_state_specs, tree_map)

        # train_demo saves {params, opt_state}: the template matches it
        # leaf for leaf, with the AdamW moments as shapes only. In a gang
        # every rank must read it: the ranks agree before any returns
        state, at = restore_checkpoint(
            args.checkpoint_dir,
            {"params": params, "opt_state": adamw_template(params)},
            mesh=mesh, specs=train_state_specs(spmd.param_pspecs(cfg)))
        if state is None:
            ap.error(f"no readable checkpoint in {args.checkpoint_dir} "
                     "(serve_demo restores full fine-tune checkpoints "
                     "saved by train_demo; in a gang, every rank needs "
                     "the checkpoint readable)")
        params = tree_map(lambda x: x.to(dev), state["params"])
        restored_step = at
        del state                    # drop the restored AdamW moments
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab,
                                             int(rng.integers(4, 24)))]
               for _ in range(args.requests)]

    draft_cfg = draft = None
    if args.speculative or args.spec_server:
        draft_cfg = TransformerConfig(
            vocab=args.vocab, d_model=max(32, args.d_model // 4),
            n_heads=args.n_heads, n_layers=args.draft_layers,
            d_ff=args.d_model, max_seq=args.seq, dtype=args.dtype)
        draft = build(draft_cfg, args.seed + 1)

    t0 = time.perf_counter()
    if args.speculative:
        from kubegpu_tpu_torch.workload.speculative import \
            make_speculative_generate

        gen = make_speculative_generate(cfg, draft_cfg, k=args.lookahead,
                                        mesh=mesh,
                                        temperature=args.temperature,
                                        top_k=args.top_k, top_p=args.top_p)
        outs, calls = [], 0
        for i, p in enumerate(prompts):
            out, c = gen(params, draft, p, args.max_new,
                         rng=args.seed + 100 + i)
            outs.append(out)
            calls += c
        stats = {"mode": "speculative", "target_calls": calls,
                 "tokens": sum(len(o) for o in outs)}
    else:
        srv = DecodeServer(cfg, params, slots=args.slots, mesh=mesh,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, rng=args.seed,
                           draft_params=draft, draft_cfg=draft_cfg,
                           lookahead=args.lookahead,
                           prefix_cache_size=args.prefix_cache)
        rids = [srv.submit(p, max_new=args.max_new) for p in prompts]
        srv.run()
        outs = [srv.result(r) for r in rids]
        stats = {"mode": "spec-serve" if args.spec_server else "serve",
                 "slots": args.slots,
                 # which data plane served: the fused chunk (default) or
                 # the per-token oracle (KGTPU_FUSED_SERVE=0)
                 "data_plane": "fused" if srv.fused else "hostloop",
                 "chunk": srv.chunk,
                 "tokens": sum(len(o) for o in outs)}
        if args.prefix_cache:
            stats["prefix_hits"] = srv.prefix_hits
            stats["prefix_misses"] = srv.prefix_misses
        if metrics.SERVE_TTFT_MS.n:
            # from submit() to the end of the step() that returned the
            # first token: what a caller waits for it
            stats["ttft_p50_ms"] = round(
                metrics.SERVE_TTFT_MS.percentile(0.5), 3)
            stats["itl_p50_ms"] = round(
                metrics.SERVE_ITL_MS.percentile(0.5), 3)
    wall = time.perf_counter() - t0
    if restored_step is not None:
        stats["restored_step"] = restored_step
    if multiproc:
        stats["processes"] = world
    stats["device"] = str(dev) if dev.type == "cpu" \
        else torch.cuda.get_device_name(dev)
    stats.update({
        "requests": args.requests,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(stats["tokens"] / wall, 1),
        "first_output": outs[0][:8],
    })
    # one JSON line a job: every rank served the same requests
    if not multiproc or dist.get_rank() == 0:
        print(json.dumps(stats))
    if multiproc:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
