"""Training demo binary: stream batches from token shards and run the
train step, on one device or over a dp x sp x tp mesh.

The port's counterpart of ``kubegpu_tpu/cmd/train_demo.py``: builds a
model from --seed (or a --preset), generates synthetic shards when --data
is absent, runs --steps AdamW steps and prints one JSON line with the same
keys as the reference. Batches come from the native token loader, built
at first use. --generate decodes after training, greedily or sampled
(--temperature/--top-k/--top-p, keyed by --seed). --lora-rank trains
rank-r adapters over a frozen base; --checkpoint-dir saves the train state
every --checkpoint-every steps and resumes from its newest readable step.
Runs on CUDA unless --device says otherwise.

Under torchrun every rank joins one process group (NCCL on CUDA, gloo on
the CPU) and trains its shards of a (data, seq, model) mesh: --dp, --sp
and --tp together, their product the world size, or the world size
factored when they are absent. Every rank reads the same loader stream
and keeps its rows of each batch; rank 0 prints the JSON line.
--checkpoint-dir saves and resumes sharded there (the file holds the
global state, `workload/checkpoint.py`), the adapters by `lora_pspecs` in
LoRA mode. --generate decodes the global prompt rows through the sharded
`make_generate` on every rank and rank 0 prints row 0. The reference
refuses --generate in a multi-process run, because a cross-process JAX
array cannot be sliced outside jit; that limit does not bind here, so
every rank decodes as the reference's single-process mesh does.

Examples:
    python -m kubegpu_tpu_torch.cmd.train_demo --steps 4 --d-model 128
    python -m kubegpu_tpu_torch.cmd.train_demo --device cpu --d-model 32
    torchrun --nproc-per-node 4 -m kubegpu_tpu_torch.cmd.train_demo \
        --dp 2 --sp 2 --tp 1 --device cpu --d-model 32
    torchrun --nproc-per-node 4 -m kubegpu_tpu_torch.cmd.train_demo \
        --dp 2 --sp 1 --tp 2 --device cpu --d-model 32 \
        --checkpoint-dir /tmp/ckpt --generate 4
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import tempfile
import time


def main(argv=None) -> int:
    from kubegpu_tpu_torch.workload.presets import preset_names

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", nargs="*", default=None,
                    help="token shard paths (default: generate synthetic)")
    ap.add_argument("--preset", default=None, choices=preset_names(),
                    help="model family (workload/presets.py); size flags "
                         "below override its dimensions")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    # size flags default to None so only explicit values override a
    # preset's dimensions
    ap.add_argument("--seq", type=int, default=None, help="default 128")
    ap.add_argument("--vocab", type=int, default=None, help="default 512")
    ap.add_argument("--d-model", type=int, default=None,
                    help="default 128 (d_ff follows at 4x)")
    ap.add_argument("--d-ff", type=int, default=None,
                    help="the FFN width, when not 4x d_model")
    ap.add_argument("--n-layers", type=int, default=None, help="default 2")
    ap.add_argument("--n-heads", type=int, default=None, help="default 4")
    ap.add_argument("--dp", type=int, default=None,
                    help="mesh data-parallel extent (with --sp/--tp; "
                         "default: factor the torchrun world)")
    ap.add_argument("--sp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="train rank-r LoRA adapters instead of the "
                         "full model (0 = full fine-tune)")
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="compute dtype; float32 makes a sharded run's "
                         "losses comparable to one device's")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the train state here and resume from the "
                         "newest readable step on start")
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, decode N tokens from a prompt "
                         "drawn from the data stream")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); >0 samples")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k highest-logit tokens")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (0, 1]")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.checkpoint_every < 1:
        ap.error("--checkpoint-every must be >= 1")
    if args.lora_rank > 0 and args.accum_steps != 1:
        ap.error("--accum-steps is not supported with --lora-rank")
    flags = (args.dp, args.sp, args.tp)
    if any(flags) and not all(flags):
        ap.error("--dp/--sp/--tp must be given together")

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.data import make_loader, write_token_shard
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  param_leaves)

    explicit = {"remat": args.remat, "dtype": args.dtype}
    if args.vocab is not None:
        explicit["vocab"] = args.vocab
    if args.d_model is not None:
        explicit["d_model"] = args.d_model
        explicit["d_ff"] = 4 * args.d_model
    if args.d_ff is not None:
        explicit["d_ff"] = args.d_ff
    if args.n_layers is not None:
        explicit["n_layers"] = args.n_layers
    if args.n_heads is not None:
        explicit["n_heads"] = args.n_heads
    if args.seq is not None:
        explicit["max_seq"] = args.seq
    if args.preset:
        from kubegpu_tpu_torch.workload.presets import make_config

        cfg = make_config(args.preset, **explicit)
    else:
        cfg = TransformerConfig(**{
            **dict(vocab=512, d_model=128, n_heads=4, n_layers=2,
                   d_ff=512, max_seq=128),
            **explicit})
    seq_len = args.seq if args.seq is not None else cfg.max_seq
    prompt_len = min(16, seq_len)
    if args.generate > 0 and prompt_len + args.generate > cfg.max_seq:
        ap.error(f"--generate {args.generate} + prompt {prompt_len} "
                 f"exceeds the model's max_seq {cfg.max_seq}")

    dev = resolve_device(args.device)
    # torchrun's ranks join one process group first (no-op without it)
    multiproc = spmd.distributed_init_from_env(device=dev)
    mesh = None
    if all(flags):
        if not dist.is_initialized():
            ap.error("--dp/--sp/--tp need a process group: run under "
                     "torchrun --nproc-per-node N")
        want = args.dp * args.sp * args.tp
        if want != dist.get_world_size():
            ap.error(f"--dp*--sp*--tp = {want} but the process group has "
                     f"{dist.get_world_size()} ranks")
        mesh = spmd.make_mesh(want, dp=args.dp, sp=args.sp, tp=args.tp,
                              device=dev)
    elif multiproc:
        mesh = spmd.mesh_from_env(device=dev)
    if mesh is not None:
        dev = spmd.mesh_device(mesh)

    gen = None
    if args.generate > 0:
        from kubegpu_tpu_torch.workload.decode import make_generate

        gen = make_generate(cfg, mesh, temperature=args.temperature,
                            top_k=args.top_k, top_p=args.top_p)

    tmp = None
    paths = args.data
    if not paths:
        tmp = tempfile.mkdtemp(prefix="kgtpu-tokens-")
        rng = np.random.default_rng(args.seed)
        paths = [write_token_shard(
            os.path.join(tmp, f"shard{i}.kgtd"),
            rng.integers(0, cfg.vocab, size=50_000, dtype=np.uint32))
            for i in range(2)]
    try:
        lora = None
        if args.lora_rank > 0:
            # adapters train over a frozen base reproducible from --seed
            # (the step turns its gradients off); the optimizer state is
            # adapter-sized from the start
            from kubegpu_tpu_torch.workload.lora import (init_lora,
                                                         lora_pspecs,
                                                         make_lora_train_step)

            params, _, optimizer = init_sharded(
                torch.Generator(device=dev).manual_seed(args.seed), cfg,
                init_optimizer=False)
            lora = init_lora(
                torch.Generator(device=dev).manual_seed(args.seed + 1),
                params, rank=args.lora_rank)
            if mesh is not None:
                # every rank drew the whole trees alike; keep its shards
                params = spmd.shard_params(params, cfg, mesh)
                lora = spmd.shard_tree(lora, lora_pspecs(cfg), mesh)
            opt_state = optimizer(param_leaves(lora))
            lora_step = make_lora_train_step(cfg, mesh, args.lora_rank,
                                             optimizer)
            specs = lora_pspecs(cfg)
        else:
            params, opt_state, optimizer = init_sharded(
                torch.Generator(device=dev).manual_seed(args.seed), cfg,
                mesh)
            step = make_train_step(cfg, mesh, optimizer=optimizer,
                                   accum_steps=args.accum_steps)
            specs = spmd.param_pspecs(cfg)

        # resume from the newest readable step; in LoRA mode the
        # checkpoint holds the adapters (the base comes from --seed). Over
        # a mesh the file holds the global state and each rank its shards
        trained = lora if lora is not None else params
        start_step = 0
        if args.checkpoint_dir:
            from kubegpu_tpu_torch.workload.checkpoint import (
                adamw_state, adamw_template, load_train_state,
                restore_checkpoint, save_checkpoint, train_state_specs)

            state_specs = train_state_specs(specs)
            state, at = restore_checkpoint(
                args.checkpoint_dir,
                {"params": trained, "opt_state": adamw_template(trained)},
                mesh=mesh, specs=state_specs)
            if state is not None:
                load_train_state(opt_state, trained, state)
                start_step = at

        loader = make_loader(paths, args.batch, seq_len, seed=args.seed)
        losses = []
        t0 = time.perf_counter()
        try:
            # the stream is deterministic from --seed: skip the batches
            # the checkpointed steps consumed
            for _ in range(start_step):
                next(loader)
            for i in range(start_step, start_step + args.steps):
                # over a mesh the step takes the global batch and keeps
                # this rank's rows of it (spmd.global_batch)
                tokens = next(loader)
                if mesh is None:
                    tokens = torch.from_numpy(tokens).to(dev)
                if lora is not None:
                    lora, opt_state, loss = lora_step(lora, opt_state,
                                                      params, tokens)
                else:
                    params, opt_state, loss = step(params, opt_state,
                                                   tokens)
                losses.append(float(loss))       # waits for the step
                if args.checkpoint_dir and \
                        (i + 1) % args.checkpoint_every == 0:
                    save_checkpoint(
                        args.checkpoint_dir,
                        {"params": trained,
                         "opt_state": adamw_state(opt_state, trained)},
                        step=i + 1, mesh=mesh, specs=state_specs)
        finally:
            loader.close()
        wall = time.perf_counter() - t0
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)

    out = {
        "loader": type(loader).__name__,
        "devices": 1 if mesh is None else dist.get_world_size(),
        "resumed_from_step": start_step,
        "steps": args.steps,
        "first_loss": round(losses[0], 4),
        "last_loss": round(losses[-1], 4),
        "losses_full": losses,
        "tokens_per_s": round(args.steps * args.batch * seq_len / wall, 1),
        "device": str(dev) if dev.type == "cpu"
        else torch.cuda.get_device_name(dev),
    }
    if gen is not None:
        if lora is not None:
            from kubegpu_tpu_torch.workload.lora import merge_lora

            # the step's alpha / rank is 1
            with torch.no_grad():
                params = merge_lora(params, lora, 1.0, mesh)
        # over a mesh: the global prompt rows, decoded on every rank
        toks = gen(params, tokens[:, :prompt_len], args.generate,
                   rng=args.seed)
        out["generated"] = toks[0].tolist()
    if mesh is None or dist.get_rank() == 0:
        print(json.dumps(out))
    if multiproc:
        dist.destroy_process_group()
    return 0 if all(math.isfinite(x) for x in losses) else 1


if __name__ == "__main__":
    raise SystemExit(main())
