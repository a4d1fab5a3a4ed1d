"""Training demo binary: stream batches from token shards and run the
single-device train step, on one device.

The port's counterpart of ``kubegpu_tpu/cmd/train_demo.py``: builds a
model from --seed (or a --preset), generates synthetic shards when --data
is absent, runs --steps AdamW steps and prints one JSON line with the same
keys as the reference. Runs on CUDA unless --device says otherwise.
Sampled generation comes with slice 4, LoRA and checkpoints with slice 5,
meshes with slice 6; their flags are refused.

Examples:
    python -m kubegpu_tpu_torch.cmd.train_demo --steps 4 --d-model 128
    python -m kubegpu_tpu_torch.cmd.train_demo --device cpu --d-model 32
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
    ap.add_argument("--n-layers", type=int, default=None, help="default 2")
    ap.add_argument("--n-heads", type=int, default=None, help="default 4")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--sp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--lora-rank", type=int, default=0)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, decode N tokens greedily from a "
                         "prompt drawn from the data stream")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.temperature != 0.0 or args.top_k or args.top_p != 1.0:
        ap.error("--temperature/--top-k/--top-p: sampled generation comes "
                 "with slice 4 of the port; --generate decodes greedily")
    if args.lora_rank > 0 or args.checkpoint_dir is not None:
        ap.error("--lora-rank/--checkpoint-dir: LoRA and checkpoints come "
                 "with slice 5 of the port")
    if args.dp or args.sp or args.tp:
        ap.error("--dp/--sp/--tp: meshes come with slice 6 of the port")
    if args.remat == "dots":
        ap.error("--remat dots comes with slice 3 of the port; use none or "
                 "full")

    import numpy as np
    import torch

    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.workload.data import make_loader, write_token_shard
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    dev = resolve_device(args.device)
    explicit = {"remat": args.remat}
    if args.vocab is not None:
        explicit["vocab"] = args.vocab
    if args.d_model is not None:
        explicit["d_model"] = args.d_model
        explicit["d_ff"] = 4 * args.d_model
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
    gen = None
    if args.generate > 0:
        if prompt_len + args.generate > cfg.max_seq:
            ap.error(f"--generate {args.generate} + prompt {prompt_len} "
                     f"exceeds the model's max_seq {cfg.max_seq}")
        from kubegpu_tpu_torch.workload.decode import make_generate

        gen = make_generate(cfg)

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
        params, opt_state, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(args.seed), cfg)
        step = make_train_step(cfg, optimizer=optimizer,
                               accum_steps=args.accum_steps)
        loader = make_loader(paths, args.batch, seq_len, seed=args.seed)
        losses = []
        t0 = time.perf_counter()
        try:
            for _ in range(args.steps):
                tokens = torch.from_numpy(next(loader)).to(dev)
                params, opt_state, loss = step(params, opt_state, tokens)
                losses.append(float(loss))       # waits for the step
        finally:
            loader.close()
        wall = time.perf_counter() - t0
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)

    out = {
        "loader": type(loader).__name__,
        "devices": 1,
        "resumed_from_step": 0,
        "steps": args.steps,
        "first_loss": round(losses[0], 4),
        "last_loss": round(losses[-1], 4),
        "losses_full": losses,
        "tokens_per_s": round(args.steps * args.batch * seq_len / wall, 1),
        "device": str(dev) if dev.type == "cpu"
        else torch.cuda.get_device_name(dev),
    }
    if gen is not None:
        toks = gen(params, tokens[:, :prompt_len], args.generate)
        out["generated"] = toks[0].tolist()
    print(json.dumps(out))
    return 0 if all(math.isfinite(x) for x in losses) else 1


if __name__ == "__main__":
    raise SystemExit(main())
