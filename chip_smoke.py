#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kubegpu_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kubegpu_tpu_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives the port's two main paths: serving at the width of the
repository's serving benchmark (vocab 8192, d_model 2048, 16 heads, 6
layers, d_ff 8192, max_seq 1024) and training at the width of its
headline training configuration (``bench.py``'s first ``tpu`` candidate:
vocab 8192, d_model 2304, 18 heads, 6 layers, d_ff 12288, batch 4,
T = 2048, no remat), random weights from a seed:

1. device: the card's name and power limit (nvidia-smi);
2. build: the nvcc build and its seconds;
3. kernel: the flash-attention forward against ``flash_attention_plain``
   at the shape of every path that launches it (serving, training, MoE
   training, the entry) and at masking edge cases (one tile; several
   stages over a ragged T = 2085), each row naming the kernel instance
   that ran, with its time (and through the ``torch.ops.kgt.flash_fwd``
   operator the model calls), the previous (mma.sync) design's time at the
   same shape, the plain version's, ``scaled_dot_product_attention``'s (a
   yardstick the port never calls) and the least time the card could
   take;
4. forward: the full-width forward pass on tokens [4, 1024] through the
   kernel (one launch per layer), against the same forward with the plain
   attention;
5. entry: the port's ``entry()`` forward on the card;
6. serve: the continuous-batching server on the benchmark's traffic (4
   slots, 8 prompts of 16..512 tokens, 64 new tokens each, greedy); the
   fused data plane's streams against the per-token oracle's;
7. kernel_bwd: the flash backward (K2 dQ with the row term delta, K3
   dK/dV) through the autograd Function against
   ``flash_attention_bwd_plain`` at the training and MoE training shapes
   and at masking edge cases (the same new ones as the forward's), each
   row naming K2's and K3's instances and holding the delta K2 hands K3
   against ``_delta``; with K2's, K3's and K1's times there, their previous
   designs' (K2's with the ``_delta`` pre-pass it needs), the pre-pass's
   alone, their plain versions', ``scaled_dot_product_attention``'s
   backward (a yardstick the port never calls; it includes its own
   pre-pass, so it stands against K2 + K3) and the bounds;
8. train: per-leaf gradient errors of the bf16 kernel path and the bf16
   plain-attention path against a float32 plain-attention reference on
   one batch, then 5 AdamW steps of ``make_train_step`` (step ms,
   tokens/s, MFU, losses, kernel launches per step, calls of the
   ``_delta`` pre-pass, which the sm90 K2 leaves none of), then
   ``remat="full"`` against ``remat="none"`` on one batch (loss and
   per-leaf gradients) and one step with ``remat="full"``; the batches
   come from the native token loader (``make_loader``);
9. train_remat_dots: ``remat="dots"`` against ``remat="none"`` on one
   batch at the training config (loss and per-leaf gradients, and the
   flash launches of the dots pass: one K1, K2 and K3 a layer, all sm90,
   so the recompute never reruns K1), then AdamW steps of each of none,
   dots and full with their median time and peak memory;
10. loader: the native token loader's first 8 batches against
   ``PyTokenLoader``'s, bit for bit;
11. serve_sampled: the server on the serve phase's traffic, sampling
   (temperature 0.8, top_k 50, top_p 0.95): the fused streams against the
   per-token oracle's, against another chunk size and against the reverse
   admission order, and the key hash's bits on the card against the CPU's;
12. serve_spec: the speculative server on the same traffic with a 1-layer
   draft (d_model 512, d_ff 2048, lookahead 4, 4 rounds a dispatch): in
   float32 its greedy streams against the plain server's and a self-draft
   (draft = target) sampled run whose acceptance must be 1.0; in bf16 its
   tokens/s and acceptance, sampled;
13. serve_prefix: 8 requests sharing a 128-token system prompt with tails
   of 16..256 tokens, greedy in float32, with ``prefix_cache_size`` 8
   against no cache: equal streams and 7 prefix hits;
14. train_lora: LoRA fine-tuning at the training config (rank 16 on wq and
   wv, ``make_lora_train_step``, batches from the native loader), 5 steps:
   falling finite losses, 6 K1, K2 and K3 sm90 launches a step, every base
   leaf without a gradient and with its bits unchanged, step ms and peak
   memory beside the train phase's (remat none);
15. checkpoint: the LoRA state saved after 2 of 4 steps and resumed (the
   resumed losses equal the uninterrupted run's, bit for bit), and the
   training config's full ``{params, opt_state}`` (8.1 GB) saved and
   restored as serve_demo restores it (params only, the AdamW moments as
   shapes), with the seconds of each: the leaves' bits and the greedy
   streams served from the restored params equal the in-memory ones;
16. moe: the ``moe`` preset's routing (4 experts, top-2) at the serving
   width: a forward at [4, 1024] (6 K1 launches), 3 AdamW steps at B 4,
   T = 2048 (6 K1, K2 and K3 sm90 launches each, falling finite losses, the
   aux term at least 1 a layer, step ms and peak memory), and a float32
   greedy drain whose fused streams equal the per-token oracle's;
17. ring_kernels: K1, K2 and K3 as ring attention runs them, at the
   training shape (B 4, T 2048, 18 heads, head_dim 128, bf16, causal) with
   sp = 4 and sp = 2 through the in-process seq axis
   (``ring.InProcessSeqAxis``): every (q_offset, kv_offset) pair the ring
   gives, with a random lse cotangent, against the plain versions (the
   blocks of the future give O = 0, lse <= -1e20 and zero gradients);
   then the merged ring (sp^2 sm90 launches of each kernel a pass) and its
   q/k/v gradients against a float32 plain reference of the whole
   sequence: the output within 1.25x (mean) and 2x (max) of the
   single-shard kernels' error, the gradients within the same ratios of
   the same ring run through the plain versions; its forward + backward
   ms beside the single-shard kernels';
18. train_mesh: a world-size-1 NCCL process group (a ``file://`` store
   in a temporary directory), ``dryrun_multichip`` over the card, then the
   sharded train step at the training config (dp = sp = tp = 1): its loss
   and per-leaf gradients on one batch against the single-device step's
   (the remat tolerances), 6 K1, K2 and K3 sm90 launches, and 5 AdamW
   steps from the native loader, median step ms beside the train phase's;
19. serve_mesh: in the same group, the serving config in float32 over the
   (1, 1, 1) mesh: the sharded ``make_generate`` on 4 rows of the serve
   phase's prompts, the sharded server on its traffic and the sharded
   speculative server (the serve_spec phase's draft, sharded over the same
   mesh), each equal to the same call without a mesh; bf16 tokens/s of the
   mesh server and the plain one, beside the serve phase's. Then
   the sharded resume at the training config: 2 steps of the sharded train
   step, ``save_checkpoint(..., mesh)``, 2 more; freshly initialised shards
   restored with ``restore_checkpoint(..., mesh)`` take the same 2 steps,
   their losses equal to the uninterrupted run's bit for bit, with 6 K1,
   K2 and K3 sm90 launches a step; the save and restore seconds beside the
   checkpoint phase's. Last, ``dryrun_multichip`` over the card, with its
   serving leg.

The ``kernels`` line names each kernel's instance on the main path and
the launches that went to each instance (``launches_serve_mesh_step``:
the last resumed sharded step's). Every phase prints one JSON line
and raises on failure. The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

# (B, T, H, D) and traffic of the serving benchmark's chip sizing
MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=6, d_ff=8192,
             max_seq=1024)
SLICE_SHAPE = (4, 1024, 16, 128)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_MAX_NEW = 4, 8, 64
FORWARD_TOKENS = (4, 1024)
# the training path: bench.py's headline training config (tpu ladder, first
# candidate), batch 4 at T = 2048, no remat
TRAIN_MODEL = dict(vocab=8192, d_model=2304, n_heads=18, n_layers=6,
                   d_ff=12288, max_seq=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 18, 128)

# H100 SXM published peaks (dense): bf16 tensor cores, float32 FMA, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances. float32: the kernel and the plain version differ only in
# summation order. bf16: both round O to bf16 (one ulp is 1.6e-2 for
# |O| in [2, 4); |O| <= max |v|) after rounding P to bf16 at different
# points (the kernel against its running max, the plain version against
# the row max); lse stays float32 in both.
TOL_F32 = 1e-4
TOL_BF16_O = 2e-2
TOL_BF16_LSE = 1e-3
# Full forward (logits of unit scale): in bf16 the kernel's path may be
# at most 1.25x (mean) and 2x (max) as far from the float32 forward as the
# plain attention's bf16 path is; in float32 the two paths differ only in
# summation order, amplified through 6 random layers, so 1e-3.
TOL_FWD_MEAN_RATIO = 1.25
TOL_FWD_MAX_RATIO = 2.0
TOL_FWD_F32 = 1e-3
# Backward kernels against the plain backward, per output (dq, dk, dv):
# max |delta| over max |ref|. bf16: both versions round P and dS to bf16
# after float32 sums taken in another order, and round the output to
# bf16; float32: summation order only.
TOL_BWD_BF16 = 1e-2
TOL_BWD_F32 = 1e-4
# The delta K2 emits against `_delta` on the same (o, dO, dlse): both sum
# float32 products of the same bf16 or float32 values, in another order,
# so within 1e-4 of the largest |delta|.
TOL_DELTA = 1e-4
# Training gradients: the bf16 kernel path's per-leaf relative L2 error
# against the float32 plain-attention gradients may be at most 1.25x the
# bf16 plain path's, in the median over leaves and for the worst leaf.
# Remat "full" replays the same forward in the backward: on the same params
# and batch its loss within 1e-3 (relative) of remat "none"'s, and every
# leaf's gradient within 1e-2 relative L2 of remat "none"'s, under half
# the bf16 path's own error against float32 (median 0.025); a recompute
# that breaks errs by order 1.
TOL_GRAD_RATIO = 1.25
TOL_REMAT_LOSS = 1e-3
TOL_REMAT_GRAD = 1e-2
# Remat "dots" replays the same operations with the kept outputs returned
# as they were, so the same tolerances hold for it.
# The serving phases of this slice: sampling settings, the draft model,
# and the prefix traffic (a 128-token system prompt, tails of 16..256).
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
DRAFT_MODEL = dict(MODEL, d_model=512, d_ff=2048, n_layers=1)
SPEC_LOOKAHEAD, SPEC_ROUNDS = 4, 4
PREFIX_SYSTEM, PREFIX_TAILS, PREFIX_CACHE = 128, (16, 256), 8
LOADER_BATCHES = 8
REMAT_STEPS = 3
# LoRA: rank 16 on the default targets (wq, wv), alpha = rank. The
# optimizer is AdamW at lr 1e-2, the rate of the reference's own LoRA test
# (tests/test_lora.py): at the full-tuning rate of 3e-4 five steps move a
# zero-initialised B too little to lower the loss beyond batch-to-batch
# noise.
LORA_RANK, LORA_STEPS, LORA_LR = 16, 5, 1e-2
# checkpoint: the LoRA run saves after CKPT_SAVE_AT of CKPT_STEPS steps; the
# full train state's round trip is the training config's (675M parameters,
# an 8.1 GB file with the AdamW moments) after CKPT_FULL_STEPS steps
CKPT_SAVE_AT, CKPT_STEPS, CKPT_FULL_STEPS = 2, 4, 2
# moe: the moe preset's routing at the serving width
MOE_MODEL = dict(MODEL, n_experts=4, moe_top_k=2)
MOE_STEPS = 3
# (B, T, H, D) of the MoE steps: the kernel phases hold K1-K3 against their
# plain versions at the shape of every path that launches them (forward
# and serving: SLICE_SHAPE; training, LoRA, checkpoint: TRAIN_SHAPE; moe:
# SLICE_SHAPE and MOE_TRAIN_SHAPE; entry: ENTRY_SHAPE)
MOE_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, MOE_MODEL["n_heads"],
                   MOE_MODEL["d_model"] // MOE_MODEL["n_heads"])
ENTRY_SHAPE = (2, 128, 8, 32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, runs: int = 20, batch: int = 5, warmup: int = 3) -> float:
    """Median over ``runs`` of the mean CUDA-event time of ``batch``
    back-to-back calls of ``fn``, after warm-up. Back to back, the host
    enqueues the next call while the device runs this one, so the
    wrapper's host overhead stays out of the time unless it exceeds the
    device's."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    times.sort()
    return times[len(times) // 2]


def visible_pairs(tq, tk, q_offset, kv_offset, causal, window) -> int:
    """(q, k) pairs the mask lets through: the work the kernel must do."""
    from kubegpu_tpu_torch.workload.kernels.flash import _mask

    mask = _mask(tq, tk, q_offset, kv_offset, causal, window, "cpu")
    return tq * tk if mask is None else int(mask.sum())


def attention_bound_ms(b, tq, tk, h, d, dtype, pairs) -> tuple:
    """Least time for the forward on an H100 SXM: the larger of q, k, v,
    o and lse moved once over the memory rate and 4 * D operations per
    visible pair over the tensor-core (bf16) or FMA (float32) peak."""
    import torch

    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    flops = 4 * d * pairs * b * h
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def case_qkv(gen, dev, b, tq, tk, h, d, dt, strided=False):
    """Random q [B, Tq, H, D], k, v [B, Tk, H, D] of type ``dt``; strided:
    views of one packed [B, T, 3, H, D] tensor (Tq = Tk)."""
    import torch

    f32 = torch.float32
    if strided:
        qkv = torch.randn((b, tq, 3, h, d), generator=gen, device=dev,
                          dtype=f32).to(dt)
        return qkv.unbind(2)
    q = torch.randn((b, tq, h, d), generator=gen, device=dev,
                    dtype=f32).to(dt)
    k, v = (torch.randn((b, tk, h, d), generator=gen, device=dev,
                        dtype=f32).to(dt) for _ in range(2))
    return q, k, v


def kernel_phase(dev) -> dict:
    """K1 against its plain version at the shapes of the paths and edge
    cases; times at the serving shape."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        _instance, _launch, flash_attention_plain, flash_attention_with_lse)

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, (B, Tq, Tk, H, D), dtype, kwargs
        *((name, (b, t, t, h, d), bf16, {}) for name, (b, t, h, d) in (
            ("slice_causal", SLICE_SHAPE), ("train_causal", TRAIN_SHAPE),
            ("moe_train_causal", MOE_TRAIN_SHAPE),
            ("entry_causal", ENTRY_SHAPE))),
        ("single_tile", (1, 64, 64, 1, 128), bf16, {}),
        ("ragged_multistage", (1, 2085, 2085, 2, 128), bf16, {}),
        ("non_causal", (2, 256, 256, 4, 128), bf16, dict(causal=False)),
        ("window_64", (2, 512, 512, 4, 128), bf16, dict(window=64)),
        ("offsets_96_32", (1, 256, 256, 4, 64), bf16,
         dict(q_offset=96, kv_offset=32)),
        ("all_future", (1, 128, 128, 2, 64), bf16,
         dict(q_offset=0, kv_offset=1000)),
        ("ragged_200", (2, 200, 200, 4, 64), bf16, {}),
        ("ragged_q70_k300_noncausal", (1, 70, 300, 2, 128), bf16,
         dict(causal=False)),
        ("head_dim_32", (2, 256, 256, 4, 32), bf16, {}),
        ("strided_qkv", (2, 256, 256, 4, 64), bf16, dict(strided=True)),
        ("f32_causal_window", (2, 200, 200, 4, 64), f32, dict(window=48)),
        ("f32_offsets", (1, 130, 96, 2, 128), f32,
         dict(q_offset=40, kv_offset=0)),
        ("f32_non_causal_d32", (2, 64, 100, 2, 32), f32,
         dict(causal=False)),
    ]
    out = {}
    for name, (b, tq, tk, h, d), dt, kw in cases:
        kw = dict(kw)
        q, k, v = case_qkv(gen, dev, b, tq, tk, h, d, dt,
                           kw.pop("strided", False))
        scale = d ** -0.5
        before = _instance_counts()
        o, lse = flash_attention_with_lse(q, k, v, scale, **kw)
        torch.cuda.synchronize()
        instance = _ran(before)[0]
        o_ref, lse_ref = flash_attention_plain(q, k, v, scale, **kw)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        if name == "all_future":
            ok = err_o == 0.0 and o.abs().max().item() == 0.0 \
                and lse.max().item() <= -1e20
            err_l = 0.0
        else:
            err_l = (lse - lse_ref).abs().max().item()
            tol_o, tol_l = (TOL_F32, TOL_F32) if dt == f32 \
                else (TOL_BF16_O, TOL_BF16_LSE)
            ok = err_o <= tol_o and err_l <= tol_l \
                and bool(torch.isfinite(o).all())
        ok = ok and instance == _instance(dt, d)
        row = {"phase": "kernel", "case": name, "dtype": str(dt)[6:],
               "shape": [b, tq, tk, h, d], "instance": instance,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l, "ok": ok}
        if name == "slice_causal":
            pairs = visible_pairs(tq, tk, 0, 0, True, 0)
            bound, bound_by = attention_bound_ms(b, tq, tk, h, d, dt, pairs)
            # the kernel through its wrapper, as K2 and K3 are timed;
            # "op_ms" adds the operator layer (torch.ops.kgt.flash_fwd)
            # that the model calls
            row.update(
                ms=time_ms(lambda: _launch(q, k, v, scale, 0, 0, True, 0)),
                op_ms=time_ms(lambda: flash_attention_with_lse(q, k, v,
                                                               scale)),
                previous_ms=time_ms(lambda: _launch(
                    q, k, v, scale, 0, 0, True, 0, instance="mma")),
                plain_ms=time_ms(
                    lambda: flash_attention_plain(q, k, v, scale)),
                library_ms=time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True)),
                bound_ms=bound, bound_by=bound_by)
            out = dict(row)
        emit(row)
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version on {name}: {row}")
    return out


def forward_phase(dev, cfg, params) -> dict:
    """The full-width forward through the kernel, against plain attention.

    bf16 rounds differently on the two attention paths, so each is held
    against the float32 forward with plain attention: the kernel's path
    must come as close to it as the plain bf16 path does. The float32
    forward through the kernel's float32 instance must match the float32
    plain forward closely (summation order only)."""
    import dataclasses

    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import \
        flash_attention_with_lse
    from kubegpu_tpu_torch.workload.model import make_forward

    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, FORWARD_TOKENS, generator=gen,
                           device=dev)
    fwd = make_forward(cfg)                      # attn_impl "auto"
    with torch.no_grad():
        _zero_launch_counts()
        logits = fwd(params, tokens)
        torch.cuda.synchronize()
        launches = flash_attention_with_lse.launches
        by_instance = dict(flash_attention_with_lse.launches_by_instance)
        plain = make_forward(dataclasses.replace(cfg, attn_impl="xla"))
        ref = plain(params, tokens)
        f32 = dataclasses.replace(cfg, dtype="float32")
        truth = make_forward(dataclasses.replace(f32, attn_impl="xla"))(
            params, tokens)
        f32_flash = make_forward(dataclasses.replace(f32, attn_impl="flash"))(
            params, tokens)
        fwd_ms = time_ms(lambda: fwd(params, tokens), runs=5, batch=1,
                         warmup=1)
        plain_ms = time_ms(lambda: plain(params, tokens), runs=5, batch=1,
                           warmup=1)
    err_k = (logits - truth).abs()
    err_p = (ref - truth).abs()
    row = {"phase": "forward", "tokens": list(FORWARD_TOKENS),
           "kernel_launches": launches,
           "kernel_launches_by_instance": by_instance,
           "finite": bool(torch.isfinite(logits).all()),
           "bf16_kernel_vs_f32": [err_k.mean().item(), err_k.max().item()],
           "bf16_plain_vs_f32": [err_p.mean().item(), err_p.max().item()],
           "bf16_kernel_vs_plain_max": (logits - ref).abs().max().item(),
           "argmax_agreement": (logits.argmax(-1) == ref.argmax(-1))
           .float().mean().item(),
           "f32_kernel_vs_f32_plain_max":
               (f32_flash - truth).abs().max().item(),
           "forward_ms": fwd_ms, "forward_plain_attention_ms": plain_ms}
    row["ok"] = (
        launches == cfg.n_layers == by_instance["sm90"] and row["finite"]
        and tuple(logits.shape) == FORWARD_TOKENS + (cfg.vocab,)
        and row["bf16_kernel_vs_f32"][0]
        <= TOL_FWD_MEAN_RATIO * row["bf16_plain_vs_f32"][0]
        and row["bf16_kernel_vs_f32"][1]
        <= TOL_FWD_MAX_RATIO * row["bf16_plain_vs_f32"][1]
        and row["f32_kernel_vs_f32_plain_max"] <= TOL_FWD_F32)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"forward phase failed: {row}")
    return row


def entry_phase() -> None:
    """The port's ``entry()`` (the reference entry's config, tokens
    [2, 128]) on the card: one kernel launch per layer, finite logits."""
    import torch

    from kubegpu_tpu_torch.entry import entry
    from kubegpu_tpu_torch.workload.kernels.flash import \
        flash_attention_with_lse

    fwd, (params, tokens) = entry()
    before = flash_attention_with_lse.launches
    with torch.no_grad():
        logits = fwd(params, tokens)
    torch.cuda.synchronize()
    row = {"phase": "entry", "shape": list(logits.shape),
           "kernel_launches": flash_attention_with_lse.launches - before,
           "finite": bool(torch.isfinite(logits).all())}
    row["ok"] = row["finite"] and row["kernel_launches"] == 4 \
        and row["shape"] == [2, 128, 512]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"entry phase failed: {row}")


def _serve_prompts(cfg) -> list:
    """The serving traffic: 8 prompts of 16..max_seq/2 tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab, int(n)).tolist()
            for n in np.linspace(16, cfg.max_seq // 2, SERVE_REQUESTS)]


def _drain(cfg, params, prompts, fused=True, reverse=False, **kw) -> dict:
    """One drain of ``prompts`` (SERVE_MAX_NEW tokens each) through a
    fresh server on ``SERVE_SLOTS`` slots: the streams in submission
    order, the wall time, TTFT and ITL p50 and the server. ``reverse``
    admits the requests in the reverse of their submission order (each
    keeps its request id, so its keys)."""
    import torch

    from kubegpu_tpu_torch import metrics
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    os.environ["KGTPU_FUSED_SERVE"] = "1" if fused else "0"
    try:
        srv = DecodeServer(cfg, params, slots=SERVE_SLOTS, **kw)
    finally:
        os.environ.pop("KGTPU_FUSED_SERVE", None)
    assert srv.fused == fused
    metrics.reset_all()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    if reverse:
        srv._queue.reverse()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [srv.result(r) for r in rids]
    n_tok = sum(len(o) for o in outs)
    return {"outs": outs, "wall_s": wall, "tokens": n_tok,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": metrics.SERVE_TTFT_MS.percentile(0.5),
            "itl_p50_ms": metrics.SERVE_ITL_MS.percentile(0.5), "srv": srv}


def serve_phase(dev, cfg, params) -> dict:
    """DecodeServer on the benchmark's traffic; fused against oracle."""
    prompts = _serve_prompts(cfg)
    _drain(cfg, params, prompts)                 # warm-up pass
    fused = _drain(cfg, params, prompts)
    oracle = _drain(cfg, params, prompts, fused=False)
    row = {"phase": "serve", "slots": SERVE_SLOTS,
           "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
           "prompt_lens": [len(p) for p in prompts],
           "tokens": fused["tokens"], "wall_s": fused["wall_s"],
           "tokens_per_s": fused["tokens_per_s"],
           "ttft_p50_ms": fused["ttft_p50_ms"],
           "itl_p50_ms": fused["itl_p50_ms"],
           "oracle_tokens_per_s": oracle["tokens_per_s"],
           "all_full_length": all(len(o) == SERVE_MAX_NEW
                                  for o in fused["outs"]),
           "fused_equals_oracle": fused["outs"] == oracle["outs"],
           "first_output": fused["outs"][0][:8]}
    row["ok"] = row["all_full_length"] and row["fused_equals_oracle"]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve phase failed: {row}")
    return row


def serve_sampled_phase(dev, cfg, params) -> dict:
    """Sampled serving: fused against the oracle, another chunk size and
    the reverse admission order (position-keyed draws make all four
    equal), and the key hash on the card against the CPU."""
    import torch

    from kubegpu_tpu_torch.workload import keys

    prompts = _serve_prompts(cfg)
    kw = dict(SAMPLING, rng=7)
    _drain(cfg, params, prompts, **kw)           # warm-up pass
    fused = _drain(cfg, params, prompts, **kw)
    oracle = _drain(cfg, params, prompts, fused=False, **kw)
    chunk5 = _drain(cfg, params, prompts, chunk=5, **kw)
    # each request lands in another slot, next to other requests
    rev = _drain(cfg, params, prompts, reverse=True, **kw)
    seeds = torch.arange(4096, dtype=torch.int64) * 2654435761
    cpu_bits = keys.bits(keys.fold(seeds, 12345), 64)
    dev_bits = keys.bits(keys.fold(seeds.to(dev), 12345), 64).cpu()
    row = {"phase": "serve_sampled", **SAMPLING,
           "tokens": fused["tokens"], "wall_s": fused["wall_s"],
           "tokens_per_s": fused["tokens_per_s"],
           "ttft_p50_ms": fused["ttft_p50_ms"],
           "itl_p50_ms": fused["itl_p50_ms"],
           "oracle_tokens_per_s": oracle["tokens_per_s"],
           "all_full_length": all(len(o) == SERVE_MAX_NEW
                                  for o in fused["outs"]),
           "fused_equals_oracle": fused["outs"] == oracle["outs"],
           "chunk5_equals_chunk16": chunk5["outs"] == fused["outs"],
           "reverse_admission_equals": rev["outs"] == fused["outs"],
           "key_bits_cuda_equal_cpu": bool(torch.equal(cpu_bits, dev_bits)),
           "first_output": fused["outs"][0][:8]}
    row["ok"] = all(row[k] for k in (
        "all_full_length", "fused_equals_oracle", "chunk5_equals_chunk16",
        "reverse_admission_equals", "key_bits_cuda_equal_cpu"))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_sampled phase failed: {row}")
    return row


def serve_spec_phase(dev, cfg, params) -> dict:
    """The speculative server on the serving traffic with a 1-layer draft:
    in float32, greedy streams equal to the plain server's and a
    self-draft sampled acceptance of 1.0; in bf16, sampled tokens/s and
    acceptance."""
    import dataclasses

    import torch

    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)

    prompts = _serve_prompts(cfg)
    dcfg = TransformerConfig(**DRAFT_MODEL)
    draft = init_params(torch.Generator(device=dev).manual_seed(1), dcfg)
    spec = dict(lookahead=SPEC_LOOKAHEAD, spec_rounds=SPEC_ROUNDS)
    f32, df32 = (dataclasses.replace(c, dtype="float32") for c in (cfg, dcfg))
    plain = _drain(f32, params, prompts)
    greedy = _drain(f32, params, prompts, draft_params=draft,
                    draft_cfg=df32, **spec)
    self_draft = _drain(f32, params, prompts, draft_params=params,
                        draft_cfg=f32, rng=5, **spec, **SAMPLING)
    bf16 = dict(draft_params=draft, draft_cfg=dcfg, rng=5, **spec,
                **SAMPLING)
    _drain(cfg, params, prompts, **bf16)         # warm-up pass
    timed = _drain(cfg, params, prompts, **bf16)
    row = {"phase": "serve_spec", "draft": DRAFT_MODEL, **spec,
           **SAMPLING,
           "f32_greedy_equals_plain": greedy["outs"] == plain["outs"],
           "f32_plain_tokens_per_s": plain["tokens_per_s"],
           "f32_spec_greedy_tokens_per_s": greedy["tokens_per_s"],
           "f32_spec_greedy_acceptance": greedy["srv"].spec_acceptance,
           "f32_self_draft_acceptance": self_draft["srv"].spec_acceptance,
           "f32_self_draft_proposed": self_draft["srv"].spec_proposed,
           "bf16_sampled_tokens_per_s": timed["tokens_per_s"],
           "bf16_sampled_acceptance": timed["srv"].spec_acceptance,
           "bf16_ttft_p50_ms": timed["ttft_p50_ms"],
           "bf16_itl_p50_ms": timed["itl_p50_ms"],
           "all_full_length": all(
               len(o) == SERVE_MAX_NEW for r in (greedy, self_draft, timed)
               for o in r["outs"])}
    row["ok"] = (row["f32_greedy_equals_plain"]
                 and row["f32_self_draft_acceptance"] == 1.0
                 and row["f32_self_draft_proposed"] > 0
                 and row["all_full_length"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_spec phase failed: {row}")
    return row


def serve_prefix_phase(dev, cfg, params) -> dict:
    """Requests sharing a system prompt, greedy in float32, through the
    server with a prefix cache and without: equal streams, 7 hits."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(4)
    system = rng.integers(1, cfg.vocab, PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in np.linspace(*PREFIX_TAILS, SERVE_REQUESTS)]
    f32 = dataclasses.replace(cfg, dtype="float32")
    cold = _drain(f32, params, prompts)
    warm = _drain(f32, params, prompts, prefix_cache_size=PREFIX_CACHE)
    srv = warm["srv"]
    row = {"phase": "serve_prefix", "system_tokens": PREFIX_SYSTEM,
           "prompt_lens": [len(p) for p in prompts],
           "prefix_cache_size": PREFIX_CACHE,
           "prefix_hits": srv.prefix_hits,
           "prefix_misses": srv.prefix_misses,
           "streams_equal_uncached": warm["outs"] == cold["outs"],
           "tokens_per_s": warm["tokens_per_s"],
           "ttft_p50_ms": warm["ttft_p50_ms"],
           "uncached_tokens_per_s": cold["tokens_per_s"],
           "uncached_ttft_p50_ms": cold["ttft_p50_ms"]}
    row["ok"] = (row["streams_equal_uncached"]
                 and (srv.prefix_hits, srv.prefix_misses)
                 == (SERVE_REQUESTS - 1, 1))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_prefix phase failed: {row}")
    return row


def _token_shards(vocab: int, tmp: str) -> list:
    """Two shards of a seeded bigram chain in ``tmp``."""
    from kubegpu_tpu_torch.workload.data import write_token_shard

    return [write_token_shard(os.path.join(tmp, f"shard{i}.kgtd"),
                              bigram_tokens(vocab, 100_000, seed=i))
            for i in range(2)]


def loader_phase(cfg) -> dict:
    """The native loader (built at first use) against PyTokenLoader."""
    import shutil
    import tempfile

    import numpy as np

    from kubegpu_tpu_torch.workload.data import (NativeTokenLoader,
                                                 PyTokenLoader, make_loader)

    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-loader-")
    try:
        paths = _token_shards(cfg.vocab, tmp)
        t0 = time.perf_counter()
        native = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=11)
        build_s = time.perf_counter() - t0
        py = PyTokenLoader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=11)
        try:
            same = [np.array_equal(next(native), next(py))
                    for _ in range(LOADER_BATCHES)]
        finally:
            native.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "loader", "loader": type(native).__name__,
           "batches": LOADER_BATCHES, "batch_shape": [TRAIN_BATCH,
                                                      TRAIN_SEQ + 1],
           "first_use_seconds": build_s, "bit_identical": all(same)}
    row["ok"] = isinstance(native, NativeTokenLoader) and all(same)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"loader phase failed: {row}")
    return row


def backward_bound_ms(b, tq, tk, h, d, dtype, pairs, kernel) -> tuple:
    """Least time for K2 ("dq", with the row term delta it computes) or K3
    ("dkv") on an H100 SXM: the larger of their tensors moved once over
    the memory rate (K2: q, k, v, dO, O, dQ; K3: q, k, v, dO, dK, dV; both
    lse and delta in float32) and their operations (K2: 6 D a visible pair
    for S, dP, dQ on the tensor cores, and 2 D a row for delta in float32
    FMAs; K3: 8 D a pair for S, dP, dV, dK) over the peak of their type
    (the tensor cores for bf16 products, the FMA units for float32)."""
    import torch

    esize = torch.finfo(dtype).bits // 8
    rows = (4 * tq + 2 * tk) if kernel == "dq" else (2 * tq + 4 * tk)
    nbytes = esize * b * h * d * rows + 2 * 4 * b * h * tq
    flops = (6 if kernel == "dq" else 8) * d * pairs * b * h
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    if kernel == "dq":
        t_ops += 2 * d * tq * b * h / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _launch_counts() -> tuple:
    from kubegpu_tpu_torch.workload.kernels import flash

    return (flash.flash_attention_with_lse.launches,
            flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches)


def _zero_launch_counts() -> None:
    from kubegpu_tpu_torch.workload.kernels import flash

    for fn in (flash.flash_attention_with_lse, flash.flash_bwd_dq,
               flash.flash_bwd_dkv):
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(fn.launches_by_instance, 0)


def _instance_counts() -> tuple:
    """K1's, K2's and K3's launches per instance."""
    from kubegpu_tpu_torch.workload.kernels import flash

    return (dict(flash.flash_attention_with_lse.launches_by_instance),
            dict(flash.flash_bwd_dq.launches_by_instance),
            dict(flash.flash_bwd_dkv.launches_by_instance))


def _ran(before) -> tuple:
    """The instance of K1, K2 and K3 launched since ``before`` (an
    `_instance_counts` reading), None where it did not launch, a list where
    several did."""
    out = []
    for was, now in zip(before, _instance_counts()):
        hit = [k for k in now if now[k] > was[k]]
        out.append(hit[0] if len(hit) == 1 else (hit or None))
    return tuple(out)


def kernel_bwd_phase(dev) -> dict:
    """K2 and K3 through the autograd Function against the plain backward,
    at the training and MoE training shapes and edge cases, and the delta
    K2 gives K3 against
    `_delta`; times at the training shape."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        _delta, _dkv_plain, _dq_plain, _instance, _launch, _p_ds,
        flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq)

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        *((name, (b, t, t, h, d), bf16, {}) for name, (b, t, h, d) in (
            ("train_causal", TRAIN_SHAPE),
            ("moe_train_causal", MOE_TRAIN_SHAPE))),
        ("single_tile", (1, 64, 64, 1, 128), bf16, {}),
        ("ragged_multistage", (1, 2085, 2085, 2, 128), bf16, {}),
        ("non_causal", (2, 256, 256, 4, 128), bf16, dict(causal=False)),
        ("window_64", (2, 512, 512, 4, 128), bf16, dict(window=64)),
        ("offsets_96_32", (1, 256, 256, 4, 64), bf16,
         dict(q_offset=96, kv_offset=32)),
        ("all_future", (1, 128, 128, 2, 64), bf16,
         dict(q_offset=0, kv_offset=1000)),
        ("ragged_200", (2, 200, 200, 4, 64), bf16, {}),
        ("ragged_q70_k300_noncausal", (1, 70, 300, 2, 128), bf16,
         dict(causal=False)),
        ("head_dim_32", (2, 256, 256, 4, 32), bf16, {}),
        ("strided_qkv", (2, 256, 256, 4, 64), bf16, dict(strided=True)),
        ("lse_cotangent", (2, 256, 256, 4, 128), bf16, dict(dlse=True)),
        ("f32_causal_window", (2, 200, 200, 4, 64), f32, dict(window=48)),
        ("f32_offsets", (1, 130, 96, 2, 128), f32,
         dict(q_offset=40, kv_offset=0)),
        ("f32_non_causal_d32", (2, 64, 100, 2, 32), f32,
         dict(causal=False)),
        ("f32_lse_cotangent_ragged", (1, 77, 77, 2, 64), f32,
         dict(dlse=True, window=20)),
    ]
    out = {}
    for name, (b, tq, tk, h, d), dt, kw in cases:
        kw = dict(kw)
        q, k, v = case_qkv(gen, dev, b, tq, tk, h, d, dt,
                           kw.pop("strided", False))
        with_dlse = kw.pop("dlse", False)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        scale = d ** -0.5
        do = torch.randn((b, tq, h, d), generator=gen, device=dev,
                         dtype=f32).to(dt)
        dlse = torch.randn((b, h, tq), generator=gen, device=dev,
                           dtype=f32) if with_dlse else None
        o, lse = flash_attention_with_lse(q, k, v, scale, **kw)
        before = _launch_counts()
        before_instance = _instance_counts()
        if dlse is None:
            grads = torch.autograd.grad(o, (q, k, v), do)
        else:
            grads = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        torch.cuda.synchronize()
        after = _launch_counts()
        launched = [after[i] - before[i] for i in range(3)]
        _, dq_instance, instance = _ran(before_instance)
        # the delta K2 hands K3, from a direct call on the same inputs
        _, delta_k = flash_bwd_dq(q.detach(), k.detach(), v.detach(),
                                  o.detach(), do, lse.detach(), dlse, scale,
                                  **kw)
        delta_ref = _delta(o.detach(), do, dlse)
        delta_err = (delta_k - delta_ref).abs().max().item()
        delta_top = delta_ref.abs().max().item()
        refs = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o.detach(), lse.detach(), do, dlse,
                                         scale, **kw)
        errs = [(g.float() - r.float()).abs().max().item()
                for g, r in zip(grads, refs)]
        tops = [r.float().abs().max().item() for r in refs]
        if name == "all_future":
            ok = all(not g.any() for g in grads) and max(tops) == 0.0
        else:
            tol = TOL_BWD_F32 if dt == f32 else TOL_BWD_BF16
            ok = all(e <= tol * t for e, t in zip(errs, tops)) and all(
                bool(torch.isfinite(g).all()) for g in grads)
        ok = (ok and launched == [0, 1, 1] and instance == _instance(dt, d)
              and dq_instance == _instance(dt, d)
              and delta_err <= TOL_DELTA * delta_top)
        row = {"phase": "kernel_bwd", "case": name, "dtype": str(dt)[6:],
               "shape": [b, tq, tk, h, d], "dlse": with_dlse,
               "dq_instance": dq_instance, "dkv_instance": instance,
               "delta_max_abs_err": delta_err, "delta_max_abs": delta_top,
               "max_abs_err_dq_dk_dv": errs, "max_abs_ref_dq_dk_dv": tops,
               "launches_fwd_dq_dkv": launched, "ok": ok}
        if name == "train_causal":
            qd, kd, vd, od = q.detach(), k.detach(), v.detach(), o.detach()
            delta = _delta(od, do, None)
            lsed = lse.detach()
            pairs = visible_pairs(tq, tk, 0, 0, True, 0)
            dq_bound = backward_bound_ms(b, tq, tk, h, d, dt, pairs, "dq")
            dkv_bound = backward_bound_ms(b, tq, tk, h, d, dt, pairs, "dkv")
            fwd_bound = attention_bound_ms(b, tq, tk, h, d, dt, pairs)
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            do_t = do.transpose(1, 2)
            row.update(
                dq_ms=time_ms(lambda: flash_bwd_dq(qd, kd, vd, od, do, lsed,
                                                   None, scale)),
                dq_previous_ms=time_ms(lambda: flash_bwd_dq(
                    qd, kd, vd, od, do, lsed, None, scale, instance="mma")),
                dkv_ms=time_ms(lambda: flash_bwd_dkv(qd, kd, vd, do, lsed,
                                                     delta, scale)),
                dkv_previous_ms=time_ms(lambda: flash_bwd_dkv(
                    qd, kd, vd, do, lsed, delta, scale, instance="mma")),
                delta_ms=time_ms(lambda: _delta(od, do, None)),
                fwd_ms=time_ms(lambda: _launch(qd, kd, vd, scale, 0, 0,
                                               True, 0)),
                fwd_previous_ms=time_ms(lambda: _launch(
                    qd, kd, vd, scale, 0, 0, True, 0, instance="mma")),
                dq_plain_ms=time_ms(lambda: _dq_plain(qd, kd, _p_ds(
                    qd, kd, vd, lsed, do, _delta(od, do, None), scale, 0, 0,
                    True, 0)[1], scale), runs=5, batch=2, warmup=1),
                dkv_plain_ms=time_ms(lambda: _dkv_plain(
                    qd, kd, vd, do, *_p_ds(qd, kd, vd, lsed, do, delta,
                                           scale, 0, 0, True, 0), scale),
                    runs=5, batch=2, warmup=1),
                library_bwd_ms=time_ms(lambda: torch.autograd.grad(
                    lib_out, (qt, kt, vt), do_t, retain_graph=True)),
                library_fwd_ms=time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt.detach(), kt.detach(), vt.detach(),
                        is_causal=True)),
                plain_fwd_ms=time_ms(
                    lambda: flash_attention_plain(qd, kd, vd, scale),
                    runs=5, batch=2, warmup=1),
                dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1])
            out = dict(row)
            del lib_out, qt, kt, vt
        emit(row)
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"their plain version on {name}: {row}")
    return out


def bigram_tokens(vocab: int, n: int, seed: int, fanout: int = 4):
    """``n`` tokens of a seeded Markov chain in which every token has
    ``fanout`` possible successors: a corpus with structure to learn (its
    entropy is log(fanout) a token), so a few steps lower the loss by more
    than the batch-to-batch noise of uniform random tokens."""
    import numpy as np

    rng = np.random.default_rng(1000 + seed)
    succ = rng.integers(0, vocab, (vocab, fanout))
    pick = rng.integers(0, fanout, n)
    out = np.empty(n, np.uint32)
    cur = int(rng.integers(vocab))
    for i in range(n):
        cur = int(succ[cur, pick[i]])
        out[i] = cur
    return out


def _grad_errors(got, ref) -> list:
    """Per-leaf relative L2 error of ``got`` against ``ref``."""
    return [((g.float() - r).norm() / r.norm().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]


@contextlib.contextmanager
def _counting_delta_prepass():
    """Counts, in the list it yields, the calls of the ``_delta`` pre-pass
    made inside the block: the mma K2 needs it, the sm90 K2 computes delta
    itself."""
    from kubegpu_tpu_torch.workload.kernels import flash

    prepass, calls = flash._delta, [0]

    def counted(*args):
        calls[0] += 1
        return prepass(*args)

    flash._delta = counted
    try:
        yield calls
    finally:
        flash._delta = prepass


def _loss_and_grads(cfg, params, tokens) -> tuple:
    """The loss of ``cfg`` on ``tokens`` and its gradient in every leaf of
    ``params`` (leaves that require grad; their ``.grad`` stays as is)."""
    import torch

    from kubegpu_tpu_torch.workload.model import make_loss_fn
    from kubegpu_tpu_torch.workload.train import param_leaves

    loss = make_loss_fn(cfg)(params, tokens)
    g = torch.autograd.grad(loss, param_leaves(params))
    torch.cuda.synchronize()
    return loss.item(), g


def train_phase(dev) -> dict:
    """The training path at the headline training config: gradient
    accuracy against a float32 reference, then AdamW steps."""
    import dataclasses
    import statistics
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  train_step_model_flops)

    cfg = TransformerConfig(**TRAIN_MODEL)
    gen = torch.Generator(device=dev).manual_seed(3)

    # -- gradient accuracy on one batch: three paths, one at a time
    params, _, _ = init_sharded(torch.Generator(device=dev).manual_seed(2),
                                cfg, init_optimizer=False)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    loss_ref, g_ref = _loss_and_grads(
        dataclasses.replace(cfg, attn_impl="xla", dtype="float32"), params,
        tokens)
    _zero_launch_counts()
    loss_k, g_k = _loss_and_grads(dataclasses.replace(cfg, attn_impl="flash"),
                                  params, tokens)
    grad_launches = list(_launch_counts())
    err_k = _grad_errors(g_k, g_ref)
    del g_k
    loss_p, g_p = _loss_and_grads(dataclasses.replace(cfg, attn_impl="xla"),
                                  params, tokens)
    err_p = _grad_errors(g_p, g_ref)
    finite = all(np.isfinite(err_k)) and all(np.isfinite(err_p))
    del g_p, g_ref, params
    torch.cuda.empty_cache()
    med_k, med_p = statistics.median(err_k), statistics.median(err_p)
    grad_row = {"phase": "train_grad", "layers": cfg.n_layers,
                "loss_f32_plain": loss_ref, "loss_bf16_kernel": loss_k,
                "loss_bf16_plain": loss_p,
                "launches_fwd_dq_dkv": grad_launches,
                "rel_l2_err_kernel_median_max": [med_k, max(err_k)],
                "rel_l2_err_plain_median_max": [med_p, max(err_p)],
                "leaves": len(err_k)}
    grad_row["ok"] = (finite and grad_launches == [cfg.n_layers] * 3
                      and med_k <= TOL_GRAD_RATIO * med_p
                      and max(err_k) <= TOL_GRAD_RATIO * max(err_p))
    emit(grad_row)
    if not grad_row["ok"]:
        raise AssertionError(f"train gradient check failed: {grad_row}")

    # -- AdamW steps through the user's entry points
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-tokens-")
    paths = _token_shards(cfg.vocab, tmp)
    loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(0), cfg)
    step = make_train_step(cfg, optimizer=optimizer)
    losses, step_s, launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    with _counting_delta_prepass() as delta_calls:
        for _ in range(TRAIN_STEPS):
            batch = torch.from_numpy(next(loader)).to(dev)
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(loss.item())              # waits for the step
            step_s.append(time.perf_counter() - t0)
            after = _launch_counts()
            launches.append([after[i] - before[i] for i in range(3)])
    run_launches = list(_launch_counts())
    run_by_instance = _instance_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # remat "full" against remat "none" on the same params and batch: the
    # loss and every leaf's gradient, then one train step with remat "full"
    batch = torch.from_numpy(next(loader)).to(dev)
    full_cfg = dataclasses.replace(cfg, remat="full")
    loss_none, g_none = _loss_and_grads(cfg, params, batch)
    loss_full, g_full = _loss_and_grads(full_cfg, params, batch)
    remat_err = _grad_errors(g_full, g_none)
    del g_none, g_full
    full = make_train_step(full_cfg, optimizer=optimizer)
    _zero_launch_counts()
    params, opt_state, loss = full(params, opt_state, batch)
    loss_full_step = loss.item()
    full_launches = list(_launch_counts())
    loader.close()
    for path in paths:
        os.remove(path)
    os.rmdir(tmp)
    del params, opt_state, optimizer, step, full
    torch.cuda.empty_cache()

    step_ms = statistics.median(step_s[1:]) * 1e3
    flops = train_step_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    n = cfg.n_layers
    row = {"phase": "train", "model": TRAIN_MODEL, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": cfg.remat, "steps": TRAIN_STEPS,
           "loader": type(loader).__name__,
           "losses": losses, "step_ms_each": [t * 1e3 for t in step_s],
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
           "launches_fwd_dq_dkv_per_step": launches,
           "run_launches_by_instance_fwd_dq_dkv": run_by_instance,
           "delta_prepass_calls": delta_calls[0],
           "peak_memory_gb": peak_gb,
           "remat_full_launches_fwd_dq_dkv": full_launches,
           "remat_full_loss": loss_full, "remat_none_loss": loss_none,
           "remat_full_step_loss": loss_full_step,
           "remat_full_vs_none_grad_rel_l2_max": max(remat_err)}
    row["ok"] = (
        all(np.isfinite(losses)) and losses[-1] < losses[0]
        and row["loader"] == "NativeTokenLoader"
        and all(x == [n, n, n] for x in launches)
        and all(c["sm90"] == TRAIN_STEPS * n for c in run_by_instance)
        and delta_calls[0] == 0
        and full_launches == [2 * n, n, n]
        and all(abs(x - loss_none) <= TOL_REMAT_LOSS * abs(loss_none)
                for x in (loss_full, loss_full_step))
        and all(np.isfinite(remat_err))
        and max(remat_err) <= TOL_REMAT_GRAD)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train phase failed: {row}")
    row["run_launches"] = run_launches
    row["run_by_instance"] = run_by_instance
    return row


def train_remat_dots_phase(dev) -> dict:
    """Remat "dots" at the training config: loss and gradients against
    remat "none" on one batch, the flash launches of the dots pass (a
    rerun K1 would show 2 a layer), then AdamW steps of each mode: the
    median time of REMAT_STEPS after a warm-up step, and their peak
    memory."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    cfg = TransformerConfig(**TRAIN_MODEL)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(5), cfg)
    batch = torch.from_numpy(bigram_tokens(
        cfg.vocab, TRAIN_BATCH * (TRAIN_SEQ + 1), seed=7).astype(
            np.int64).reshape(TRAIN_BATCH, -1)).to(dev)
    mode = {r: dataclasses.replace(cfg, remat=r)
            for r in ("none", "dots", "full")}
    loss_none, g_none = _loss_and_grads(mode["none"], params, batch)
    _zero_launch_counts()
    loss_dots, g_dots = _loss_and_grads(mode["dots"], params, batch)
    launches = list(_launch_counts())
    by_instance = _instance_counts()
    err = _grad_errors(g_dots, g_none)
    del g_none, g_dots
    step_ms, peak_gb = {}, {}
    for r, c in mode.items():
        step = make_train_step(c, optimizer=optimizer)
        params, opt_state, loss = step(params, opt_state, batch)
        loss.item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms[r] = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            loss.item()                          # waits for the step
            step_ms[r].append((time.perf_counter() - t0) * 1e3)
        peak_gb[r] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, optimizer
    torch.cuda.empty_cache()
    n = cfg.n_layers
    row = {"phase": "train_remat_dots", "model": TRAIN_MODEL,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "loss_none": loss_none, "loss_dots": loss_dots,
           "dots_vs_none_grad_rel_l2_max": max(err),
           "launches_fwd_dq_dkv": launches,
           "launches_by_instance_fwd_dq_dkv": by_instance,
           "step_ms": {r: statistics.median(t) for r, t in step_ms.items()},
           "step_ms_each": step_ms, "peak_memory_gb": peak_gb}
    row["ok"] = (
        launches == [n, n, n]
        and all(c["sm90"] == n for c in by_instance)
        and abs(loss_dots - loss_none) <= TOL_REMAT_LOSS * abs(loss_none)
        and all(np.isfinite(err)) and max(err) <= TOL_REMAT_GRAD
        and peak_gb["dots"] <= peak_gb["none"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_remat_dots phase failed: {row}")
    return row


def _lora_optimizer():
    from kubegpu_tpu_torch.workload.train import default_optimizer

    return default_optimizer(lr=LORA_LR)


def train_lora_phase(dev, train) -> tuple:
    """LoRA at the training config: 5 steps from the native loader, the
    base frozen (no gradient, bits unchanged), 6 sm90 K1, K2 and K3
    launches a step, step ms and peak memory beside remat none's from the
    ``train`` row. Returns the row and the base params (the checkpoint
    phase resumes LoRA runs over them)."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.lora import (count_params, init_lora,
                                                 make_lora_train_step,
                                                 merge_lora)
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  make_loss_fn)
    from kubegpu_tpu_torch.workload.train import init_sharded, param_leaves

    cfg = TransformerConfig(**TRAIN_MODEL)
    params, _, _ = init_sharded(torch.Generator(device=dev).manual_seed(0),
                                cfg, init_optimizer=False)
    base = param_leaves(params)
    base_bits = [x.detach().cpu() for x in base]
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), params,
                     LORA_RANK)
    adapter_params = count_params(lora)
    optimizer = _lora_optimizer()
    opt_state = optimizer(param_leaves(lora))
    step = make_lora_train_step(cfg, None, LORA_RANK, optimizer)
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-lora-")
    paths = _token_shards(cfg.vocab, tmp)
    loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    losses, step_s, launches, instances = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(LORA_STEPS):
            batch = torch.from_numpy(next(loader)).to(dev)
            if i == 0:
                first = batch
            _zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lora, opt_state, loss = step(lora, opt_state, params, batch)
            losses.append(loss.item())              # waits for the step
            step_s.append(time.perf_counter() - t0)
            launches.append(list(_launch_counts()))
            instances.append(_instance_counts())
    finally:
        loader.close()
        for path in paths:
            os.remove(path)
        os.rmdir(tmp)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        first_after = make_loss_fn(cfg)(merge_lora(params, lora, 1.0),
                                        first).item()
    frozen = all(not x.requires_grad and x.grad is None for x in base)
    unchanged = all(torch.equal(x.detach().cpu(), b)
                    for x, b in zip(base, base_bits))
    del base_bits, opt_state, lora
    torch.cuda.empty_cache()
    n = cfg.n_layers
    step_ms = statistics.median(step_s[1:]) * 1e3
    row = {"phase": "train_lora", "model": TRAIN_MODEL,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "rank": LORA_RANK,
           "targets": ["wq", "wv"], "lr": LORA_LR,
           "adapter_params": adapter_params,
           "base_params": count_params(params),
           "losses": losses, "first_batch_loss_after": first_after,
           "step_ms_each": [t * 1e3 for t in step_s], "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak_gb,
           "remat_none_step_ms": train["step_ms"],
           "remat_none_peak_memory_gb": train["peak_memory_gb"],
           "launches_fwd_dq_dkv_per_step": launches,
           "base_grads_none": frozen, "base_bits_unchanged": unchanged}
    row["ok"] = (
        all(np.isfinite(losses)) and losses[-1] < losses[0]
        and first_after < losses[0]
        and all(x == [n, n, n] for x in launches)
        and all(c["sm90"] == n for ins in instances for c in ins)
        and frozen and unchanged)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_lora phase failed: {row}")
    return row, params


def checkpoint_phase(dev, params) -> dict:
    """A LoRA run over ``params`` saved after CKPT_SAVE_AT of CKPT_STEPS
    steps and resumed: equal losses. Then the training config's full train
    state saved after CKPT_FULL_STEPS AdamW steps and restored as
    serve_demo restores it: equal bits, equal greedy streams, and the
    seconds of each."""
    import shutil
    import tempfile

    import torch

    from kubegpu_tpu_torch.workload.checkpoint import (
        adamw_state, adamw_template, load_train_state, restore_checkpoint,
        save_checkpoint, tree_map)
    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.lora import (init_lora,
                                                 make_lora_train_step)
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  param_leaves)

    cfg = TransformerConfig(**TRAIN_MODEL)
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-ckpt-")
    try:
        paths = _token_shards(cfg.vocab, tmp)
        lora_dir = os.path.join(tmp, "lora")

        def lora_run(resume: bool) -> tuple:
            """train_demo's loop: resume from ``lora_dir`` or start fresh
            and save after CKPT_SAVE_AT steps; the losses and the start."""
            optimizer = _lora_optimizer()
            lora = init_lora(torch.Generator(device=dev).manual_seed(1),
                             params, LORA_RANK)
            opt_state = optimizer(param_leaves(lora))
            step = make_lora_train_step(cfg, None, LORA_RANK, optimizer)
            start = 0
            if resume:
                state, start = restore_checkpoint(
                    lora_dir, {"params": lora,
                               "opt_state": adamw_template(lora)})
                load_train_state(opt_state, lora, state)
            loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
            losses = []
            try:
                for _ in range(start):
                    next(loader)
                for i in range(start, CKPT_STEPS):
                    batch = torch.from_numpy(next(loader)).to(dev)
                    lora, opt_state, loss = step(lora, opt_state, params,
                                                 batch)
                    losses.append(loss.item())
                    if i + 1 == CKPT_SAVE_AT and not resume:
                        save_checkpoint(lora_dir, {
                            "params": lora,
                            "opt_state": adamw_state(opt_state, lora)},
                            step=i + 1)
            finally:
                loader.close()
            return losses, start

        whole, _ = lora_run(resume=False)
        resumed, start = lora_run(resume=True)

        # the training config's full train state after CKPT_FULL_STEPS
        # AdamW steps at the training shape: save, then restore the params
        # only against a shape-only optimizer template, as serve_demo does
        p, opt_state, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(4), cfg)
        step = make_train_step(cfg, optimizer=optimizer)
        gen = torch.Generator(device=dev).manual_seed(5)
        for _ in range(CKPT_FULL_STEPS):
            batch = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                                  generator=gen, device=dev)
            p, opt_state, loss = step(p, opt_state, batch)
        for x in param_leaves(p):
            x.grad = None
        p = tree_map(lambda x: x.detach(), p)
        saved = {"params": p, "opt_state": adamw_state(opt_state, p)}
        full_dir = os.path.join(tmp, "full")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(full_dir, saved, step=CKPT_FULL_STEPS)
        save_s = time.perf_counter() - t0
        file_gb = os.path.getsize(os.path.join(path, "leaves.npz")) / 1e9
        fresh = init_params(torch.Generator(device=dev).manual_seed(6), cfg)
        t0 = time.perf_counter()
        state, at = restore_checkpoint(
            full_dir, {"params": fresh, "opt_state": adamw_template(fresh)})
        restored = tree_map(lambda x: x.to(dev), state["params"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bits_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
            param_leaves(saved), param_leaves(state)))
        del state, saved, opt_state, optimizer, fresh
        torch.cuda.empty_cache()
        prompts = _serve_prompts(cfg)
        want = _drain(cfg, p, prompts)["outs"]
        got = _drain(cfg, restored, prompts)["outs"]
        del p, restored
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "checkpoint", "lora_steps": CKPT_STEPS,
           "lora_saved_at": CKPT_SAVE_AT, "lora_resumed_from": start,
           "lora_losses_uninterrupted": whole, "lora_losses_resumed": resumed,
           "lora_resumed_equal": resumed == whole[CKPT_SAVE_AT:],
           "full_model": TRAIN_MODEL, "full_steps": CKPT_FULL_STEPS,
           "full_restored_step": at,
           "full_file_gb": file_gb, "full_save_s": save_s,
           "full_restore_s": restore_s, "full_leaves_bit_equal": bits_equal,
           "full_streams_equal": got == want,
           "full_tokens": sum(len(o) for o in got),
           "temp_dir_removed": not os.path.exists(tmp)}
    row["ok"] = (start == CKPT_SAVE_AT and row["lora_resumed_equal"]
                 and at == CKPT_FULL_STEPS and bits_equal
                 and row["full_streams_equal"]
                 and row["full_tokens"] == SERVE_REQUESTS * SERVE_MAX_NEW
                 and row["temp_dir_removed"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"checkpoint phase failed: {row}")
    return row


def moe_phase(dev) -> dict:
    """The moe preset's routing at the serving width: a forward through K1,
    AdamW steps through K1-K3, a float32 greedy drain against the oracle."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params,
                                                  make_forward_with_aux)
    from kubegpu_tpu_torch.workload.train import (make_train_step,
                                                  param_leaves)

    cfg = TransformerConfig(**MOE_MODEL)
    n, n_exp = cfg.n_layers, cfg.n_experts
    params = init_params(torch.Generator(device=dev).manual_seed(6), cfg)
    n_params = sum(x.numel() for x in param_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, FORWARD_TOKENS, generator=gen,
                           device=dev)
    fwd = make_forward_with_aux(cfg)
    with torch.no_grad():
        _zero_launch_counts()
        logits, aux = fwd(params, tokens)
        torch.cuda.synchronize()
        fwd_launches = list(_launch_counts())
        fwd_by_instance = _instance_counts()[0]
        fwd_ms = time_ms(lambda: fwd(params, tokens), runs=5, batch=1,
                         warmup=1)
    fwd_ok = (fwd_launches == [n, 0, 0] and fwd_by_instance["sm90"] == n
              and bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == FORWARD_TOKENS + (cfg.vocab,)
              and n <= aux.item() <= n * n_exp)
    fwd_aux = aux.item()
    del logits

    # AdamW steps at the training shape (max_seq is the serving cache's
    # length; the forward itself takes any T)
    tcfg = dataclasses.replace(cfg, max_seq=TRAIN_SEQ)
    step = make_train_step(tcfg)
    chain = bigram_tokens(cfg.vocab, MOE_STEPS * TRAIN_BATCH
                          * (TRAIN_SEQ + 1), seed=8)
    batches = torch.from_numpy(chain.astype(np.int64)).reshape(
        MOE_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1).to(dev)
    train_fwd = make_forward_with_aux(tcfg)
    opt_state, losses, auxes, step_s, launches, instances = \
        None, [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        with torch.no_grad():                    # this step's aux term
            auxes.append(train_fwd(params, batch[:, :-1])[1].item())
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())                  # waits for the step
        step_s.append(time.perf_counter() - t0)
        launches.append(list(_launch_counts()))
        instances.append(_instance_counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for x in param_leaves(params):
        x.grad = None
    del opt_state, batches
    torch.cuda.empty_cache()

    # float32 greedy serving: fused streams against the per-token oracle
    f32 = dataclasses.replace(cfg, dtype="float32")
    prompts = _serve_prompts(cfg)
    fused = _drain(f32, params, prompts)
    oracle = _drain(f32, params, prompts, fused=False)
    del params
    torch.cuda.empty_cache()
    step_ms = statistics.median(step_s[1:]) * 1e3
    row = {"phase": "moe", "model": MOE_MODEL, "params": n_params,
           "forward_tokens": list(FORWARD_TOKENS),
           "forward_launches_fwd_dq_dkv": fwd_launches,
           "forward_ms": fwd_ms, "forward_aux": fwd_aux,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
           "aux_per_step": auxes,
           "step_ms_each": [t * 1e3 for t in step_s], "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak_gb,
           "launches_fwd_dq_dkv_per_step": launches,
           "f32_fused_equals_oracle": fused["outs"] == oracle["outs"],
           "f32_all_full_length": all(len(o) == SERVE_MAX_NEW
                                      for o in fused["outs"]),
           "f32_tokens_per_s": fused["tokens_per_s"],
           "f32_oracle_tokens_per_s": oracle["tokens_per_s"],
           "f32_ttft_p50_ms": fused["ttft_p50_ms"],
           "f32_itl_p50_ms": fused["itl_p50_ms"]}
    row["ok"] = (
        fwd_ok and all(np.isfinite(losses)) and losses[-1] < losses[0]
        and all(n <= a <= n * n_exp for a in auxes)
        and all(x == [n, n, n] for x in launches)
        and all(c["sm90"] == n for ins in instances for c in ins)
        and row["f32_fused_equals_oracle"] and row["f32_all_full_length"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"moe phase failed: {row}")
    return row


# ring_kernels: the ring's sequence-parallel degrees at the training shape
RING_SPS = (4, 2)


def _plain_flash_with_lse(q, k, v, scale, **kw):
    """The flash attention's plain versions as one autograd Function on
    the card (``flash_attention_plain`` forward, ``flash_attention_bwd_plain``
    backward, with the lse cotangent): it stands in for the kernels'
    operator inside the ring, so the ring runs through the plain versions,
    rounding where the kernels round."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        flash_attention_bwd_plain, flash_attention_plain)

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = flash_attention_plain(q, k, v, scale, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
            return o, lse

        @staticmethod
        def backward(ctx, do, dlse):
            return flash_attention_bwd_plain(*ctx.saved_tensors, do, dlse,
                                             scale, **kw)

    return Fn.apply(q, k, v)


def ring_pass(leaves, do, sp: int, scale: float) -> list:
    """One pass of ring attention over every virtual rank of a ring of
    ``sp`` in this process (``ring.InProcessSeqAxis``), on the whole
    sequence's q, k, v (``leaves``): ``[o, dq, dk, dv]``, the gradients of
    ``o`` against the cotangent ``do``."""
    import torch

    from kubegpu_tpu_torch.workload import ring

    qs, ks, vs = (x.chunk(sp, 1) for x in leaves)
    o = torch.cat([ring.ring_flash_attention(
        qs[i], ks[i], vs[i], ring.InProcessSeqAxis(i, ks, vs), scale)
        for i in range(sp)], 1)
    return [o, *torch.autograd.grad(o, leaves, do)]


def _errors(got, ref) -> list:
    """[mean, max] absolute error of ``got`` against ``ref``."""
    e = (got.float() - ref.float()).abs()
    return [e.mean().item(), e.max().item()]


def ring_kernels_phase(dev) -> dict:
    """K1, K2 and K3 as the ring runs them, at the training shape with sp
    = 4 and 2 through the in-process seq axis: every (q_offset, kv_offset)
    pair of the ring against the plain versions (blocks of the future: O =
    0, lse <= -1e20, zero gradients), then the merged ring against a
    float32 plain reference of the whole sequence, with its launches and
    times beside the single-shard kernels'."""
    import torch

    from kubegpu_tpu_torch.workload import ring
    from kubegpu_tpu_torch.workload.kernels.flash import (
        flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq, merge_partials)

    b, t_all, h, d = TRAIN_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = case_qkv(gen, dev, b, t_all, t_all, h, d, bf16)
    do = torch.randn((b, t_all, h, d), generator=gen, device=dev,
                     dtype=f32).to(bf16)

    # the float32 plain reference of the whole sequence, and the single-
    # shard kernels (K1, then K2 and K3 through autograd)
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = flash_attention_plain(qf, kf, vf, scale)
    refs = [o_ref, *flash_attention_bwd_plain(qf, kf, vf, o_ref, lse_ref,
                                              do.float(), None, scale)]
    del qf, kf, vf, lse_ref
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def single():
        o = flash_attention_with_lse(*leaves, scale)[0]
        return [o, *torch.autograd.grad(o, leaves, do)]

    err_single = [_errors(g, r) for g, r in zip(single(), refs)]
    single_ms = time_ms(single, runs=10, batch=2)
    out = {}
    for sp in RING_SPS:
        t = t_all // sp
        pairs, pairs_ok = [], True
        # every pair the ring gives: rank i attends the block of src at
        # some step, src > i a block of the future
        for i in range(sp):
            for src in range(sp):
                kw = dict(q_offset=i * t, kv_offset=src * t)
                qb, dob = (x[:, i * t:(i + 1) * t] for x in (q, do))
                kb, vb = (x[:, src * t:(src + 1) * t] for x in (k, v))
                dlse = torch.randn((b, h, t), generator=gen, device=dev)
                before = _instance_counts()
                o, lse = flash_attention_with_lse(qb, kb, vb, scale, **kw)
                dq, delta = flash_bwd_dq(qb, kb, vb, o, dob, lse, dlse,
                                         scale, **kw)
                dk, dv = flash_bwd_dkv(qb, kb, vb, dob, lse, delta, scale,
                                       **kw)
                torch.cuda.synchronize()
                ran = _ran(before)
                ro, rl = flash_attention_plain(qb, kb, vb, scale, **kw)
                want = flash_attention_bwd_plain(qb, kb, vb, o, lse, dob,
                                                 dlse, scale, **kw)
                grads = (dq, dk, dv)
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(grads, want)]
                tops = [w.float().abs().max().item() for w in want]
                finite = all(bool(torch.isfinite(x).all())
                             for x in (o, lse, *grads))
                if src > i:
                    ok = (o.abs().max().item() == 0.0
                          and lse.max().item() <= -1e20
                          and all(not g.any() for g in grads))
                else:
                    ok = ((o.float() - ro.float()).abs().max().item()
                          <= TOL_BF16_O
                          and (lse - rl).abs().max().item() <= TOL_BF16_LSE
                          and all(e <= TOL_BWD_BF16 * top
                                  for e, top in zip(errs, tops)))
                ok = ok and finite and ran == ("sm90",) * 3
                pairs.append({"q_offset": i * t, "kv_offset": src * t,
                              "future": src > i, "max_abs_err_dq_dk_dv":
                              errs, "ok": ok})
                pairs_ok = pairs_ok and ok

        # the merged ring through the kernels, counted from zero; then the
        # same ring through the plain versions
        _zero_launch_counts()
        got = ring_pass(leaves, do, sp, scale)
        torch.cuda.synchronize()
        launches = list(_launch_counts())
        by_instance = _instance_counts()
        err_ring = [_errors(g, r) for g, r in zip(got, refs)]
        kernel_attend = ring.flash_attention_with_lse
        ring.flash_attention_with_lse = _plain_flash_with_lse
        try:
            err_plain = [_errors(g, r) for g, r in
                         zip(ring_pass(leaves, do, sp, scale), refs)]
        finally:
            ring.flash_attention_with_lse = kernel_attend
        ring_ms = time_ms(lambda: ring_pass(leaves, do, sp, scale), runs=10,
                          batch=2)
        # one merge of a step's partial into the float32 carry (the ring
        # runs sp per virtual rank, sp^2 a pass, and their backward)
        o_r, lse_r = flash_attention_with_lse(q[:, :t], k[:, :t], v[:, :t],
                                              scale)
        carry = (o_r.float(), lse_r.clone())
        merge_ms = time_ms(lambda: merge_partials(*carry, o_r, lse_r))
        # forward: the single-shard path's rule; gradients: the plain
        # ring's (each step rounds its partial dK/dV, and the dO the merge
        # hands back, to bf16, so no block-wise bf16 ring keeps within
        # 1.25x of the single-shard path's mean gradient error)
        base = [err_single[0]] + err_plain[1:]
        merged_ok = all(
            r[0] <= TOL_FWD_MEAN_RATIO * s[0]
            and r[1] <= TOL_FWD_MAX_RATIO * s[1]
            for r, s in zip(err_ring, base))
        n2 = sp * sp
        row = {"phase": "ring_kernels", "sp": sp,
               "shape": [b, t_all, h, d], "block": t, "dtype": "bfloat16",
               "pairs": len(pairs), "future_pairs": sum(
                   p["future"] for p in pairs),
               "pair_max_abs_err_dq_dk_dv_max": [
                   max(p["max_abs_err_dq_dk_dv"][j] for p in pairs)
                   for j in range(3)],
               "pairs_ok": pairs_ok,
               "err_mean_max_o_dq_dk_dv": {
                   "ring": err_ring, "plain_ring": err_plain,
                   "single_shard": err_single},
               "ratio_to_single_mean_o_dq_dk_dv": [
                   r[0] / s[0] for r, s in zip(err_ring, err_single)],
               "launches_fwd_dq_dkv_per_pass": launches,
               "launches_by_instance": by_instance,
               "ring_fwd_bwd_ms": ring_ms, "single_fwd_bwd_ms": single_ms,
               "merge_ms": merge_ms}
        row["ok"] = (pairs_ok and merged_ok and launches == [n2] * 3
                     and all(c["sm90"] == n2 for c in by_instance))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"ring kernels failed at sp={sp}: {row}")
        out[sp] = row
        del got
    return out


@contextlib.contextmanager
def world_of_one(dev):
    """A world-size-1 process group (NCCL on the card; a ``file://`` store
    in a temporary directory) for the mesh phases; yields the directory,
    which they may use, and removes it after."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from kubegpu_tpu_torch.workload import spmd

    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-mesh-")
    dist.init_process_group(spmd.backend_for(dev),
                            init_method=f"file://{tmp}/store",
                            world_size=1, rank=0)
    try:
        yield tmp
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def train_mesh_phase(dev, train, tmp) -> dict:
    """The sharded training path on the card at world size 1 (NCCL, in
    `world_of_one`): the multi-device dry run, then the sharded step at the
    training config (dp = sp = tp = 1) against the single-device step on
    one batch (loss and per-leaf gradients, 6 K1, K2 and K3 sm90
    launches), and its AdamW steps' median ms beside the ``train``
    phase's."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubegpu_tpu_torch.entry import dryrun_multichip
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  make_loss_fn)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  param_leaves)

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    backend = dist.get_backend()
    t0 = time.perf_counter()
    dryrun_multichip(n_dev, device=dev)
    dryrun_s = time.perf_counter() - t0

    cfg = TransformerConfig(**TRAIN_MODEL)
    mesh = spmd.make_mesh(1, 1, 1, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    params, _, _ = init_sharded(
        torch.Generator(device=dev).manual_seed(2), cfg,
        init_optimizer=False)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    loss_one, g_one = _loss_and_grads(cfg, params, tokens)
    local = spmd.shard_params(params, cfg, mesh)
    del params
    leaves = param_leaves(local)
    for x in leaves:
        x.requires_grad_(True)
    _zero_launch_counts()
    loss = make_loss_fn(cfg, mesh)(local, spmd.global_batch(mesh, tokens))
    loss.backward()
    spmd.all_reduce_grads(leaves, mesh)
    torch.cuda.synchronize()
    grad_launches = list(_launch_counts())
    grad_by_instance = _instance_counts()
    loss_mesh = loss.item()
    grad_err = _grad_errors([x.grad for x in leaves], g_one)
    del g_one, local, leaves, loss
    torch.cuda.empty_cache()

    # AdamW steps through the user's entry points, from the loader
    paths = _token_shards(cfg.vocab, tmp)
    loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(0), cfg, mesh)
    step = make_train_step(cfg, mesh, optimizer)
    losses, step_s, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = next(loader)                 # the global batch, numpy
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())              # waits for the step
        step_s.append(time.perf_counter() - t0)
        launches.append(list(_launch_counts()))
    by_instance = _instance_counts()
    loader.close()
    del params, opt_state, optimizer, step
    torch.cuda.empty_cache()
    n = cfg.n_layers
    step_ms = statistics.median(step_s[1:]) * 1e3
    row = {"phase": "train_mesh", "backend": backend, "world_size": 1,
           "mesh": [1, 1, 1], "dryrun_devices": n_dev,
           "dryrun_s": dryrun_s, "model": TRAIN_MODEL,
           "loss_single": loss_one, "loss_mesh": loss_mesh,
           "grad_rel_l2_max": max(grad_err),
           "grad_launches_fwd_dq_dkv": grad_launches,
           "losses": losses, "step_ms_each": [x * 1e3 for x in step_s],
           "step_ms": step_ms, "train_step_ms": train["step_ms"],
           "launches_fwd_dq_dkv_per_step": launches}
    row["ok"] = (
        backend == spmd.backend_for(dev)
        and abs(loss_mesh - loss_one) <= TOL_REMAT_LOSS * abs(loss_one)
        and all(np.isfinite(grad_err)) and max(grad_err) <= TOL_REMAT_GRAD
        and grad_launches == [n] * 3
        and all(c["sm90"] == n for c in grad_by_instance)
        and all(np.isfinite(losses)) and losses[-1] < losses[0]
        and all(x == [n] * 3 for x in launches)
        and all(c["sm90"] == n for c in by_instance))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_mesh phase failed: {row}")
    return row


def serve_mesh_phase(dev, serve, ckpt, tmp) -> dict:
    """The sharded serving paths and the sharded resume on the card at
    world size 1 (in `world_of_one`): the serving config's sharded
    generate, server and speculative server against the unsharded ones in
    float32, tokens/s in bf16 in turns; the training config's sharded
    save, restore and resumed steps against the uninterrupted run; the dry
    run with its serving leg."""
    import dataclasses

    import numpy as np
    import torch

    from kubegpu_tpu_torch.entry import dryrun_multichip
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.checkpoint import (
        adamw_state, adamw_template, load_train_state, restore_checkpoint,
        save_checkpoint, train_state_specs)
    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.decode import make_generate
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    mesh = spmd.make_mesh(1, 1, 1, 1, device=dev)
    # the serving config (the serve phase's params: the same seed)
    cfg = TransformerConfig(**MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    local = spmd.shard_params(params, cfg, mesh)
    dcfg = TransformerConfig(**DRAFT_MODEL)
    dlocal = spmd.shard_params(
        init_params(torch.Generator(device=dev).manual_seed(1), dcfg),
        dcfg, mesh)
    f32, df32 = (dataclasses.replace(c, dtype="float32") for c in (cfg, dcfg))
    prompts = _serve_prompts(cfg)
    # 4 rows of equal length: the 4 longest prompts cut to the shortest
    rows = [p[:len(prompts[4])] for p in prompts[4:]]
    gen_mesh = make_generate(f32, mesh)(local, rows, SERVE_MAX_NEW)
    gen_one = make_generate(f32)(params, torch.tensor(rows, device=dev),
                                 SERVE_MAX_NEW)
    plain = _drain(f32, params, prompts)["outs"]
    sharded = _drain(f32, local, prompts, mesh=mesh)["outs"]
    spec = _drain(f32, local, prompts, mesh=mesh, draft_params=dlocal,
                  draft_cfg=df32, lookahead=SPEC_LOOKAHEAD,
                  spec_rounds=SPEC_ROUNDS)["outs"]
    # bf16 greedy tokens/s, one drain each (in turns over several pairs:
    # tools/mesh_serve_ab.py)
    mesh_rate = _drain(cfg, local, prompts, mesh=mesh)["tokens_per_s"]
    plain_rate = _drain(cfg, params, prompts)["tokens_per_s"]
    del params, local, dlocal
    torch.cuda.empty_cache()

    # the sharded resume at the training config
    tcfg = TransformerConfig(**TRAIN_MODEL)
    specs = train_state_specs(spmd.param_pspecs(tcfg))
    paths = _token_shards(tcfg.vocab, tmp)
    ckpt_dir = os.path.join(tmp, "ckpt")

    def run(seed, start, n, save_at=None, restore=False) -> tuple:
        """``n`` sharded steps from batch ``start`` of the loader from
        fresh shards (``seed``), restored first if asked, saved after
        ``save_at`` steps: the losses, launches a step, save and restore
        seconds."""
        params, opt, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(seed), tcfg, mesh)
        secs = {}
        if restore:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, at = restore_checkpoint(
                ckpt_dir, {"params": params,
                           "opt_state": adamw_template(params)},
                mesh=mesh, specs=specs)
            load_train_state(opt, params, state)
            torch.cuda.synchronize()
            secs["restore_s"] = time.perf_counter() - t0
            secs["restored_step"] = at
            del state
        step = make_train_step(tcfg, mesh, optimizer)
        loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        losses, launches = [], []
        try:
            for _ in range(start):
                next(loader)
            for i in range(start, start + n):
                batch = next(loader)
                _zero_launch_counts()
                params, opt, loss = step(params, opt, batch)
                losses.append(loss.item())
                launches.append(list(_launch_counts()))
                if save_at == i + 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    save_checkpoint(ckpt_dir, {
                        "params": params,
                        "opt_state": adamw_state(opt, params)},
                        step=i + 1, mesh=mesh, specs=specs)
                    secs["save_s"] = time.perf_counter() - t0
        finally:
            loader.close()
        return losses, launches, _instance_counts(), secs

    whole, _, _, saved = run(0, 0, 4, save_at=2)
    torch.cuda.empty_cache()
    resumed, launches, by_instance, restored = run(7, 2, 2, restore=True)
    torch.cuda.empty_cache()
    file_gb = os.path.getsize(os.path.join(ckpt_dir, "step_2",
                                           "leaves.npz")) / 1e9
    t0 = time.perf_counter()
    dryrun_multichip(1, device=dev)
    dryrun_s = time.perf_counter() - t0
    n = tcfg.n_layers
    row = {"phase": "serve_mesh", "mesh": [1, 1, 1],
           "generate_rows": [len(r) for r in rows],
           "generate_equal": bool(torch.equal(gen_mesh, gen_one)),
           "server_equal": sharded == plain,
           "spec_server_equal": spec == plain,
           "all_full_length": all(len(o) == SERVE_MAX_NEW
                                  for o in sharded + spec),
           "bf16_mesh_tokens_per_s": mesh_rate,
           "bf16_plain_tokens_per_s": plain_rate,
           "serve_phase_tokens_per_s": serve["tokens_per_s"],
           "resume_model": TRAIN_MODEL, "losses_uninterrupted": whole,
           "losses_resumed": resumed,
           "restored_step": restored["restored_step"],
           "resumed_equal": resumed == whole[2:],
           "launches_fwd_dq_dkv_per_step": launches,
           "file_gb": file_gb, "save_s": saved["save_s"],
           "restore_s": restored["restore_s"],
           "checkpoint_phase_save_s": ckpt["full_save_s"],
           "checkpoint_phase_restore_s": ckpt["full_restore_s"],
           "dryrun_s": dryrun_s}
    row["ok"] = (row["generate_equal"] and row["server_equal"]
                 and row["spec_server_equal"] and row["all_full_length"]
                 and row["restored_step"] == 2 and row["resumed_equal"]
                 and all(np.isfinite(whole))
                 and all(x == [n] * 3 for x in launches)
                 and all(c["sm90"] == n for c in by_instance))
    row["bf16_mesh_over_plain"] = mesh_rate / plain_rate
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_mesh phase failed: {row}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.workload.kernels import _build
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)

    dev = resolve_device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for name in libs for ln in
             _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "ptxas": ptxas})

    k1 = kernel_phase(dev)
    cfg = TransformerConfig(**MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    fwd = forward_phase(dev, cfg, params)
    entry_phase()
    serve = serve_phase(dev, cfg, params)
    serve_sampled_phase(dev, cfg, params)
    serve_spec_phase(dev, cfg, params)
    serve_prefix_phase(dev, cfg, params)
    del params                      # the training phases need the memory
    torch.cuda.empty_cache()

    kb = kernel_bwd_phase(dev)
    loader_phase(cfg)
    train = train_phase(dev)
    dots = train_remat_dots_phase(dev)
    lora, base = train_lora_phase(dev, train)
    ckpt = checkpoint_phase(dev, base)
    del base
    torch.cuda.empty_cache()
    moe = moe_phase(dev)
    ring_rows = ring_kernels_phase(dev)
    with world_of_one(dev) as tmp:
        mesh = train_mesh_phase(dev, train, tmp)
        serve_mesh = serve_mesh_phase(dev, serve, ckpt, tmp)
    # each path's own launches, counted from zero: K1's "launches" is the
    # forward path's (slice 1), K2's and K3's the training run's; the LoRA
    # and MoE steps' are their last step's; the ring's its kernel pass at
    # sp = 4 (and 2), the sharded step's its last step's
    # each kernel's instance is the main path's (bf16, head_dim 128: sm90);
    # "previous_ms" times their mma.sync instance at the same shape, K2's
    # with the `_delta` pre-pass it needs ("delta_ms" alone)
    run = train["run_launches"]
    lora_step = lora["launches_fwd_dq_dkv_per_step"][-1]
    moe_step = moe["launches_fwd_dq_dkv_per_step"][-1]
    # the ring's pass over every virtual rank (sp^2 launches of each), and
    # the last sharded step's
    ring_pass = ring_rows[4]["launches_fwd_dq_dkv_per_pass"]
    ring_pass_sp2 = ring_rows[2]["launches_fwd_dq_dkv_per_pass"]
    mesh_step = mesh["launches_fwd_dq_dkv_per_step"][-1]
    resume_step = serve_mesh["launches_fwd_dq_dkv_per_step"][-1]
    k1_run, k2_run, k3_run = train["run_by_instance"]
    src = "kubegpu_tpu_torch/csrc/"
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": src + "flash_fwd_sm90.cu", "instance": k1["instance"],
        "previous_source": src + "flash_fwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:126",
        "launches": fwd["kernel_launches"],
        "launches_by_instance": fwd["kernel_launches_by_instance"],
        "launches_train_run": run[0],
        "launches_train_run_by_instance": k1_run,
        "launches_remat_dots_step": dots["launches_fwd_dq_dkv"][0],
        "launches_lora_step": lora_step[0], "launches_moe_step": moe_step[0],
        "launches_moe_forward": moe["forward_launches_fwd_dq_dkv"][0],
        "launches_ring_pass": ring_pass[0],
        "launches_ring_pass_sp2": ring_pass_sp2[0],
        "launches_train_mesh_step": mesh_step[0],
        "launches_serve_mesh_step": resume_step[0],
        "max_abs_err": k1["max_abs_err_o"], "ms": k1["ms"],
        "op_ms": k1["op_ms"], "previous_ms": k1["previous_ms"],
        "serve_shape_previous_ms": k1["previous_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "train_shape_ms": kb["fwd_ms"],
        "train_shape_previous_ms": kb["fwd_previous_ms"],
        "train_shape_library_ms": kb["library_fwd_ms"],
        "train_shape_bound_ms": kb["fwd_bound_ms"]}, {
        "name": "flash_bwd_dq", "route": "cuda",
        "source": src + "flash_bwd_dq_sm90.cu",
        "instance": kb["dq_instance"],
        "previous_source": src + "flash_bwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:213",
        "launches": run[1], "launches_train_run": run[1],
        "launches_train_run_by_instance": k2_run,
        "launches_remat_dots_step": dots["launches_fwd_dq_dkv"][1],
        "launches_lora_step": lora_step[1], "launches_moe_step": moe_step[1],
        "launches_ring_pass": ring_pass[1],
        "launches_ring_pass_sp2": ring_pass_sp2[1],
        "launches_train_mesh_step": mesh_step[1],
        "launches_serve_mesh_step": resume_step[1],
        "max_abs_err": kb["max_abs_err_dq_dk_dv"][0],
        "delta_max_abs_err": kb["delta_max_abs_err"], "ms": kb["dq_ms"],
        "previous_ms": kb["dq_previous_ms"], "delta_ms": kb["delta_ms"],
        "plain_ms": kb["dq_plain_ms"], "bound_ms": kb["dq_bound_ms"],
        "bound_by": kb["dq_bound_by"],
        "library_ms": kb["library_bwd_ms"],
        "k2_k3_ms": kb["dq_ms"] + kb["dkv_ms"]}, {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": src + "flash_bwd_dkv_sm90.cu",
        "instance": kb["dkv_instance"],
        "previous_source": src + "flash_bwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:244",
        "launches": run[2], "launches_train_run": run[2],
        "launches_train_run_by_instance": k3_run,
        "launches_remat_dots_step": dots["launches_fwd_dq_dkv"][2],
        "launches_lora_step": lora_step[2], "launches_moe_step": moe_step[2],
        "launches_ring_pass": ring_pass[2],
        "launches_ring_pass_sp2": ring_pass_sp2[2],
        "launches_train_mesh_step": mesh_step[2],
        "launches_serve_mesh_step": resume_step[2],
        "max_abs_err": max(kb["max_abs_err_dq_dk_dv"][1:]),
        "ms": kb["dkv_ms"], "previous_ms": kb["dkv_previous_ms"],
        "plain_ms": kb["dkv_plain_ms"],
        "bound_ms": kb["dkv_bound_ms"], "bound_by": kb["dkv_bound_by"],
        "library_ms": kb["library_bwd_ms"]}]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
