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
   at the serving shape and at masking edge cases (one tile; several
   stages over a ragged T = 2085), each row naming the kernel instance
   that ran, with its time, the previous (mma.sync) design's time at the
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
   ``flash_attention_bwd_plain`` at the training shape and at masking
   edge cases (the same new ones as the forward's), each row naming K2's
   and K3's instances and holding the delta K2 hands K3 against
   ``_delta``; with K2's, K3's and K1's times there, their previous
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
   per-leaf gradients) and one step with ``remat="full"``.

The ``kernels`` line names each kernel's instance on the main path and
the launches that went to each instance. Every phase prints one JSON line
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
    """K1 against its plain version at the serving shape and edge cases."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        _instance, _launch, flash_attention_plain, flash_attention_with_lse)

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    b0, t0, h0, d0 = SLICE_SHAPE
    cases = [
        # name, (B, Tq, Tk, H, D), dtype, kwargs
        ("slice_causal", (b0, t0, t0, h0, d0), bf16, {}),
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
            row.update(
                ms=time_ms(lambda: flash_attention_with_lse(q, k, v, scale)),
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


def serve_phase(dev, cfg, params) -> dict:
    """DecodeServer on the benchmark's traffic; fused against oracle."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch import metrics
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in np.linspace(16, cfg.max_seq // 2, SERVE_REQUESTS)]

    def serve(fused: bool):
        os.environ["KGTPU_FUSED_SERVE"] = "1" if fused else "0"
        srv = DecodeServer(cfg, params, slots=SERVE_SLOTS)
        assert srv.fused == fused
        metrics.reset_all()
        t0 = time.perf_counter()
        rids = [srv.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [srv.result(r) for r in rids]
        return outs, wall, metrics.SERVE_TTFT_MS.percentile(0.5), \
            metrics.SERVE_ITL_MS.percentile(0.5)

    serve(True)                                  # warm-up pass
    fused, wall, ttft, itl = serve(True)
    oracle, wall_o, _, _ = serve(False)
    os.environ.pop("KGTPU_FUSED_SERVE", None)
    n_tok = sum(len(o) for o in fused)
    row = {"phase": "serve", "slots": SERVE_SLOTS,
           "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
           "prompt_lens": [len(p) for p in prompts],
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_ms": ttft, "itl_p50_ms": itl,
           "oracle_tokens_per_s": sum(len(o) for o in oracle) / wall_o,
           "all_full_length": all(len(o) == SERVE_MAX_NEW for o in fused),
           "fused_equals_oracle": fused == oracle,
           "first_output": fused[0][:8]}
    row["ok"] = row["all_full_length"] and row["fused_equals_oracle"]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve phase failed: {row}")
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
    at the training shape and edge cases, and the delta K2 gives K3 against
    `_delta`; times at the training shape."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        _delta, _dkv_plain, _dq_plain, _instance, _launch, _p_ds,
        flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq)

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    b0, t0, h0, d0 = TRAIN_SHAPE
    cases = [
        ("train_causal", (b0, t0, t0, h0, d0), bf16, {}),
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
                fwd_ms=time_ms(lambda: flash_attention_with_lse(
                    qd, kd, vd, scale)),
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

    from kubegpu_tpu_torch.workload.data import make_loader, write_token_shard
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
    paths = [write_token_shard(os.path.join(tmp, f"shard{i}.kgtd"),
                               bigram_tokens(cfg.vocab, 100_000, seed=i))
             for i in range(2)]
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
    serve_phase(dev, cfg, params)
    del params                      # the training phases need the memory
    torch.cuda.empty_cache()

    kb = kernel_bwd_phase(dev)
    train = train_phase(dev)
    # each path's own launches, counted from zero: K1's "launches" is the
    # forward path's (slice 1), K2's and K3's the training run's
    # each kernel's instance is the main path's (bf16, head_dim 128: sm90);
    # "previous_ms" times their mma.sync instance at the same shape, K2's
    # with the `_delta` pre-pass it needs ("delta_ms" alone)
    run = train["run_launches"]
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
        "max_abs_err": k1["max_abs_err_o"], "ms": k1["ms"],
        "previous_ms": k1["previous_ms"],
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
