#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kubegpu_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kubegpu_tpu_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives the port's main path at the width of the repository's serving
benchmark (vocab 8192, d_model 2048, 16 heads, 6 layers, d_ff 8192,
max_seq 1024, random weights from a seed):

1. device: the card's name and power limit (nvidia-smi);
2. build: the nvcc build and its seconds;
3. kernel: the flash-attention forward against ``flash_attention_plain``
   at the serving shape and at masking edge cases, with its time, the
   plain version's, ``scaled_dot_product_attention``'s (a yardstick the
   port never calls) and the least time the card could take;
4. forward: the full-width forward pass on tokens [4, 1024] through the
   kernel (one launch per layer), against the same forward with the plain
   attention;
5. entry: the port's ``entry()`` forward on the card;
6. serve: the continuous-batching server on the benchmark's traffic (4
   slots, 8 prompts of 16..512 tokens, 64 new tokens each, greedy); the
   fused data plane's streams against the per-token oracle's.

Every phase prints one JSON line and raises on failure. The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

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


def kernel_phase(dev) -> dict:
    """K1 against its plain version at the serving shape and edge cases."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        flash_attention_plain, flash_attention_with_lse)

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    b0, t0, h0, d0 = SLICE_SHAPE
    cases = [
        # name, (B, Tq, Tk, H, D), dtype, kwargs
        ("slice_causal", (b0, t0, t0, h0, d0), bf16, {}),
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
        strided = kw.pop("strided", False)
        if strided:  # q, k, v as views of one packed [B, T, 3, H, D] tensor
            qkv = torch.randn((b, tq, 3, h, d), generator=gen, device=dev,
                              dtype=f32).to(dt)
            q, k, v = qkv.unbind(2)
        else:
            q = torch.randn((b, tq, h, d), generator=gen, device=dev,
                            dtype=f32).to(dt)
            k, v = (torch.randn((b, tk, h, d), generator=gen, device=dev,
                                dtype=f32).to(dt) for _ in range(2))
        scale = d ** -0.5
        o, lse = flash_attention_with_lse(q, k, v, scale, **kw)
        torch.cuda.synchronize()
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
        row = {"phase": "kernel", "case": name, "dtype": str(dt)[6:],
               "shape": [b, tq, tk, h, d], "max_abs_err_o": err_o,
               "max_abs_err_lse": err_l, "ok": ok}
        if name == "slice_causal":
            pairs = visible_pairs(tq, tk, 0, 0, True, 0)
            bound, bound_by = attention_bound_ms(b, tq, tk, h, d, dt, pairs)
            row.update(
                ms=time_ms(lambda: flash_attention_with_lse(q, k, v, scale)),
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
        flash_attention_with_lse.launches = 0
        logits = fwd(params, tokens)
        torch.cuda.synchronize()
        launches = flash_attention_with_lse.launches
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
        launches == cfg.n_layers and row["finite"]
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

    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "kubegpu_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:126",
        "launches": fwd["kernel_launches"],
        "max_abs_err": k1["max_abs_err_o"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]}]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
