"""Flash attention: hand-written CUDA kernels and their plain versions.

The counterpart of ``kubegpu_tpu/workload/kernels/flash.py``'s public API
(``flash_attention_with_lse``, ``flash_attention``, ``merge_partials``)
with the same ``[B, T, H, D]`` layout, forward and backward:

- the TPU's Pallas forward kernel (``_fwd_kernel``) becomes K1: one
  thread block per ``(b, h, q-tile)`` with an in-block loop over k-tiles,
  bf16 tensor-core products with float32 online softmax, tiles the mask
  hides skipped, the ``[B, T, H, D]`` strides read directly (no
  transposes);
- the two backward kernels (``_dq_kernel``, ``_dkv_kernel``) become K2
  (dQ over k-tiles) and K3 (dK and dV over q-tiles), behind a
  ``torch.autograd.Function`` that saves ``(q, k, v, o, lse)`` and takes
  the lse cotangent, which ring attention's merge needs.

Each kernel has two instances, picked by `_instance` from the dtype and
head_dim alone: "sm90" (``csrc/flash_fwd_sm90.cu``,
``csrc/flash_bwd_dq_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu``: wgmma, TMA,
a producer warpgroup; bf16 at head_dim 64 and 128, the main path) and
"mma" (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``: mma.sync for bf16,
plain FMAs for float32). The sm90 K2 also computes the backward's row
term delta, which K3 reads; before the mma K2 (and on the CPU) `_delta`
computes it in PyTorch. A launch the instance refuses raises; no
instance stands in for another.

Dispatch: a tensor on the CPU goes to the plain version
(`flash_attention_plain`, `flash_attention_bwd_plain`: the full score
matrix, masked at global positions); a tensor on CUDA launches the
kernel or raises. There is no fallback between the two.
``flash_attention_with_lse.launches``, ``flash_bwd_dq.launches`` and
``flash_bwd_dkv.launches`` count kernel launches, and each wrapper's
``launches_by_instance`` counts them per instance.

Rows that see no key at all give ``O = 0``, ``lse <= -1e20`` and zero
gradients on both versions. (The Pallas kernel gives that only when every
tile of the row is skipped; in a partly visible tile its fully masked row
averages the tile's V. Causal and windowed attention never produce such a
row, since every query sees itself.)
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
SM90_HEAD_DIMS = (64, 128)
# instance -> kernel -> (library, symbol); a library is built from
# csrc/<library>.cu
_LIBS = {"sm90": {"fwd": ("flash_fwd_sm90", "kgt_flash_fwd_sm90"),
                  "dq": ("flash_bwd_dq_sm90", "kgt_flash_bwd_dq_sm90"),
                  "dkv": ("flash_bwd_dkv_sm90", "kgt_flash_bwd_dkv_sm90")},
         "mma": {"fwd": ("flash_fwd", "kgt_flash_fwd_mma"),
                 "dq": ("flash_bwd", "kgt_flash_bwd_dq_mma"),
                 "dkv": ("flash_bwd", "kgt_flash_bwd_dkv_mma")}}


def _instance(dtype, d: int) -> str:
    """The kernel instance of K1, K2 and K3 for ``dtype`` and head_dim ``d``:
    "sm90" for bf16 at head_dim 64 or 128, "mma" for bf16 at 32 and for
    float32. Raises ValueError for a head_dim no instance takes."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS \
        else "mma"


def _mask(tq: int, tk: int, q_offset: int, kv_offset: int, causal: bool,
          window: int, device):
    """The ``[Tq, Tk]`` visibility mask at global positions, or None when
    nothing is masked. A window implies the causal bound: keys in
    ``(q - window, q]``, with or without ``causal``."""
    if not causal and not window:
        return None
    qp = q_offset + torch.arange(tq, device=device)
    kp = kv_offset + torch.arange(tk, device=device)
    mask = qp[:, None] >= kp[None, :]
    if window:
        mask &= kp[None, :] > qp[:, None] - window
    return mask


def flash_attention_plain(q, k, v, scale, *, q_offset=0, kv_offset=0,
                          causal=True, window=0):
    """The plain version of the kernel: the full ``[Tq, Tk]`` score matrix
    in float32, masked at global positions, ``P = exp(S - rowmax)`` cast
    to the input type before ``P @ V`` and divided by the float32 row sum
    afterwards, as the kernel does. Returns ``(o [B,Tq,H,D], lse
    [B,H,Tq] f32)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], int(q_offset), int(kv_offset),
                 causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30).squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return o.to(q.dtype), lse


def _kernel_operand(x):
    """``x`` as the kernel reads it: unit stride in D; for bf16, the row
    strides positive multiples of 8 elements and the base 16-byte aligned
    (the mma kernels stage rows with 16-byte loads, and the sm90 kernels'
    TMA maps need exactly that). Anything else, an expanded (stride 0)
    view included, is copied to a contiguous tensor first; a view of a
    packed [B, T, 3, H, D] tensor passes as it is."""
    ok = x.stride(-1) == 1 and x.data_ptr() % 16 == 0
    if x.dtype == torch.bfloat16:
        ok = ok and all(s > 0 and s % 8 == 0 for s in x.stride()[:3])
    return x if ok else x.contiguous()


def _launch(q, k, v, scale, q_offset, kv_offset, causal, window,
            instance=None):
    """K1 on the current stream: ``instance`` None takes `_instance`'s
    choice; "mma" at bf16 head_dim 64/128 runs the previous design (only
    ``chip_smoke.py`` asks for it, to time it)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or float32 q/k/v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    instance = instance or _instance(q.dtype, d)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    from kubegpu_tpu_torch.workload.kernels import _build

    lib, symbol = _LIBS[instance]["fwd"]
    fn = getattr(_build.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPES[q.dtype], b, h, tq, tk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], float(scale), int(q_offset),
                 int(kv_offset), int(bool(causal)), int(window), stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_with_lse.launches += 1
    flash_attention_with_lse.launches_by_instance[instance] += 1
    return o, lse


def _check_device(q) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")


def _delta(o, do, dlse):
    """The backward's row term ``rowsum(dO * O) - dlse``, ``[B, H, Tq]``
    float32 (flash.py:285-294): the lse cotangent folds in here, since
    dS = P * (dP - delta) + dlse * P."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _p_ds(q, k, v, lse, do, delta, scale, q_offset, kv_offset, causal,
          window):
    """``(P, dS)``, ``[B, H, Tq, Tk]`` float32: masked scores -inf, so
    ``P = exp(S - lse)`` is exactly 0 there; ``dS = P * (dO V^T - delta)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], int(q_offset), int(kv_offset),
                 causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, -float("inf"))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _dq_plain(q, k, ds, scale):
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype)


def _dkv_plain(q, k, v, do, p, ds, scale):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, scale, *,
                              q_offset=0, kv_offset=0, causal=True,
                              window=0):
    """The plain version of K2 and K3: the full ``[Tq, Tk]`` score matrix
    in float32, masked scores -inf so ``P = exp(S - lse)`` is exactly 0
    there; ``delta = rowsum(dO * O) - dlse``, ``dP = dO V^T``,
    ``dS = P * (dP - delta)``, ``dq = scale dS K``, ``dk = scale dS^T Q``,
    ``dv = P^T dO``, with P and dS cast to the input type before their
    products and float32 accumulation, as the kernels do. ``dlse`` may be
    None (no lse cotangent). Returns ``(dq, dk, dv)`` like q, k, v."""
    p, ds = _p_ds(q, k, v, lse, do, _delta(o, do, dlse), scale, q_offset,
                  kv_offset, causal, window)
    return (_dq_plain(q, k, ds, scale),
            *_dkv_plain(q, k, v, do, p, ds, scale))


def _launch_bwd(kernel, instance, q, k, v, do, lse, scale, q_offset,
                kv_offset, causal, window, *, delta=None, o=None,
                dlse=None) -> list:
    """Launch K2 (``kernel`` "dq") or K3 ("dkv") of ``instance`` on the
    current stream. K3 and the mma K2 read ``delta`` and return ``[dk,
    dv]`` and ``[dq]``; the sm90 K2 reads ``o`` and ``dlse`` (None: no lse
    cotangent) instead and returns ``[dq, delta]``, delta computed in the
    kernel. Raises on any operand the kernels do not take or a refused
    launch."""
    fused = kernel == "dq" and instance == "sm90"
    rows = (q, k, v, do, o) if fused else (q, k, v, do)
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in rows):
        raise TypeError(f"flash backward kernels take bf16 or float32 "
                        f"q/k/v/dO{'/O' if fused else ''} of one type, got "
                        f"{[x.dtype for x in rows]}")
    stats = (lse, dlse) if fused else (lse, delta)
    if not all(x.device == q.device for x in rows + stats if x is not None):
        raise ValueError("flash backward operands must be on one device")
    b, tq, h, d = q.shape
    _instance(q.dtype, d)  # raises for a head_dim no kernel takes
    if any(x.shape != q.shape for x in rows[3:]):
        raise ValueError(f"dO and O must be shaped like q {tuple(q.shape)}")
    if any(x is not None and x.shape != (b, h, tq) for x in stats):
        raise ValueError(f"lse, delta and dlse must be [B, H, Tq] = "
                         f"{(b, h, tq)}")
    rows = [_kernel_operand(x) for x in rows]
    stats = [None if x is None else x.float().contiguous() for x in stats]
    strides = (ctypes.c_longlong * (3 * len(rows)))(
        *(st for x in rows for st in x.stride()[:3]))
    outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for x in (rows[:1] if kernel == "dq" else rows[1:3])]
    delta_out = [torch.empty((b, h, tq), dtype=torch.float32,
                             device=q.device)] if fused else []
    # pointers: q, k, v, dO, lse, then delta (K3, mma K2) or O and dlse
    # (sm90 K2), then the outputs
    ptrs = [x.data_ptr() for x in rows[:4]] + [stats[0].data_ptr()]
    ptrs += [rows[4].data_ptr()] if fused else []
    ptrs.append(None if stats[1] is None else stats[1].data_ptr())
    ptrs += [x.data_ptr() for x in outs + delta_out]
    from kubegpu_tpu_torch.workload.kernels import _build

    lib, symbol = _LIBS[instance][kernel]
    fn = getattr(_build.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int64] * (3 * len(outs)) + [ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, _DTYPES[q.dtype], b, h, tq, k.shape[1], d, strides,
                 *(st for x in outs for st in x.stride()[:3]), float(scale),
                 int(q_offset), int(kv_offset), int(bool(causal)),
                 int(window), stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    return outs + delta_out


def flash_bwd_dq(q, k, v, o, do, lse, dlse, scale, *, q_offset=0,
                 kv_offset=0, causal=True, window=0, instance=None):
    """K2: ``(dq, delta)`` from q, k, v, O, dO, lse and the lse cotangent
    ``dlse`` (None: none); ``delta = rowsum(dO * O) - dlse``, ``[B, H, Tq]``
    float32, is what K3 reads. The sm90 instance computes delta inside the
    kernel; the mma instance and CPU tensors take `_delta` first. CUDA
    tensors launch the kernel (``flash_bwd_dq.launches`` counts it) or
    raise; CPU tensors take the plain version. ``instance`` None takes
    `_instance`'s choice; "mma" at bf16 head_dim 64/128 runs the previous
    design (only ``chip_smoke.py`` asks for it, to time it)."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    if q.device.type == "cpu":
        delta = _delta(o, do, dlse)
        _, ds = _p_ds(q, k, v, lse, do, delta, scale, **kw)
        return _dq_plain(q, k, ds, scale), delta
    _check_device(q)
    instance = instance or _instance(q.dtype, q.shape[-1])
    if instance == "sm90":
        dq, delta = _launch_bwd("dq", instance, q, k, v, do, lse, scale,
                                o=o, dlse=dlse, **kw)
    else:
        delta = _delta(o, do, dlse)
        (dq,) = _launch_bwd("dq", instance, q, k, v, do, lse, scale,
                            delta=delta, **kw)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_by_instance[instance] += 1
    return dq, delta


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_by_instance = {"sm90": 0, "mma": 0}


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, *, q_offset=0,
                  kv_offset=0, causal=True, window=0, instance=None):
    """K3: ``(dk, dv)`` from q, k, v, dO, lse and delta. CUDA tensors
    launch the kernel (``flash_bwd_dkv.launches`` counts it) or raise; CPU
    tensors take the plain version. ``instance`` None takes `_instance`'s
    choice; "mma" at bf16 head_dim 64/128 runs the previous design (only
    ``chip_smoke.py`` asks for it, to time it)."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    if q.device.type == "cpu":
        p, ds = _p_ds(q, k, v, lse, do, delta, scale, **kw)
        return _dkv_plain(q, k, v, do, p, ds, scale)
    _check_device(q)
    instance = instance or _instance(q.dtype, q.shape[-1])
    dk, dv = _launch_bwd("dkv", instance, q, k, v, do, lse, scale,
                         delta=delta, **kw)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.launches_by_instance[instance] += 1
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_by_instance = {"sm90": 0, "mma": 0}


def flash_attention_bwd(q, k, v, o, lse, do, dlse, scale, *, q_offset=0,
                        kv_offset=0, causal=True, window=0):
    """``(dq, dk, dv)`` of flash attention: K2, which also gives the row
    term delta (in the sm90 kernel, else by `_delta`), then K3 on that
    delta, through their wrappers, which take the plain version on CPU
    tensors."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, dlse, scale, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2+K3 backward (the plain versions on CPU tensors).
    Saves ``(q, k, v, o, lse)``; no gradient for scale, offsets or mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, q_offset, kv_offset, causal, window):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, scale, q_offset=q_offset,
                                           kv_offset=kv_offset,
                                           causal=causal, window=window)
        else:
            o, lse = _launch(q, k, v, scale, q_offset, kv_offset, causal,
                             window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (scale, q_offset, kv_offset, causal, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, q_offset, kv_offset, causal, window = ctx.mask
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, dlse, scale, q_offset=q_offset,
            kv_offset=kv_offset, causal=causal, window=window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(q, k, v, scale, *, q_offset=0, kv_offset=0,
                             causal=True, block_q=None, block_k=None,
                             window=0):
    """Flash attention returning ``(out, lse)``.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]. ``lse`` is [B, H, Tq] float32,
    the log-sum-exp of each row's visible scores (`merge_partials` folds
    partial results with it). Offsets place the blocks at global
    positions ``offset + index``; ``window`` > 0 keeps each row to the
    newest ``window`` keys. Explicit ``block_q``/``block_k`` must divide
    the lengths, as in the reference; the CUDA kernel's own tiles take
    any ``Tq, Tk >= 1``. Differentiable in ``q``, ``k`` and ``v``,
    through both outputs."""
    tq, tk = q.shape[1], k.shape[1]
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if tq < 1 or tk < 1:
        raise ValueError(f"sequence lengths must be >= 1, got ({tq}, {tk})")
    if (block_q and tq % block_q) or (block_k and tk % block_k):
        raise ValueError(f"seq lens ({tq}, {tk}) not divisible by blocks "
                         f"({block_q}, {block_k})")
    _check_device(q)
    return _FlashAttention.apply(q, k, v, float(scale), int(q_offset),
                                 int(kv_offset), bool(causal), int(window))


flash_attention_with_lse.launches = 0
flash_attention_with_lse.launches_by_instance = {"sm90": 0, "mma": 0}


def flash_attention(q, k, v, scale, **kw):
    """Flash attention: [B, T, H, D] in, [B, T, H, D] out."""
    return flash_attention_with_lse(q, k, v, scale, **kw)[0]


def merge_partials(o1, lse1, o2, lse2):
    """Combine attention over two disjoint K/V sets from their ``(o,
    lse)`` partials: o = softmax-weighted mix, lse = log(exp(lse1) +
    exp(lse2)). o: [B, T, H, D]; lse: [B, H, T]."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    lse = m + torch.log(w1 + w2)

    def wgt(w):  # [B,H,T] -> [B,T,H,1]
        return w.transpose(1, 2)[..., None]

    o = (o1.float() * wgt(w1) + o2.float() * wgt(w2)) \
        / wgt(w1 + w2).clamp_min(1e-30)
    return o.to(o1.dtype), lse
