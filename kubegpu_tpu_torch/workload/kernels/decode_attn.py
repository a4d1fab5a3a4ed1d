"""Decode attention: one query token per row against the KV cache.

K4, ``csrc/decode_attn_sm90.cu``, is the serving decode's attention over
the bf16 cache ``init_cache`` lays out (``[B, S_max, Hkv, D]``): each row
reads only its live positions ``[max(0, pos - window + 1), pos]``, in
bf16, once for all the query heads of a kv head, split over the key axis
and merged by a second small kernel. It replaces no TPU kernel (the JAX
package's decode attention is plain ``jnp``).

Beside it, `decode_attention_plain` is the arithmetic of the decode step's
plain attention at T = 1 (`grouped_attention` over the whole pool cast to
float32, masked by position). `decode_attention` takes the plain version
for a CPU tensor and launches the kernel for a CUDA one, or raises on an
operand the kernel does not take; there is no fallback between the two.
``decode_attention.launches`` counts kernel launches (one per call: the
split kernel and the merge), as does ``decode_attn_kernel_calls_total``
(`metrics.DECODE_ATTN_KERNEL_CALLS`), so a serving run shows that its
decode took the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubegpu_tpu_torch import metrics

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per kv head: the rows of one mma tile
TILE = 16       # keys per warp tile; a split is a multiple of it
# keys per block of the split kernel: the fastest of 64-1024 at every
# serving cell's shape on the H100 (chip_smoke's decode_attn sweep)
SPLIT_LEN = 256


def grouped_attention(q, ck, cv, mask, scale: float):
    """Attention of ``q [B, T, Hq, D]`` over a float32 cache ``ck, cv [B,
    S, Hkv, D]`` where ``mask [B, T, S]`` is true: float32 products of the
    values (float32 accumulation, as the reference), the softmax in float32
    and its probabilities rounded to q's type before the PV product.
    Returns float32 ``[B, T, Hq, D]``. With GQA the query heads are grouped
    against the narrow cache (g = kv head, r = query head in the group), so
    the full-width K/V is never materialized."""
    b, t, hq, d = q.shape
    hk, dt = ck.shape[2], q.dtype
    if hk != hq:
        rep = hq // hk
        qg = q.reshape(b, t, hk, rep, d)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck) * scale
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bgrqk,bkgd->bqgrd", p.to(dt).float(), cv)
        return attn.reshape(b, t, hq, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck) * scale
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), cv)


def _positions(pos, b: int, device):
    """``pos`` (an int, or a ``[B]`` tensor) as int64 ``[B]`` on
    ``device``."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.long)
    return torch.full((b,), int(pos), device=device, dtype=torch.long)


def decode_attention_plain(q, k_cache, v_cache, pos, scale: float,
                           window: int = 0):
    """The plain version: ``q [B, 1, Hq, D]`` at positions ``pos`` against
    the whole cache cast to float32, positions past ``pos`` (and, with a
    window, older than its newest ``window``) masked. Returns
    ``[B, 1, Hq, D]`` in q's type."""
    b, s_max = q.shape[0], k_cache.shape[1]
    q_pos = _positions(pos, b, q.device)[:, None, None]         # [B, 1, 1]
    kv_pos = torch.arange(s_max, device=q.device)[None, None, :]
    mask = kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    return grouped_attention(q, k_cache.float(), v_cache.float(), mask,
                             scale).to(q.dtype)


def takes(n_heads: int, k_cache) -> bool:
    """Whether the kernel takes ``n_heads`` query heads over ``k_cache``:
    a bf16 cache on CUDA at a head_dim it was built for, each kv head
    shared by at most `MAX_GROUP` query heads."""
    kv = k_cache.shape[2]
    return (k_cache.device.type == "cuda"
            and k_cache.dtype == torch.bfloat16
            and k_cache.shape[-1] in HEAD_DIMS
            and n_heads % kv == 0 and n_heads // kv <= MAX_GROUP)


def _check(q, k_cache, v_cache) -> None:
    """Raise on anything the kernel does not take."""
    if not (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise TypeError(f"decode attention kernel takes bf16 q and cache, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the cache must be on one device")
    b, t, hq, d = q.shape
    if t != 1 or k_cache.shape != v_cache.shape or k_cache.dim() != 4 \
            or k_cache.shape[0] != b or k_cache.shape[-1] != d:
        raise ValueError(f"decode attention takes q [B, 1, Hq, D] and a "
                         f"cache [B, S, Hkv, D], got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if not takes(hq, k_cache):
        raise ValueError(f"decode attention kernel takes head_dim in "
                         f"{HEAD_DIMS} and up to {MAX_GROUP} query heads a "
                         f"kv head, got {hq} over {k_cache.shape[2]} of {d}")
    for x in (k_cache, v_cache):
        # cp.async stages 16-byte chunks of each kv head's row in place:
        # the pool is never copied
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                s <= 0 or s % 8 for s in x.stride()[:3]):
            raise ValueError(f"decode attention needs a cache with unit "
                             f"stride in D, other strides multiples of 8 "
                             f"and a 16-byte aligned base, got strides "
                             f"{x.stride()}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """K4's C entry point, built and loaded on first use."""
    from kubegpu_tpu_torch.workload.kernels import _build

    fn = _build.load("decode_attn_sm90").kgt_decode_attn
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_int64] * 8 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    return fn


def decode_attention(q, k_cache, v_cache, pos, scale: float,
                     window: int = 0):
    """Attention of one query token per row, ``q [B, 1, Hq, D]`` at
    positions ``pos`` (an int, or ``[B]`` int64 on q's device), over the
    cache ``k_cache, v_cache [B, S_max, Hkv, D]`` that already holds each
    row's K/V up to ``pos``; ``window`` > 0 keeps the newest ``window``
    positions. Returns ``[B, 1, Hq, D]`` in q's type. CPU tensors take
    `decode_attention_plain`; CUDA tensors launch K4 or raise."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, scale,
                                      window)
    _check(q, k_cache, v_cache)
    b, _, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    pos = _positions(pos, b, q.device).contiguous()
    if q.stride(-1) != 1 or q.data_ptr() % 4 or q.stride(0) % 2 \
            or q.stride(2) % 2:
        q = q.contiguous()           # 4-byte loads of q's head rows
    length = SPLIT_LEN
    n_split = -(-s_max // length)
    part_o = torch.empty((b, hq, n_split, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32,
                          device=q.device)
    o = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            o.data_ptr(), b, hq, hkv, s_max, d, length, n_split, int(window),
            q.stride(0), q.stride(2), *k_cache.stride()[:3],
            *v_cache.stride()[:3], float(scale), stream)
    if err:
        raise RuntimeError(f"kgt_decode_attn kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    metrics.DECODE_ATTN_KERNEL_CALLS.inc()
    return o


decode_attention.launches = 0
