"""Flagship model: the decoder-only transformer of
``kubegpu_tpu/workload/model.py``, in PyTorch.

The same configuration, the same parameter layout (names and ``(in,
out)`` shapes) and the same cast points as the reference, so a JAX
parameter tree carried across with `params_from_jax` computes the same
logits:

- float32 parameters, activations in the compute dtype (bf16 by default);
- RMSNorm takes its variance in float32, then casts back;
- RoPE's cos/sin are cast to the activation dtype;
- attention takes bf16 operands with float32 accumulation: the plain path
  (`_causal_attention`) or the hand-written CUDA flash kernel
  (`kernels.flash`), chosen by ``attn_impl``;
- logits leave as float32.

Training: `make_loss_fn` (next-token cross entropy) and per-layer
rematerialisation through ``torch.utils.checkpoint``, one region a layer:
``remat="none"`` keeps every activation; ``"full"`` keeps each layer's
input and recomputes the layer in the backward pass; ``"dots"`` is the
reference's policy (``kubegpu_tpu/workload/model.py:295-306``) as a
selective checkpoint: the outputs of the products with a weight
(``aten.mm``; ``x @ W`` with a 2-D weight reaches it) and of the flash
forward operator (``torch.ops.kgt.flash_fwd``: ``attn_out`` and
``attn_lse``) are kept, everything else is recomputed, so K1 never runs
again in the backward. The reference also keeps the plain ("xla")
attention's output by name; here nothing of it is kept, because the
recompute is a replay of the layer in order and must run the attention's
products (which have batch dimensions, so the policy recomputes them in
the reference too) to rebuild the probabilities their backward needs:
keeping the output as well would add memory and save no work. Gradients
of the flash kernel are its own backward kernels (`kernels.flash`).

Mixture-of-experts layers (``n_experts > 0``) replace each layer's dense
FFN with `moe.moe_ffn`, dense over experts; the forward returns their
load-balancing term beside the logits.

Over a mesh (`spmd.make_mesh`, reference ``model.py:210-329``) every rank
runs the same eager program on its own shards (`spmd.shard_params`) and
calls the collectives GSPMD would insert:

- tensor parallelism over ``model``: each rank holds ``1/tp`` of the
  ``wq``/``wk``/``wv`` columns (``H/tp`` heads when ``tp`` divides the
  head counts) and ``d_ff/tp`` FFN columns (or ``E/tp`` experts); a
  column-parallel input passes `spmd.copy_to` (identity forward,
  all-reduce backward), a row-parallel output (``wo``, ``w_down``)
  `spmd.reduce_from` (all-reduce forward, identity backward); the
  vocabulary-split logits are gathered over ``model`` before the loss;
- where ``tp`` does not divide ``n_heads`` or ``kv_heads``, a rank's
  columns cut heads in the middle, as GSPMD cuts them in the reference:
  it gathers the projections it needs over ``model``
  (`spmd.gather_columns`, whose backward sums the ranks' partial
  cotangents), applies RoPE to whole heads, attends the heads its columns
  overlap (`head_span`, `span_attention`) and hands its ``wo`` rows the
  columns of the output they take;
- sequence parallelism over ``seq``: each rank takes its ``T/sp`` block of
  the tokens at global positions, and attention runs as ring attention
  (`ring`) or Ulysses (`ulysses`) by ``seq_impl`` when ``sp > 1``;
- the loss is a token mean over the global batch (the local sum over the
  global count, summed over ``data`` and ``seq``), and the MoE aux loss a
  product of global means.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from kubegpu_tpu_torch._device import resolve_device
from kubegpu_tpu_torch.workload import spmd
from kubegpu_tpu_torch.workload.kernels.flash import flash_attention
from kubegpu_tpu_torch.workload.moe import init_moe_params, moe_ffn
from kubegpu_tpu_torch.workload.ring import make_sharded_ring_attention
from kubegpu_tpu_torch.workload.ulysses import make_sharded_ulysses_attention

# remat "dots": the operators whose outputs the checkpoint keeps
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.kgt.flash_fwd.default]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 384
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # "xla" = the plain attention (full score matrix; the name is the
    # reference's), "flash" = the flash kernel (kernels.flash), "auto" =
    # flash on CUDA tensors when the sequence is a multiple of 128.
    attn_impl: str = "auto"
    # Sequence-parallel strategy when the mesh's seq axis is > 1: "ring"
    # (K/V rotate around the axis, `ring.py`) or "ulysses" (an all-to-all
    # head/sequence reshard, `ulysses.py`). Both are exact.
    seq_impl: str = "ring"
    n_experts: int = 0
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    # Rematerialisation per layer in training: "none" keeps every
    # activation, "full" recomputes each layer in the backward pass,
    # "dots" keeps the matmul outputs and the flash residuals.
    remat: str = "none"
    # Sliding window: each position attends the newest ``attn_window``
    # positions (0 = full causal).
    attn_window: int = 0
    # Grouped-query attention: 0 = MHA; a divisor of n_heads shares each
    # K/V head across n_heads/n_kv_heads query heads.
    n_kv_heads: int = 0

    def __post_init__(self):
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}")
        if self.n_experts > 0 and not 1 <= self.moe_top_k <= self.n_experts:
            raise ValueError(
                f"moe_top_k {self.moe_top_k} must be in "
                f"[1, n_experts={self.n_experts}]")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError(
                f"n_kv_heads {kv} must divide n_heads {self.n_heads}")
        return kv

    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """Parameter dict with the reference's names and ``(in, out)`` shapes,
    drawn from ``generator`` on the generator's device. The numbers differ
    from ``jax.random``'s; tests carry JAX parameters across with
    `params_from_jax` instead. With ``n_experts > 0`` a layer's dense FFN
    (``w_up``, ``w_gate``, ``w_down``) gives way to ``moe``
    (`moe.init_moe_params`)."""
    dev = generator.device
    d, h, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    kv = cfg.kv_heads * cfg.head_dim

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    def dense(shape):
        return normal(shape, shape[0] ** -0.5)

    def ones():
        return torch.ones(d, device=dev, dtype=torch.float32)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {"ln1": ones(), "wq": dense((d, h)), "wk": dense((d, kv)),
                 "wv": dense((d, kv)), "wo": dense((h, d)), "ln2": ones()}
        if cfg.n_experts > 0:
            layer["moe"] = init_moe_params(generator, d, f, cfg.n_experts)
        else:
            layer.update(w_up=dense((d, f)), w_gate=dense((d, f)),
                         w_down=dense((f, d)))
        layers.append(layer)
    return {"embed": normal((cfg.vocab, d), 0.02),
            "unembed": dense((d, cfg.vocab)),
            "final_norm": ones(),
            "layers": layers}


def params_from_jax(tree, device=None) -> dict:
    """Carry a JAX parameter tree (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) across exactly: the same keys,
    the same float32 values, on ``device`` (``cuda`` unless asked)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def _rmsnorm(x, gain):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * gain.to(x.dtype)


def _rope(x, positions, theta: float):
    """Rotary embedding; ``positions [B, T]`` are global positions."""
    half = x.shape[-1] // 2
    # log(theta) in float32 as the reference (a fill, not a host copy)
    log_theta = torch.full((), theta, dtype=torch.float32,
                           device=x.device).log()
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs      # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _causal_attention(q, k, v, scale: float, window: int = 0):
    """The plain single-device causal attention ([B,T,H,D] layout);
    ``window`` > 0 = sliding window. Operands are upcast to float32 for
    the products, which is float32 accumulation of the (exact) bf16
    products, as the reference's ``preferred_element_type=f32``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _expand_kv(cfg: TransformerConfig, k, v):
    """GQA: repeat each K/V head across its query group so attention sees
    plain MHA tensors; parameters and the decode cache stay narrow."""
    if cfg.kv_heads == cfg.n_heads:
        return k, v
    rep = cfg.n_heads // cfg.kv_heads
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def whole_heads(cfg: TransformerConfig, tp: int) -> bool:
    """Whether ``tp`` divides both head counts, so each rank holds whole
    heads and attends its own; else its columns cut heads
    (`span_attention`)."""
    return not (cfg.n_heads % tp or cfg.kv_heads % tp)


def head_span(cfg: TransformerConfig, tp: int, r: int) -> tuple:
    """Rank ``r``'s part of the attention under tensor parallelism over
    ``tp``: ``(c0, c1, lo, hi)``, its columns ``[c0, c1)`` of the
    ``n_heads·head_dim`` attention width (``C = n_heads·head_dim / tp``
    of them: its ``wq`` columns and ``wo`` rows) and the heads ``[lo,
    hi)`` those columns overlap. When ``tp`` does not divide ``n_heads``
    the spans of neighbouring ranks share the head they cut."""
    c = cfg.n_heads * cfg.head_dim // tp
    c0, c1 = r * c, (r + 1) * c
    return c0, c1, c0 // cfg.head_dim, -(-c1 // cfg.head_dim)


def _span_kv(cfg: TransformerConfig, k, v, lo: int, hi: int):
    """The K/V heads of query heads ``[lo, hi)`` from every kv head: query
    head ``j`` reads kv head ``j // (n_heads / kv_heads)``, counted over
    the whole model, not within a rank."""
    rep = cfg.n_heads // cfg.kv_heads
    if rep == 1:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.arange(lo, hi, device=k.device) // rep
    return k.index_select(2, idx), v.index_select(2, idx)


def gather_span(cfg: TransformerConfig, mesh, q, k, v) -> tuple:
    """A rank's projections ``q [B, T, C]``, ``k, v [B, T, C_kv]`` (its
    columns) as `span_attention` takes them: its query heads ``[lo, hi)``
    (gathered over ``model`` where ``tp`` does not divide ``n_heads``, so a
    cut head is whole again; its own ``n_heads/tp`` heads otherwise) and
    every kv head, gathered, as ``[B, T, heads, D]``. RoPE rotates the two
    halves of a head against each other, so it comes after."""
    tp = spmd.axis_size(mesh, spmd.AXIS_MODEL)
    b, t, d = *q.shape[:2], cfg.head_dim
    if cfg.n_heads % tp:
        lo, hi = head_span(cfg, tp, spmd.axis_rank(mesh, spmd.AXIS_MODEL))[2:]
        q = spmd.gather_columns(mesh, q).reshape(b, t, cfg.n_heads,
                                                 d)[:, :, lo:hi]
    else:
        q = q.reshape(b, t, cfg.n_heads // tp, d)
    k, v = (spmd.gather_columns(mesh, x).reshape(b, t, cfg.kv_heads, d)
            for x in (k, v))
    return q, k, v


def span_attention(cfg: TransformerConfig, q, k, v, tp: int, r: int,
                   attend):
    """Rank ``r``'s attention under tensor parallelism over ``tp`` when
    ``tp`` does not divide ``n_heads`` or ``kv_heads``: ``q [B, T, hi -
    lo, D]`` its query heads ``[lo, hi)`` (`head_span`), ``k, v [B, T,
    kv_heads, D]`` every kv head, all RoPE'd; ``attend(q, k, v)`` the
    attention over heads (flash, plain, ring or Ulysses). Returns ``[B,
    T, C]``, the columns ``[c0, c1)`` of the attention output, which the
    rank's ``wo`` rows take."""
    c0, c1, lo, hi = head_span(cfg, tp, r)
    out = attend(q, *_span_kv(cfg, k, v, lo, hi))
    off = c0 - lo * cfg.head_dim
    return out.reshape(*q.shape[:2], -1)[..., off:off + c1 - c0]


def tp_attention_in_process(cfg: TransformerConfig, q, k, v, wo, tp: int,
                            attend):
    """Every rank of a tensor-parallel group of ``tp`` in turn, in one
    process: the sum over ``r`` of rank ``r``'s `span_attention` times its
    ``wo`` rows ``[c0, c1)``, which `spmd.reduce_from` sums over
    ``model`` in the sharded block. ``q [B, T, n_heads, D]``, ``k, v [B,
    T, kv_heads, D]`` whole and RoPE'd, ``wo [n_heads·D, d]``. Autograd
    adds the ranks' cotangents of q, k and v before each rank's slice is
    taken, as `spmd.gather_columns`' backward sums them over ``model``.
    ``chip_smoke.py`` holds the kernels' head spans on one card with it."""
    total = None
    for r in range(tp):
        c0, c1, lo, hi = head_span(cfg, tp, r)
        part = span_attention(cfg, q[:, :, lo:hi], k, v, tp, r,
                              attend) @ wo[c0:c1]
        total = part if total is None else total + part
    return total


def _ffn(layer: dict, h: torch.Tensor, dt: torch.dtype,
         cfg: TransformerConfig, mesh=None) -> tuple:
    """A layer's FFN on the normed ``h``: ``(out, aux)``, the SwiGLU FFN
    with aux None, or `moe.moe_ffn` when the layer holds ``moe``. Over a
    mesh the FFN is column- then row-parallel over ``model``."""
    if "moe" in layer:
        return moe_ffn(layer["moe"], h, dt, top_k=cfg.moe_top_k, mesh=mesh)
    h = spmd.copy_to(mesh, h)
    up = h @ layer["w_up"].to(dt)
    gate = F.silu(h @ layer["w_gate"].to(dt))
    return spmd.reduce_from(mesh, (up * gate) @ layer["w_down"].to(dt)), None


def _resolve_attn_impl(cfg: TransformerConfig, seq_len: int,
                       device: torch.device) -> str:
    """"auto" is the flash kernel on CUDA tensors when the sequence is a
    multiple of 128, else the plain attention."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    return "flash" if device.type == "cuda" and seq_len % 128 == 0 \
        else "xla"


def make_forward_with_aux(cfg: TransformerConfig, mesh=None):
    """Build ``forward(params, tokens) -> (logits, aux_loss)``;
    ``aux_loss`` is the mixture-of-experts load-balancing term summed over
    the layers (0.0 for dense configs).

    Over a mesh, ``params`` are this rank's shards and ``tokens [B/dp, T]``
    its ``data`` rows (`spmd.global_batch`); the logits are those of its
    ``seq`` block, ``[B/dp, T/sp, vocab]``, whole over the vocabulary."""
    if mesh is not None:
        spmd.check_mesh(mesh)
        spmd.check_tp(cfg, spmd.axis_size(mesh, spmd.AXIS_MODEL),
                      spmd.axis_size(mesh, spmd.AXIS_SEQ))
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat mode {cfg.remat!r}")
    if cfg.seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_impl {cfg.seq_impl!r}")
    # keyword arguments of each layer's checkpoint (None: no checkpoint)
    remat_kw = None if cfg.remat == "none" else {}
    if cfg.remat == "dots":
        remat_kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS_SAVED)
    scale = cfg.head_dim ** -0.5
    tp = spmd.axis_size(mesh, spmd.AXIS_MODEL)
    sp = spmd.axis_size(mesh, spmd.AXIS_SEQ)
    tp_rank = spmd.axis_rank(mesh, spmd.AXIS_MODEL)
    whole = whole_heads(cfg, tp)
    heads, kv_heads = cfg.n_heads // tp, cfg.kv_heads // tp

    def attention_fn(t: int, device: torch.device):
        """The attend callable for a global sequence of ``t``."""
        # Ulysses attends the full sequence after its all-to-all, so the
        # flash decision sees t; the ring attends blocks of t // sp
        local_t = t if cfg.seq_impl == "ulysses" else t // sp
        impl = _resolve_attn_impl(cfg, local_t, device)
        if impl not in ("flash", "xla"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        window = cfg.attn_window
        if sp > 1 and cfg.seq_impl == "ulysses":
            return make_sharded_ulysses_attention(
                mesh, scale, use_flash=impl == "flash", window=window)
        if sp > 1:
            return make_sharded_ring_attention(
                mesh, scale, use_flash=impl == "flash", window=window)
        if impl == "flash":
            return lambda q, k, v: flash_attention(q, k, v, scale,
                                                   window=window)
        return lambda q, k, v: _causal_attention(q, k, v, scale,
                                                 window=window)

    def block(layer, x, positions, attend):
        """One layer: ``(x, aux)``, aux None for a dense FFN."""
        dt = cfg.compute_dtype()
        b, t = x.shape[:2]
        h = spmd.copy_to(mesh, _rmsnorm(x, layer["ln1"]))
        q = h @ layer["wq"].to(dt)
        k, v = h @ layer["wk"].to(dt), h @ layer["wv"].to(dt)
        if whole:
            q = _rope(q.reshape(b, t, heads, cfg.head_dim), positions,
                      cfg.rope_theta)
            k = _rope(k.reshape(b, t, kv_heads, cfg.head_dim), positions,
                      cfg.rope_theta)
            k, v = _expand_kv(cfg, k, v.reshape(b, t, kv_heads,
                                                cfg.head_dim))
            attn = attend(q, k, v).reshape(b, t, -1)
        else:
            q, k, v = gather_span(cfg, mesh, q, k, v)
            attn = span_attention(
                cfg, _rope(q, positions, cfg.rope_theta),
                _rope(k, positions, cfg.rope_theta), v, tp, tp_rank, attend)
        x = x + spmd.reduce_from(mesh, attn @ layer["wo"].to(dt))
        out, aux = _ffn(layer, _rmsnorm(x, layer["ln2"]), dt, cfg, mesh)
        return x + out, aux

    def forward(params, tokens):
        dt = cfg.compute_dtype()
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, t = tokens.shape
        if t % sp:
            raise ValueError(f"sequence {t} not divisible by sp {sp}")
        t_local = t // sp
        start = spmd.axis_rank(mesh, spmd.AXIS_SEQ) * t_local
        x = params["embed"].to(dt)[tokens[:, start:start + t_local]]
        positions = (start + torch.arange(t_local, device=dev)).expand(
            b, t_local)
        attend = attention_fn(t, dev)
        aux_total = torch.zeros((), device=dev)
        for layer in params["layers"]:
            if remat_kw is not None and torch.is_grad_enabled():
                x, aux = checkpoint(block, layer, x, positions, attend,
                                    use_reentrant=False, **remat_kw)
            else:
                x, aux = block(layer, x, positions, attend)
            if aux is not None:
                aux_total = aux_total + aux
        x = spmd.copy_to(mesh, _rmsnorm(x, params["final_norm"]))
        logits = spmd.gather_last(mesh, x @ params["unembed"].to(dt))
        return logits.float(), aux_total

    return forward


def make_forward(cfg: TransformerConfig, mesh=None):
    """``forward(params, tokens) -> logits [B, T, vocab]`` in float32."""
    fwd = make_forward_with_aux(cfg, mesh)

    def forward(params, tokens):
        return fwd(params, tokens)[0]

    return forward


def make_loss_fn(cfg: TransformerConfig, mesh=None):
    """``loss_fn(params, tokens [B, T+1]) -> loss``: next-token cross
    entropy from the float32 logits, token mean, plus ``moe_aux_weight``
    times the aux loss.

    Over a mesh, ``tokens`` are this rank's ``data`` rows and the loss is
    the global one on every rank: the rank's sum over its ``seq`` block
    divided by the global token count and summed over ``data`` and ``seq``
    (identity in the backward), so each rank's backward gives its part of
    the gradient and `spmd.all_reduce_grads` sums the parts."""
    fwd = make_forward_with_aux(cfg, mesh)
    sp = spmd.axis_size(mesh, spmd.AXIS_SEQ)
    dp = spmd.axis_size(mesh, spmd.AXIS_DATA)

    def loss_fn(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
        logits, aux = fwd(params, tokens[:, :-1])
        b, t_local = logits.shape[:2]
        start = spmd.axis_rank(mesh, spmd.AXIS_SEQ) * t_local
        targets = tokens[:, 1 + start:1 + start + t_local]
        flat = logits.reshape(-1, logits.shape[-1])
        if mesh is None:
            nll = F.cross_entropy(flat, targets.reshape(-1))
        else:
            nll = spmd.reduce_from(
                mesh, F.cross_entropy(flat, targets.reshape(-1),
                                      reduction="sum"),
                (spmd.AXIS_DATA, spmd.AXIS_SEQ)) / (b * dp * t_local * sp)
        return nll + cfg.moe_aux_weight * aux

    return loss_fn
