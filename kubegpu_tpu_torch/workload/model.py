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
rematerialisation, ``remat="none"`` (keep every activation) or ``"full"``
(keep each layer's input and recompute the layer in the backward pass,
through ``torch.utils.checkpoint``). Gradients of the flash kernel are its
own backward kernels (`kernels.flash`).

Single device, eager. Mixture-of-experts layers and sequence parallelism
over a mesh belong to later slices and raise `NotImplementedError`, as
does ``remat="dots"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch._device import resolve_device


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
    # Sequence-parallel strategy over a mesh: kept for config parity; any
    # mesh raises in this slice.
    seq_impl: str = "ring"
    n_experts: int = 0
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    # Rematerialisation per layer in training: "none" keeps every
    # activation, "full" recomputes each layer in the backward pass;
    # "dots" (keep matmul outputs and the flash residuals) raises.
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


def _check_in_slice(cfg: TransformerConfig, mesh=None) -> None:
    """Refuse what later slices of the port bring."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts layers come with the multi-GPU slice "
            "(slice 6)")
    if mesh is not None:
        raise NotImplementedError(
            "meshes and sequence parallelism (ring, Ulysses) come with the "
            "multi-GPU slice (slice 6)")


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """Parameter dict with the reference's names and ``(in, out)`` shapes,
    drawn from ``generator`` on the generator's device. The numbers differ
    from ``jax.random``'s; tests carry JAX parameters across with
    `params_from_jax` instead."""
    _check_in_slice(cfg)
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

    layers = [{"ln1": ones(), "wq": dense((d, h)), "wk": dense((d, kv)),
               "wv": dense((d, kv)), "wo": dense((h, d)), "ln2": ones(),
               "w_up": dense((d, f)), "w_gate": dense((d, f)),
               "w_down": dense((f, d))} for _ in range(cfg.n_layers)]
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


def _resolve_attn_impl(cfg: TransformerConfig, seq_len: int,
                       device: torch.device) -> str:
    """"auto" is the flash kernel on CUDA tensors when the sequence is a
    multiple of 128, else the plain attention."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    return "flash" if device.type == "cuda" and seq_len % 128 == 0 \
        else "xla"


def make_forward_with_aux(cfg: TransformerConfig, mesh=None):
    """Build ``forward(params, tokens) -> (logits, aux_loss)``; ``aux_loss``
    is 0.0 (no mixture-of-experts in this slice)."""
    _check_in_slice(cfg, mesh)
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat mode {cfg.remat!r}")
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (a selective-checkpoint policy that keeps matmul "
            "outputs and the flash residuals) comes with slice 3; use "
            "'none' or 'full'")
    scale = cfg.head_dim ** -0.5

    def attention_fn(t: int, device: torch.device):
        impl = _resolve_attn_impl(cfg, t, device)
        if impl == "flash":
            from kubegpu_tpu_torch.workload.kernels.flash import \
                flash_attention

            return lambda q, k, v: flash_attention(
                q, k, v, scale, window=cfg.attn_window)
        if impl != "xla":
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        return lambda q, k, v: _causal_attention(q, k, v, scale,
                                                 window=cfg.attn_window)

    def block(layer, x, positions, attend):
        dt = cfg.compute_dtype()
        b, t = x.shape[:2]
        h = _rmsnorm(x, layer["ln1"])
        q = (h @ layer["wq"].to(dt)).reshape(b, t, cfg.n_heads, cfg.head_dim)
        k = (h @ layer["wk"].to(dt)).reshape(b, t, cfg.kv_heads,
                                             cfg.head_dim)
        v = (h @ layer["wv"].to(dt)).reshape(b, t, cfg.kv_heads,
                                             cfg.head_dim)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        k, v = _expand_kv(cfg, k, v)
        x = x + attend(q, k, v).reshape(b, t, -1) @ layer["wo"].to(dt)
        h = _rmsnorm(x, layer["ln2"])
        up = h @ layer["w_up"].to(dt)
        gate = F.silu(h @ layer["w_gate"].to(dt))
        return x + (up * gate) @ layer["w_down"].to(dt)

    def forward(params, tokens):
        dt = cfg.compute_dtype()
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, t = tokens.shape
        x = params["embed"].to(dt)[tokens]
        positions = torch.arange(t, device=dev).expand(b, t)
        attend = attention_fn(t, dev)
        for layer in params["layers"]:
            if cfg.remat == "full" and torch.is_grad_enabled():
                x = checkpoint(block, layer, x, positions, attend,
                               use_reentrant=False)
            else:
                x = block(layer, x, positions, attend)
        x = _rmsnorm(x, params["final_norm"])
        logits = x @ params["unembed"].to(dt)
        return logits.float(), torch.zeros((), device=dev)

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
    times the aux loss."""
    fwd = make_forward_with_aux(cfg, mesh)

    def loss_fn(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
        logits, aux = fwd(params, tokens[:, :-1])
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              tokens[:, 1:].reshape(-1))
        return nll + cfg.moe_aux_weight * aux

    return loss_fn
