"""Mixture-of-experts FFN on one device: the counterpart of
``kubegpu_tpu/workload/moe.py`` without its mesh part (``moe_pspecs``,
expert parallelism over the ``model`` axis, comes with the multi-GPU
slice).

Routing is top-k over a jitter-free float32 softmax gate: Switch-style
top-1 (the raw gate weight) by default, Mixtral-style top-k with the
combine weights renormalised for ``top_k > 1``. Compute is dense over
experts: every expert runs on every token and the combine weights select.

The up and gate projections are one 2-D product each, ``[B·T, d] @
[d, E·f]``, so remat "dots" (which keeps ``aten.mm`` outputs) keeps them
as the reference's policy keeps ``btd,edf->btef`` (a product with no
batch dimensions), and recomputes the expert-batched down projection and
the combine, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int) -> dict:
    """``router [d, E]``, ``w_up``/``w_gate [E, d, f]`` (normal times
    d^-0.5) and ``w_down [E, f, d]`` (times f^-0.5), float32, drawn from
    ``generator`` on its device."""
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    e, d, f = n_experts, d_model, d_ff
    return {"router": normal((d, e), d ** -0.5),
            "w_up": normal((e, d, f), d ** -0.5),
            "w_gate": normal((e, d, f), d ** -0.5),
            "w_down": normal((e, f, d), f ** -0.5)}


def _expert_product(x, w, dt):
    """``btd,edf->btef`` as one 2-D product over ``[d, E·f]``."""
    e, d, f = w.shape
    w2 = w.to(dt).transpose(0, 1).reshape(d, e * f)
    return (x @ w2).reshape(*x.shape[:-1], e, f)


def moe_ffn(params: dict, x, compute_dtype, top_k: int = 1) -> tuple:
    """Top-k routed SwiGLU experts on ``x [B, T, d]``; returns
    ``(out [B, T, d], aux)``.

    ``top_k == 1`` scales the output by the winner's raw gate probability
    (Switch); ``top_k > 1`` renormalises the combine weights over the
    selected experts (Mixtral). ``aux`` is the load-balancing loss
    ``E * sum(route_frac * gate_frac)``, with ``route_frac`` divided by
    ``top_k`` so the uniform ideal is 1.0 for any k."""
    gates = torch.softmax(x.float() @ params["router"], dim=-1)  # [B,T,E]
    n_experts = gates.shape[-1]
    if not 1 <= top_k <= n_experts:
        raise ValueError(
            f"top_k {top_k} must be in [1, n_experts={n_experts}]")
    vals, idx = torch.topk(gates, top_k, dim=-1)                 # [B,T,K]
    if top_k > 1:
        vals = vals / vals.sum(-1, keepdim=True)
    hot = F.one_hot(idx, n_experts).to(gates.dtype)              # [B,T,K,E]
    combine = (hot * vals[..., None]).sum(2)                     # [B,T,E]

    dt = compute_dtype
    up = _expert_product(x, params["w_up"], dt)
    gate = F.silu(_expert_product(x, params["w_gate"], dt))
    expert_out = torch.einsum("btef,efd->bted", up * gate,
                              params["w_down"].to(dt))
    out = torch.einsum("bted,bte->btd", expert_out, combine.to(dt))

    dispatch = hot.sum(2)                                        # [B,T,E]
    route_frac = dispatch.mean((0, 1)) / top_k
    gate_frac = gates.mean((0, 1))
    aux = n_experts * (route_frac * gate_frac).sum()
    return out, aux
