"""Mixture-of-experts FFN with expert parallelism: the counterpart of
``kubegpu_tpu/workload/moe.py``.

Routing is top-k over a jitter-free float32 softmax gate: Switch-style
top-1 (the raw gate weight) by default, Mixtral-style top-k with the
combine weights renormalised for ``top_k > 1``. Compute is dense over
experts: every expert runs on every token and the combine weights select.

The up and gate projections are one 2-D product each, ``[B·T, d] @
[d, E·f]``, so remat "dots" (which keeps ``aten.mm`` outputs) keeps them
as the reference's policy keeps ``btd,edf->btef`` (a product with no
batch dimensions), and recomputes the expert-batched down projection and
the combine, as the reference's does.

Over a mesh the experts are split over the ``model`` axis
(`moe_pspecs`): the router is replicated, each rank runs its
``E/tp`` experts densely, weights their outputs by its columns of the
global combine weights, and an all-reduce over ``model`` sums the ranks'
parts. The aux loss is the reference's product of global means: the
per-expert fractions are averaged over ``data`` and ``seq`` before the
product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubegpu_tpu_torch.workload import spmd


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


def moe_pspecs() -> dict:
    """The expert leaves' layout (`spmd.param_pspecs`): the router
    replicated, the experts split on their leading (expert) dimension over
    ``model``: expert parallelism."""
    return {"router": None, "w_up": 0, "w_gate": 0, "w_down": 0}


def _expert_product(x, w, dt):
    """``btd,edf->btef`` as one 2-D product over ``[d, E·f]``."""
    e, d, f = w.shape
    w2 = w.to(dt).transpose(0, 1).reshape(d, e * f)
    return (x @ w2).reshape(*x.shape[:-1], e, f)


def _global_mean(x, mesh):
    """The mean of ``x [B, T, E]`` over its tokens, over the whole global
    batch: each rank's mean averaged over ``data`` and ``seq`` (every rank
    holds as many tokens)."""
    m = x.mean((0, 1))
    if mesh is None:
        return m
    axes = (spmd.AXIS_DATA, spmd.AXIS_SEQ)
    n = spmd.axis_size(mesh, axes[0]) * spmd.axis_size(mesh, axes[1])
    return spmd.reduce_from(mesh, m, axes) / n


def moe_ffn(params: dict, x, compute_dtype, top_k: int = 1,
            mesh=None) -> tuple:
    """Top-k routed SwiGLU experts on ``x [B, T, d]``; returns
    ``(out [B, T, d], aux)``.

    ``top_k == 1`` scales the output by the winner's raw gate probability
    (Switch); ``top_k > 1`` renormalises the combine weights over the
    selected experts (Mixtral). ``aux`` is the load-balancing loss
    ``E * sum(route_frac * gate_frac)``, with ``route_frac`` divided by
    ``top_k`` so the uniform ideal is 1.0 for any k. Over a mesh
    ``params`` hold this rank's experts."""
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

    # this rank's experts and their columns of the combine weights; both
    # inputs are replicated, so their gradients sum over ``model``
    e_local = params["w_up"].shape[0]
    first = spmd.axis_rank(mesh, spmd.AXIS_MODEL) * e_local
    x = spmd.copy_to(mesh, x)
    combine = spmd.copy_to(mesh, combine)[..., first:first + e_local]

    dt = compute_dtype
    up = _expert_product(x, params["w_up"], dt)
    gate = F.silu(_expert_product(x, params["w_gate"], dt))
    expert_out = torch.einsum("btef,efd->bted", up * gate,
                              params["w_down"].to(dt))
    out = spmd.reduce_from(
        mesh, torch.einsum("bted,bte->btd", expert_out, combine.to(dt)))

    dispatch = hot.sum(2)                                        # [B,T,E]
    route_frac = _global_mean(dispatch, mesh) / top_k
    gate_frac = _global_mean(gates, mesh)
    aux = n_experts * (route_frac * gate_frac).sum()
    return out, aux
