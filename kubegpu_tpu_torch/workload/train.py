"""Single-device training step: the counterpart of
``kubegpu_tpu/workload/train.py``'s ``mesh=None`` path.

The reference jits fwd + bwd + optimizer and donates params and optimizer
state so XLA updates them in place. Here the step runs eagerly and updates
the parameter tensors in place through a ``torch.optim.AdamW`` (the same
update as ``optax.adamw``: bias-corrected moments, decoupled weight decay
on every leaf). The optimizer object is the optimizer state. Meshes belong
to the multi-GPU slice (slice 6) and raise.
"""

from __future__ import annotations

import functools

import torch

from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                              _check_in_slice, init_params,
                                              make_loss_fn)


def default_optimizer(lr: float = 3e-4):
    """A factory ``optimizer(leaves) -> torch.optim.AdamW`` with the
    reference's ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01)``
    (eps 1e-8)."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.01)


def param_leaves(params) -> list:
    """The parameter tensors of a parameter dict, in a fixed order."""
    if isinstance(params, dict):
        return [x for key in params for x in param_leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [x for item in params for x in param_leaves(item)]
    return [params]


def init_sharded(generator: torch.Generator, cfg: TransformerConfig,
                 mesh=None, optimizer=None, init_optimizer: bool = True):
    """``(params, opt_state, optimizer)`` on the generator's device: float32
    leaves that require grad, and the optimizer built over them
    (``opt_state=None`` with ``init_optimizer=False``). Any mesh raises."""
    _check_in_slice(cfg, mesh)
    optimizer = optimizer or default_optimizer()
    params = init_params(generator, cfg)
    leaves = param_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    return params, optimizer(leaves) if init_optimizer else None, optimizer


def make_train_step(cfg: TransformerConfig, mesh=None, optimizer=None,
                    accum_steps: int = 1):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``.

    Updates ``params`` in place and returns the same dict; ``opt_state``
    is the optimizer object (None builds one with ``optimizer`` on the
    first call). ``accum_steps`` > 1 splits the batch into that many equal
    microbatches, averages their gradients and applies one update; the
    loss is the mean of the microbatch losses. ``loss`` is a 0-d float32
    tensor on the device: reading it is the caller's synchronisation."""
    _check_in_slice(cfg, mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    optimizer = optimizer or default_optimizer()
    loss_fn = make_loss_fn(cfg, mesh)

    def step(params, opt_state, tokens):
        leaves = param_leaves(params)
        tokens = torch.as_tensor(tokens, device=leaves[0].device).long()
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps {accum_steps}")
        for x in leaves:
            x.requires_grad_(True)
            x.grad = None
        if opt_state is None:
            opt_state = optimizer(leaves)
        total = torch.zeros((), device=tokens.device)
        for micro in tokens.chunk(accum_steps):
            loss = loss_fn(params, micro)
            (loss / accum_steps).backward()
            total += loss.detach()
        opt_state.step()
        return params, opt_state, total / accum_steps

    return step


def train_step_model_flops(cfg: TransformerConfig, batch: int,
                           seq: int) -> int:
    """Analytic model FLOPs for one train step (fwd + bwd = 3x the forward
    matmul FLOPs), the numerator of MFU, as the reference counts them:

      linear layers: 6 * tokens * (L*(4*d^2 + 3*d*d_ff) + d*vocab)
      attention, causal: fwd 4*B*T^2*d*L * 0.5 -> fwd+bwd 6*B*T^2*d*L
    """
    d, L, dff, V = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab
    flops_linear = 6 * batch * seq * (L * (4 * d * d + 3 * d * dff) + d * V)
    flops_attn = 6 * batch * seq * seq * d * L
    return flops_linear + flops_attn
