"""The training step: the counterpart of ``kubegpu_tpu/workload/train.py``.

The reference jits fwd + bwd + optimizer and donates params and optimizer
state so XLA updates them in place. Here the step runs eagerly and updates
the parameter tensors in place through a ``torch.optim.AdamW`` (the same
update as ``optax.adamw``: bias-corrected moments, decoupled weight decay
on every leaf). The optimizer object is the optimizer state.

Over a mesh every rank holds its shards (`spmd.shard_params`), takes its
rows of the global batch (`spmd.global_batch`), runs the backward of the
global loss and sums the gradients over ``data`` and ``seq`` in a few flat
buffers (`spmd.all_reduce_grads`); the AdamW over its local shards is then
exact, since AdamW works element by element.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kubegpu_tpu_torch.workload import spmd
from kubegpu_tpu_torch.workload.model import (TransformerConfig, init_params,
                                              make_loss_fn)


def default_optimizer(lr: float = 3e-4):
    """A factory ``optimizer(leaves) -> torch.optim.AdamW`` with the
    reference's ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01)``
    (eps 1e-8)."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.01)


def param_leaves(params) -> list:
    """The leaves of a tree of dicts, lists and tuples in
    ``jax.tree.flatten`` order (dict keys sorted, lists and tuples in
    order): the reference's order, which checkpoints number leaves by."""
    if isinstance(params, dict):
        return [x for key in sorted(params)
                for x in param_leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [x for item in params for x in param_leaves(item)]
    return [params]


def init_sharded(generator: torch.Generator, cfg: TransformerConfig,
                 mesh=None, optimizer=None, init_optimizer: bool = True):
    """``(params, opt_state, optimizer)`` on the generator's device: float32
    leaves that require grad, and the optimizer built over them
    (``opt_state=None`` with ``init_optimizer=False``). Over a mesh every
    rank draws the whole tree from its generator (seeded alike on every
    rank, so the ranks agree) and keeps its shards."""
    optimizer = optimizer or default_optimizer()
    params = init_params(generator, cfg)
    if mesh is not None:
        params = spmd.shard_params(params, cfg, mesh)
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
    tensor on the device: reading it is the caller's synchronisation.

    Over a mesh ``params`` are this rank's shards and ``tokens`` the
    global batch, the same on every rank (numpy or a tensor); each
    microbatch of it is split over ``data`` as the reference's is."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    optimizer = optimizer or default_optimizer()
    loss_fn = make_loss_fn(cfg, mesh)

    def step(params, opt_state, tokens):
        leaves = param_leaves(params)
        dev = leaves[0].device
        if mesh is None:
            tokens = torch.as_tensor(tokens, device=dev).long()
        elif not torch.is_tensor(tokens):
            tokens = torch.from_numpy(np.asarray(tokens))
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps {accum_steps}")
        for x in leaves:
            x.requires_grad_(True)
            x.grad = None
        if opt_state is None:
            opt_state = optimizer(leaves)
        total = torch.zeros((), device=dev)
        for micro in tokens.chunk(accum_steps):
            if mesh is not None:
                micro = spmd.global_batch(mesh, micro)
            loss = loss_fn(params, micro)
            (loss / accum_steps).backward()
            total += loss.detach()
        if mesh is not None:
            spmd.all_reduce_grads(leaves, mesh)
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
