"""LoRA: low-rank adapter fine-tuning over the flagship transformer, the
counterpart of ``kubegpu_tpu/workload/lora.py``.

Each targeted weight ``W [in, out]`` gains adapters ``A [in, r]`` and
``B [r, out]`` with ``B`` zero, and the model runs with the merged weight
``W + (alpha / r) * A @ B``. Merging once a step leaves the forward (and
its flash kernels and remat policies) unchanged; the ``[in, r] @ [r,
out]`` product costs about ``r / (2·B·T)`` of the weight's own products.

Only the adapters train. The step keeps every base leaf out of autograd
(``requires_grad`` off, ``.grad`` None), so no base weight gradient is
computed or stored and the AdamW state covers the adapters alone: the
memory saving the method exists for. The backward still carries dX
through every layer, so the flash backward kernels run as in a full step.

Over a mesh (`lora_pspecs`) ``a`` is replicated and ``b`` split as its
base weight's output dimension, so the merged weight has the base
weight's layout: a column-parallel base merges ``A @ B_local``, a
row-parallel one ``A[rows] @ B``. The replicated adapters enter the
sharded product through `spmd.copy_to`, which sums their partial
gradients over ``model``.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.workload import spmd
from kubegpu_tpu_torch.workload.model import TransformerConfig, make_loss_fn
from kubegpu_tpu_torch.workload.train import default_optimizer, param_leaves

DEFAULT_TARGETS = ("wq", "wv")  # the classic LoRA attention targets


def init_lora(generator: torch.Generator, params: dict, rank: int,
              targets: tuple = DEFAULT_TARGETS) -> dict:
    """Adapters mirroring ``params["layers"]``: per layer and target,
    ``{"a": [in, r] (normal times in^-0.5), "b": [r, out] (zeros)}``,
    float32 on the generator's device. A zero ``b`` makes the merged model
    equal the base model."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    dev = generator.device
    layers = []
    for i, layer in enumerate(params["layers"]):
        adapters = {}
        for name in targets:
            if name not in layer:
                raise KeyError(
                    f"LoRA target {name!r} not in layer {i} "
                    f"(have: {sorted(k for k in layer if k != 'moe')})")
            d_in, d_out = layer[name].shape
            adapters[name] = {
                "a": torch.randn((d_in, rank), generator=generator,
                                 device=dev, dtype=torch.float32)
                * d_in ** -0.5,
                "b": torch.zeros((rank, d_out), device=dev,
                                 dtype=torch.float32)}
        layers.append(adapters)
    return {"layers": layers}


def lora_pspecs(cfg: TransformerConfig,
                targets: tuple = DEFAULT_TARGETS) -> dict:
    """The adapters' layout over a mesh, as `spmd.param_pspecs` states
    it: ``a`` replicated, ``b`` split on its output dimension where the
    base weight's output dimension is split."""
    base = spmd.param_pspecs(cfg)["layers"]
    return {"layers": [
        {name: {"a": None, "b": 1 if base[i][name] == 1 else None}
         for name in targets}
        for i in range(cfg.n_layers)]}


def merge_lora(params: dict, lora: dict, scaling: float, mesh=None) -> dict:
    """``W + scaling * A @ B`` for every adapted weight; the other leaves
    are passed through by reference (no copies). Over a mesh ``params``
    and ``lora`` are this rank's shards, and the merge gives the rank's
    shard of the merged weight."""
    tp_rank = spmd.axis_rank(mesh, spmd.AXIS_MODEL)
    merged_layers = []
    for layer, adapters in zip(params["layers"], lora["layers"]):
        new = dict(layer)
        for name, ab in adapters.items():
            a = spmd.copy_to(mesh, ab["a"])
            b = ab["b"]
            rows = layer[name].shape[0]
            if a.shape[0] != rows:          # a row-parallel base weight
                a = a[tp_rank * rows:(tp_rank + 1) * rows]
                b = spmd.copy_to(mesh, b)
            new[name] = layer[name] + scaling * (a @ b)
        merged_layers.append(new)
    return {**params, "layers": merged_layers}


def make_lora_train_step(cfg: TransformerConfig, mesh, rank: int,
                         optimizer=None, alpha: float | None = None):
    """``step(lora, opt_state, params, tokens) -> (lora, opt_state,
    loss)``: the loss of the merged model (scaling ``alpha / rank``, alpha
    defaulting to the rank), its gradient in the adapters only and one
    update of ``opt_state``, the optimizer over the adapter leaves (None
    builds one with ``optimizer``, a factory as `default_optimizer`
    returns). The adapters are updated in place and returned; the base
    ``params`` stay frozen. Over a mesh ``lora`` and ``params`` are this
    rank's shards (`lora_pspecs`, `spmd.param_pspecs`) and ``tokens`` the
    global batch; the adapters' gradients sum over ``data`` and ``seq``."""
    optimizer = optimizer or default_optimizer()
    scaling = (alpha if alpha is not None else float(rank)) / rank
    loss_fn = make_loss_fn(cfg, mesh)

    def step(lora, opt_state, params, tokens):
        for x in param_leaves(params):
            x.requires_grad_(False)
            x.grad = None
        leaves = param_leaves(lora)
        for x in leaves:
            x.requires_grad_(True)
            x.grad = None
        if opt_state is None:
            opt_state = optimizer(leaves)
        if mesh is not None:
            tokens = spmd.global_batch(mesh, tokens)
        loss = loss_fn(merge_lora(params, lora, scaling, mesh), tokens)
        loss.backward()
        if mesh is not None:
            spmd.all_reduce_grads(leaves, mesh)
        opt_state.step()
        return lora, opt_state, loss.detach()

    return step


def count_params(tree) -> int:
    return sum(x.numel() for x in param_leaves(tree))
