"""LoRA: low-rank adapter fine-tuning over the flagship transformer, the
counterpart of ``kubegpu_tpu/workload/lora.py`` on one device.

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
``lora_pspecs`` (the adapters' layout over a mesh) comes with the
multi-GPU slice.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                              _check_in_slice, make_loss_fn)
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


def merge_lora(params: dict, lora: dict, scaling: float) -> dict:
    """``W + scaling * A @ B`` for every adapted weight; the other leaves
    are passed through by reference (no copies)."""
    merged_layers = []
    for layer, adapters in zip(params["layers"], lora["layers"]):
        new = dict(layer)
        for name, ab in adapters.items():
            new[name] = layer[name] + scaling * (ab["a"] @ ab["b"])
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
    ``params`` stay frozen. Any mesh raises."""
    _check_in_slice(cfg, mesh)
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
        loss = loss_fn(merge_lora(params, lora, scaling), tokens)
        loss.backward()
        opt_state.step()
        return lora, opt_state, loss.detach()

    return step


def count_params(tree) -> int:
    return sum(x.numel() for x in param_leaves(tree))
