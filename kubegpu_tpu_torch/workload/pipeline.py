"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis, the
counterpart of ``kubegpu_tpu/workload/pipeline.py``.

Layers are split into S stages, one per rank of the ``stage`` axis.
Activations move stage to stage by point-to-point sends: every rank runs
the same ``n_micro + S - 1`` steps, stage 0 injects a fresh microbatch a
step, stage ``S-1`` emits one, and the (S-1)-step bubble fills and drains
at the ends. The last stage's outputs are replicated over the axis by an
all-reduce of the masked buffer, as the reference's ``psum``.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.workload import spmd
from kubegpu_tpu_torch.workload.ring import Permute

AXIS_STAGE = "stage"


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def stack_stage_params(per_stage_params: list):
    """Stack a list of per-stage parameter trees along a leading stage
    dimension."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def make_pipelined_apply(stage_fn, mesh, n_microbatches: int,
                         stage_axis: str = AXIS_STAGE):
    """Build ``apply(stacked_params, x) -> y`` running the stage pipeline.

    - ``stage_fn(stage_params, x_mb) -> y_mb`` must keep the shape
      (transformer blocks: ``[mb, T, D] -> [mb, T, D]``);
    - ``stacked_params``: a tree with a leading stage dimension
      (`stack_stage_params`); each rank takes its stage's slice;
    - ``x``: ``[n_microbatches, mb, ...]``, the same on every rank; the
      output has the same shape, the same on every rank.

    ``mesh`` is a `DeviceMesh` with a ``stage_axis`` dimension; its other
    dimensions replicate the pipeline."""
    group = mesh.get_group(stage_axis)
    n_stages = spmd.axis_size(mesh, stage_axis)
    stage = spmd.axis_rank(mesh, stage_axis)
    nxt = stage + 1 if stage < n_stages - 1 else None
    prev = stage - 1 if stage > 0 else None

    def apply(stacked_params, x):
        params = _tree_map(lambda a: a[stage], stacked_params)
        if x.shape[0] != n_microbatches:
            raise ValueError(f"x holds {x.shape[0]} microbatches, the "
                             f"schedule {n_microbatches}")
        outs = []
        carry = torch.zeros_like(x[0])
        for t in range(n_microbatches + n_stages - 1):
            # stage s holds microbatch t - s while 0 <= t - s < n_micro;
            # outside that window it has nothing to compute
            if 0 <= t - stage < n_microbatches:
                out = stage_fn(params, x[t] if stage == 0 else carry)
            else:
                out = torch.zeros_like(carry)
            if stage == n_stages - 1 and t >= n_stages - 1:
                outs.append(out)
            if n_stages > 1:
                (carry,) = Permute.apply(group, nxt, prev, out)
        buf = (torch.stack(outs) if outs
               else torch.zeros_like(x))
        return spmd.reduce_from(mesh, buf, (stage_axis,))

    return apply


def split_layers_into_stages(layers: list, n_stages: int) -> list:
    """Partition a layer list into n_stages contiguous, equal groups."""
    if len(layers) % n_stages != 0:
        raise ValueError(f"{len(layers)} layers not divisible by "
                         f"{n_stages} stages")
    per = len(layers) // n_stages
    return [layers[i * per:(i + 1) * per] for i in range(n_stages)]
