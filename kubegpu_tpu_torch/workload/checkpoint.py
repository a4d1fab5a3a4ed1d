"""Train-state checkpoints in the reference's numpy format
(``kubegpu_tpu/workload/checkpoint.py``, ``_save_numpy`` and the npz
branch of ``restore_checkpoint``), so the two packages read each other's
checkpoints.

A checkpoint is ``<path>/step_N/leaves.npz`` (``leaf_0``, ``leaf_1``, ...)
and ``meta.json`` (``{"step", "n_leaves"}``), written into
``step_N.tmp-<pid>`` and renamed into place, so a writer killed mid-save
never leaves a half-written ``step_N``. Leaves are numbered in
``jax.tree.flatten`` order (`train.param_leaves`): dict keys sorted,
lists and tuples in order.

A train state is ``{"params": tree, "opt_state": (count, mu, nu)}``: the
leaves of optax's adamw state ``(ScaleByAdamState(count, mu, nu),
EmptyState(), EmptyState())``, with ``count`` an int32 scalar and ``mu``,
``nu`` trees like the params. `adamw_state` reads them from a
``torch.optim.AdamW`` (its per-leaf ``step``, ``exp_avg`` and
``exp_avg_sq``) and `load_train_state` writes them back.

A ``step_N`` without ``leaves.npz`` (an orbax checkpoint of the reference)
counts as unreadable: reading orbax needs jax.

Over a mesh (``mesh=``, with ``specs``: the tree of split dimensions
`spmd.param_pspecs` states, `train_state_specs` for a train state) the
file holds the global state, so a checkpoint restores onto any mesh shape
or one device, and the reference reads it: on save every split leaf is
gathered over ``model``, the rank at mesh coordinate (0, 0, 0) writes,
and the ranks agree that it did before any returns; on restore every rank
reads the file, checks it against the global shapes, and the ranks agree
on success and on the step (an all-reduce, before any other collective)
before each keeps its shards, so a rank that cannot read never strands
its peers in the next collective.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kubegpu_tpu_torch.workload import spmd
from kubegpu_tpu_torch.workload.train import param_leaves


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are taken from
    ``leaves`` in `param_leaves` order."""
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def _agree(mesh, *values: int) -> list:
    """Each of ``values`` as its least over every rank of the mesh's
    process group (``values`` as they are without a mesh)."""
    if mesh is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64,
                     device=spmd.mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return t.tolist()


def train_state_specs(param_specs: Any) -> dict:
    """The specs of a train state ``{"params", "opt_state": (count, mu,
    nu)}`` over params laid out by ``param_specs``: AdamW works element by
    element, so the moments split as the params do; ``count`` is
    replicated."""
    return {"params": param_specs,
            "opt_state": (None, param_specs, param_specs)}


def save_checkpoint(path: str, state: Any, step: int, mesh=None,
                    specs: Any = None) -> str:
    """Write ``state`` (a tree of tensors) at ``path/step_<step>``
    atomically (a temp dir, then a rename); returns the final path. Over
    a mesh ``state`` is this rank's shards, laid out by ``specs``: the
    file holds the gathered global state, written by the rank at mesh
    coordinate (0, 0, 0), and no rank returns before it exists (every
    rank raises if the write failed)."""
    if mesh is None:
        return _write(path, state, step)
    state = spmd.gather_tree(state, specs, mesh)
    full, ok = os.path.join(path, f"step_{step}"), 1
    if all(c == 0 for c in mesh.get_coordinate()):
        try:
            full = _write(path, state, step)
        except Exception:
            logging.getLogger(__name__).exception(
                "checkpoint %s not written", full)
            ok = 0
    if not _agree(mesh, ok)[0]:
        raise RuntimeError(f"checkpoint {full} was not written")
    return full


def _write(path: str, state: Any, step: int) -> str:
    full = os.path.join(path, f"step_{step}")
    tmp = f"{full}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    leaves = param_leaves(state)
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": x.detach().cpu().numpy()
                for i, x in enumerate(leaves)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves)}, f)
    if os.path.isdir(full):
        shutil.rmtree(full)
    os.rename(tmp, full)
    return full


def _read_step(full: str, like: Any) -> Any:
    """The state saved in the step directory ``full``, in ``like``'s
    structure, as CPU tensors; raises if it does not fit ``like``."""
    npz = os.path.join(full, "leaves.npz")
    if not os.path.exists(npz):
        raise ValueError(f"{full}: no leaves.npz (an orbax checkpoint "
                         "cannot be read without jax)")
    want = param_leaves(like)
    with np.load(npz) as data:
        if len(data.files) != len(want):
            raise ValueError(
                f"{full}: {len(data.files)} saved leaves vs {len(want)} "
                "expected — different model config")
        restored = []
        for i, x in enumerate(want):
            got = data[f"leaf_{i}"]
            if got.shape != tuple(x.shape):
                raise ValueError(
                    f"{full}: leaf {i} shape {got.shape} != expected "
                    f"{tuple(x.shape)} — checkpoint from a different model "
                    "config")
            restored.append(torch.from_numpy(got))
    return _unflatten(like, iter(restored))


def restore_checkpoint(path: str, like: Any, mesh=None,
                       specs: Any = None) -> Tuple[Any, int]:
    """Restore the newest readable ``step_*`` under ``path`` into the
    structure of ``like`` (whose leaves give only the shapes: meta tensors
    will do); returns ``(state, step)`` with CPU tensors, or ``(None, -1)``
    when no step is readable. An unreadable step (torn, from another
    config, orbax) is logged as a warning and the next older one tried.

    Over a mesh ``like`` is this rank's shards, laid out by ``specs``;
    every rank reads the global state, and the ranks agree (one
    all-reduce) before each keeps its shards: unless all of them read the
    same step, all return ``(None, -1)``."""
    if mesh is None:
        return _read_newest(path, like)
    tp = spmd.axis_size(mesh, spmd.AXIS_MODEL)
    r = spmd.axis_rank(mesh, spmd.AXIS_MODEL)

    def whole(x, dim):
        shape = list(x.shape)
        if dim is not None:
            shape[dim] *= tp
        return torch.empty(shape, dtype=x.dtype, device="meta")

    state, step = _read_newest(path, spmd.map_specs(whole, like, specs))
    low, neg_high = _agree(mesh, step, -step)
    if low != -neg_high or low < 0:
        if step >= 0:
            logging.getLogger(__name__).warning(
                "checkpoint step %d read here, but not on every rank "
                "(steps %d..%d): restoring nothing", step, low, -neg_high)
        return None, -1

    def shard(x, dim):
        return x if dim is None else x.chunk(tp, dim)[r].contiguous()

    return _unflatten(like, iter(param_leaves(
        spmd.map_specs(shard, state, specs)))), step


def _read_newest(path: str, like: Any) -> Tuple[Any, int]:
    if not os.path.isdir(path):
        return None, -1
    steps = sorted(
        (int(d.split("_", 1)[1]), d) for d in os.listdir(path)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit())
    for step, dirname in reversed(steps):
        full = os.path.join(path, dirname)
        try:
            return _read_step(full, like), step
        except Exception:
            # loudly, or a failure of every step would pass for "no
            # checkpoint" and retrain from step 0
            logging.getLogger(__name__).warning(
                "checkpoint %s unreadable, trying older", full,
                exc_info=True)
    return None, -1


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def adamw_template(params: Any) -> tuple:
    """The shapes of `adamw_state` over ``params`` as meta tensors: a
    restore template that allocates nothing."""
    def meta(x):
        return torch.empty(x.shape, dtype=torch.float32, device="meta")

    count = torch.empty((), dtype=torch.int32, device="meta")
    return count, tree_map(meta, params), tree_map(meta, params)


def adamw_state(optimizer: torch.optim.Optimizer, params: Any) -> tuple:
    """``(count, mu, nu)``: optax adamw's state leaves from ``optimizer``'s
    per-leaf ``step``, ``exp_avg`` and ``exp_avg_sq`` over ``params``
    (zeros before the first step)."""
    steps = [s["step"] for s in map(optimizer.state.get,
                                    param_leaves(params)) if s]
    count = torch.tensor(int(steps[0]) if steps else 0, dtype=torch.int32)

    def moment(key):
        def get(x):
            s = optimizer.state.get(x)
            return s[key].detach() if s else torch.zeros_like(x.detach())
        return get

    return count, tree_map(moment("exp_avg"), params), \
        tree_map(moment("exp_avg_sq"), params)


@torch.no_grad()
def load_train_state(optimizer: torch.optim.Optimizer, params: Any,
                     state: dict) -> None:
    """Copy a restored ``{"params", "opt_state": (count, mu, nu)}`` into
    ``params`` in place and into ``optimizer``'s state for each of its
    leaves. ``step`` goes where torch's (foreach) AdamW keeps it: a
    float32 scalar on the CPU."""
    count, mu, nu = state["opt_state"]
    for x, saved, m, v in zip(param_leaves(params),
                              param_leaves(state["params"]),
                              param_leaves(mu), param_leaves(nu)):
        x.copy_(saved)
        optimizer.state[x] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(x.device, x.dtype),
            "exp_avg_sq": v.to(x.device, x.dtype)}
