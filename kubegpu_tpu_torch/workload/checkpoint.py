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
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Iterator, Tuple

import numpy as np
import torch

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


def save_checkpoint(path: str, state: Any, step: int) -> str:
    """Write ``state`` (a tree of tensors) at ``path/step_<step>``
    atomically (a temp dir, then a rename); returns the final path."""
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


def restore_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore the newest readable ``step_*`` under ``path`` into the
    structure of ``like`` (whose leaves give only the shapes: meta tensors
    will do); returns ``(state, step)`` with CPU tensors, or ``(None, -1)``
    when no step is readable. An unreadable step (torn, from another
    config, orbax) is logged as a warning and the next older one tried."""
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
