"""Process worlds for the port's gloo tests (a helper module, not a test
file: it imports torch and the port only, so spawned ranks import no JAX).

- `single_rank_mesh`: a one-rank gloo group in the test's own process and
  its (1, 1, 1) mesh, torn down on exit (a later test in the same worker
  must find no group formed).
- `run_world`: one world of ``n`` spawned ranks running a job of this
  module, joined through a ``file://`` store (never a fixed port: the
  tests run under xdist); each rank's results go to ``out_dir`` as
  ``rank{r}.pt``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.workload import spmd

WORLD_TIMEOUT_S = 240.0


@contextlib.contextmanager
def single_rank_mesh():
    with tempfile.TemporaryDirectory(prefix="kgt-mesh1-") as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            yield spmd.make_mesh(1, 1, 1, 1, device="cpu")
        finally:
            dist.destroy_process_group()


def _job(rank: int, job: str, in_dir: str, out_dir: str) -> None:
    import importlib

    module, name = job.rsplit(".", 1)
    results = getattr(importlib.import_module(module), name)(rank, in_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run_world(job: str, n: int, in_dir: str, out_dir: str) -> list:
    """Run ``job`` (``module.function(rank, in_dir) -> results``) on ``n``
    gloo ranks; returns every rank's results, rank order. Raises if a
    rank fails or the world outlives `WORLD_TIMEOUT_S`."""
    os.makedirs(out_dir, exist_ok=True)
    spmd.spawn(_job, n, args=(job, in_dir, out_dir), device="cpu",
               timeout=WORLD_TIMEOUT_S)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


# -- jobs: each runs on every rank of its world -----------------------------

def _load(in_dir: str) -> dict:
    return torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)


def _cfg(kw: dict):
    from kubegpu_tpu_torch.workload.model import TransformerConfig

    return TransformerConfig(**kw)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().numpy()


def sharded_loss_and_grads(cfg, mesh, full_params, tokens) -> tuple:
    """The global loss on this rank and the full (gathered) gradient tree
    of the sharded model, from the full parameters ``full_params``."""
    from kubegpu_tpu_torch.workload.model import make_loss_fn
    from kubegpu_tpu_torch.workload.train import param_leaves

    local = spmd.shard_params(full_params, cfg, mesh)
    leaves = param_leaves(local)
    for x in leaves:
        x.requires_grad_(True)
    loss = make_loss_fn(cfg, mesh)(local, spmd.global_batch(mesh, tokens))
    loss.backward()
    spmd.all_reduce_grads(leaves, mesh)
    grads = spmd.gather_params(_grad_tree(local), cfg, mesh)
    return loss.item(), _numpy_tree(grads)


def _ring_case(mesh, q, k, v, window: int, flash: bool) -> dict:
    """This rank's ring output and its q/k/v gradients under the loss
    sum(sin(out)), on its seq block of the full q, k, v."""
    from kubegpu_tpu_torch.workload.ring import (GroupSeqAxis,
                                                 ring_attention,
                                                 ring_flash_attention)

    axis = GroupSeqAxis(mesh.get_group(spmd.AXIS_SEQ))
    t = q.shape[1] // axis.size
    blk = [torch.from_numpy(x[:, axis.rank * t:(axis.rank + 1) * t])
           .requires_grad_() for x in (q, k, v)]
    ring = ring_flash_attention if flash else ring_attention
    out = ring(*blk, axis, q.shape[-1] ** -0.5, window=window)
    grads = torch.autograd.grad(out.sin().sum(), blk)
    return {"seq_rank": axis.rank, "out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def job_spmd4(rank: int, in_dir: str) -> dict:
    """The 4-rank world of tests/test_torch_spmd.py."""
    from torch.distributed.device_mesh import init_device_mesh

    from kubegpu_tpu_torch.workload.pipeline import (make_pipelined_apply,
                                                     stack_stage_params)
    from kubegpu_tpu_torch.workload.ulysses import ulysses_attention

    inp = _load(in_dir)
    out = {}
    auto = spmd.mesh_from_env(env={}, device="cpu")
    out["mesh_from_env"] = (auto.mesh_dim_names,
                            tuple(auto.mesh.shape), auto.mesh.tolist())
    meshes = {sp: spmd.make_mesh(4, dp=4 // sp, sp=sp, tp=1, device="cpu")
              for sp in (2, 4)}
    q, k, v = inp["qkv"]
    for sp, window, flash in inp["ring_cases"]:
        out[("ring", sp, window, flash)] = _ring_case(meshes[sp], q, k, v,
                                                      window, flash)
    # Ulysses over sp = 2, and its refusal of indivisible heads
    group = meshes[2].get_group(spmd.AXIS_SEQ)
    t = q.shape[1] // 2
    r = spmd.axis_rank(meshes[2], spmd.AXIS_SEQ)
    blk = [torch.from_numpy(x[:, r * t:(r + 1) * t]).requires_grad_()
           for x in (q, k, v)]
    o = ulysses_attention(*blk, group, q.shape[-1] ** -0.5)
    out["ulysses"] = {"seq_rank": r, "out": o.detach().numpy(),
                      "grads": [g.numpy() for g in torch.autograd.grad(
                          o.sin().sum(), blk)]}
    x3 = torch.zeros((1, 8, 3, 8))
    try:
        ulysses_attention(x3, x3, x3, meshes[4].get_group(spmd.AXIS_SEQ),
                          1.0)
        out["ulysses_refusal"] = None
    except ValueError as exc:
        out["ulysses_refusal"] = str(exc)
    # the sharded loss and gradients at (1, 4, 1) and (1, 1, 4)
    params = inp["params"]
    for shape, impl in inp["model_cases"]:
        mesh = spmd.make_mesh(4, *shape, device="cpu")
        cfg = _cfg({**inp["cfg"], "seq_impl": impl})
        out[("model", shape, impl)] = sharded_loss_and_grads(
            cfg, mesh, params, inp["tokens"])
    # the pipeline at 2 and 4 stages
    for stages, per_stage in inp["pipeline"].items():
        pmesh = init_device_mesh("cpu", (4 // stages, stages),
                                 mesh_dim_names=("data", "stage"))
        stacked = stack_stage_params(
            [{n: torch.from_numpy(a) for n, a in p.items()}
             for p in per_stage])
        apply = make_pipelined_apply(_pipeline_stage, pmesh,
                                     inp["pipeline_x"].shape[0])
        out[("pipeline", stages)] = apply(
            stacked, torch.from_numpy(inp["pipeline_x"])).numpy()
    return out


def _pipeline_stage(p, x):
    """tests/test_workload_parallel.py's stage: x + tanh(x W1 + b1) W2."""
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def job_spmd8(rank: int, in_dir: str) -> dict:
    """The 8-rank world of tests/test_torch_spmd8.py."""
    import dataclasses

    from kubegpu_tpu_torch.workload.lora import (lora_pspecs,
                                                 make_lora_train_step,
                                                 merge_lora)
    from kubegpu_tpu_torch.workload.model import (make_forward_with_aux,
                                                  make_loss_fn)
    from kubegpu_tpu_torch.workload.train import (default_optimizer,
                                                  make_train_step,
                                                  param_leaves)

    inp = _load(in_dir)
    out = {}
    mesh = spmd.make_mesh(8, 2, 2, 2, device="cpu")
    cfg = _cfg(inp["cfg"])
    params, tokens = inp["params"], inp["tokens"]
    # (2, 2, 2): ring and Ulysses, then remat none/dots/full through the
    # flash operator's plain version
    for impl in ("ring", "ulysses"):
        out[("model", impl)] = sharded_loss_and_grads(
            dataclasses.replace(cfg, seq_impl=impl), mesh, params, tokens)
    for remat in ("none", "dots", "full"):
        out[("remat", remat)] = sharded_loss_and_grads(
            dataclasses.replace(cfg, attn_impl="flash", remat=remat), mesh,
            params, tokens)
    # three AdamW steps on (2, 2, 2)
    local = spmd.shard_params(params, cfg, mesh)
    step = make_train_step(cfg, mesh, default_optimizer())
    opt_state, losses = None, []
    for batch in inp["batches"]:
        local, opt_state, loss = step(local, opt_state, batch)
        losses.append(loss.item())
    out["adamw_losses"] = losses
    out["adamw_params"] = _numpy_tree(spmd.gather_params(local, cfg, mesh))
    # expert parallelism at (dp, sp, tp) = (2, 1, 4), top-1 and top-2
    moe_mesh = spmd.make_mesh(8, 2, 1, 4, device="cpu")
    for top_k, moe_params in inp["moe"].items():
        mcfg = _cfg({**inp["moe_cfg"], "moe_top_k": top_k})
        fwd = make_forward_with_aux(mcfg, moe_mesh)
        local = spmd.shard_params(moe_params, mcfg, moe_mesh)
        with torch.no_grad():
            _, aux = fwd(local, spmd.global_batch(moe_mesh, tokens)[:, :-1])
        out[("moe", top_k)] = (*sharded_loss_and_grads(
            mcfg, moe_mesh, moe_params, tokens), aux.item())
    # LoRA on (2, 2, 2) over wq, wv (column-parallel) and wo (row-parallel)
    targets = tuple(inp["lora_targets"])
    base = spmd.shard_params(params, cfg, mesh)
    lora = spmd.shard_tree(inp["lora"], lora_pspecs(cfg, targets), mesh)
    leaves = param_leaves(lora)
    for x in leaves:
        x.requires_grad_(True)
    scaling = inp["lora_scaling"]
    loss = make_loss_fn(cfg, mesh)(
        merge_lora(base, lora, scaling, mesh),
        spmd.global_batch(mesh, tokens))
    loss.backward()
    spmd.all_reduce_grads(leaves, mesh)
    out["lora_loss"] = loss.item()
    out["lora_grads"] = _numpy_tree(spmd.gather_tree(
        _grad_tree(lora), lora_pspecs(cfg, targets), mesh))
    before = [x.clone() for x in param_leaves(base)]
    step = make_lora_train_step(cfg, mesh, inp["lora_rank"],
                                alpha=scaling * inp["lora_rank"])
    for x in leaves:
        x.grad = None
    step(lora, None, base, tokens)
    out["lora_base_untouched"] = all(
        torch.equal(a, b) and not a.requires_grad and a.grad is None
        for a, b in zip(param_leaves(base), before))
    return out


def job_rank1_dies(rank: int, in_dir: str) -> dict:
    """Rank 1 raises; the others wait for it in a collective that never
    completes: the world must fail fast, not hang."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return {}
