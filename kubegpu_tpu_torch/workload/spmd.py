"""Mesh construction, sharding layout and the collectives of the sharded
paths: the counterpart of ``kubegpu_tpu/workload/spmd.py``.

Axis convention, as the reference's:

- ``data``  — batch (pure data parallel; gradients all-reduce here)
- ``seq``   — sequence parallel (ring attention or Ulysses ride this axis)
- ``model`` — tensor parallel (attention heads, FFN columns, experts)

The reference runs one global program under GSPMD, which inserts the
collectives its shardings imply. Here every process is one rank of a
``torch.distributed`` process group and holds its own shards; the model
calls the collectives itself, at the points GSPMD would put them (one
all-reduce over ``model`` per row-parallel product, the gradient
all-reduce over ``data`` and ``seq``). The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dimension names
``("data", "seq", "model")``, ``model`` innermost: consecutive ranks are
tensor-parallel neighbours, as ``np.array(devices).reshape(dp, sp, tp)``
lays them out in the reference.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``. A
mesh whose size is not the process group's raises, and so does every
failed collective: nothing carries on unsharded.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from kubegpu_tpu_torch._device import resolve_device

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
MESH_DIMS = (AXIS_DATA, AXIS_SEQ, AXIS_MODEL)
# bytes of one flat buffer of the gradient all-reduce
GRAD_BUCKET_BYTES = 256 << 20


def _factor3(n: int) -> tuple:
    """Factor n into (dp, sp, tp): tp innermost (consecutive ranks are the
    tightest neighbours), then sp, then dp."""
    tp = 1
    for cand in (8, 4, 2):
        if n % cand == 0:
            tp = cand
            break
    rest = n // tp
    sp = 1
    for cand in (4, 2):
        if rest % cand == 0:
            sp = cand
            break
    return rest // sp, sp, tp


def backend_for(device) -> str:
    """The process group's backend for ``device``: NCCL on CUDA, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, tp: int | None = None, device=None):
    """A ``(data, seq, model)`` `DeviceMesh` over the whole process group
    (``n_devices`` None: its size), on ``cuda`` unless ``device`` says
    otherwise. Without ``dp``, ``sp`` and ``tp`` the size is factored by
    `_factor3`. Raises if no process group is formed, if ``n_devices`` is
    not its size, if ``dp*sp*tp`` is not ``n_devices``, or if the group's
    backend does not serve the device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: run under torchrun "
            "(distributed_init_from_env) or init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a process group of "
                         f"{world}: the mesh must span the group")
    if dp is None or sp is None or tp is None:
        dp, sp, tp = _factor3(n)
    if dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp={dp * sp * tp} != n_devices={n}")
    if dist.get_backend() != backend_for(dev):
        raise ValueError(f"a {dev.type} mesh needs the {backend_for(dev)} "
                         f"backend, the group has {dist.get_backend()}")
    return init_device_mesh(dev.type, (dp, sp, tp), mesh_dim_names=MESH_DIMS)


def distributed_init_from_env(env: dict | None = None, device=None) -> bool:
    """Join the process group torchrun describes: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (the
    device index on this host). Returns True when it formed the group;
    without ``WORLD_SIZE``, or with a group already formed, it returns
    False untouched, so every binary can call it unconditionally. The
    backend follows ``device`` (``cuda`` unless asked)."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" not in env or dist.is_initialized():
        return False
    dev = resolve_device(device)
    rank = int(env["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        backend_for(dev),
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=int(env["WORLD_SIZE"]), rank=rank)
    return True


def mesh_from_env(env: dict | None = None, device=None):
    """The mesh over the whole process group torchrun describes, factored
    by `_factor3`: forms the group from the environment first if needed,
    and raises when there is none to form."""
    distributed_init_from_env(env, device)
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh_from_env needs torchrun's environment (WORLD_SIZE, RANK, "
            "MASTER_ADDR, MASTER_PORT) or a formed process group")
    return make_mesh(dist.get_world_size(), device=device)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a `DeviceMesh` with the reference's axes."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(spmd.make_mesh), got {type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise ValueError(f"mesh dimensions must be {MESH_DIMS}, got "
                         f"{mesh.mesh_dim_names}")


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, name: str) -> int:
    """The extent of axis ``name`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This rank's index along axis ``name`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(name)


def global_batch(mesh, np_batch) -> torch.Tensor:
    """This rank's ``data`` rows of one global batch, as int64 on the
    mesh's device. Every process holds the same global batch (the loader
    contract: identically seeded loaders) and keeps rows ``[i·B/dp,
    (i+1)·B/dp)``, as the reference's ``P(data, None)`` sharding does."""
    x = torch.as_tensor(np.asarray(np_batch) if not torch.is_tensor(np_batch)
                        else np_batch)
    dp = axis_size(mesh, AXIS_DATA)
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp {dp}")
    rows = x.shape[0] // dp
    i = axis_rank(mesh, AXIS_DATA)
    return x[i * rows:(i + 1) * rows].to(mesh_device(mesh), torch.long)


def param_pspecs(cfg) -> dict:
    """A tree matching ``model.init_params``: for each leaf the dimension
    split over ``model``, or None (replicated). Column-parallel (the
    output dimension, 1): ``wq``, ``wk``, ``wv``, ``w_up``, ``w_gate``,
    ``unembed``; row-parallel (the input dimension, 0): ``wo``,
    ``w_down``; with experts, `moe.moe_pspecs`."""
    layer = {"ln1": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0, "ln2": None}
    if cfg.n_experts > 0:
        from kubegpu_tpu_torch.workload.moe import moe_pspecs

        layer["moe"] = moe_pspecs()
    else:
        layer.update(w_up=1, w_gate=1, w_down=0)
    return {"embed": None, "unembed": 1, "final_norm": None,
            "layers": [{k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in layer.items()}
                       for _ in range(cfg.n_layers)]}


def check_tp(cfg, tp: int) -> None:
    """Refuse a config whose split dimensions do not divide by ``tp``."""
    dims = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.kv_heads,
            "vocab": cfg.vocab}
    if cfg.n_experts > 0:
        dims["n_experts"] = cfg.n_experts
    else:
        dims["d_ff"] = cfg.d_ff
    bad = [f"{k} {v}" for k, v in dims.items() if v % tp]
    if bad:
        # a kv_heads tp does not divide would need wk/wv (and the cache's
        # heads) replicated, their gradients reduced over model: not ported
        hint = (" (a GQA layout with replicated wk/wv is not supported)"
                if cfg.kv_heads % tp and not cfg.n_heads % tp else "")
        raise ValueError(f"tensor parallelism over tp={tp} needs "
                         f"{', '.join(bad)} to divide by {tp}{hint}")


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its matching tree of specs
    (tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, x, s) for x, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_tree(full, specs, mesh) -> dict:
    """Each leaf of ``full`` (tensors or numpy arrays) as this rank's
    shard: the ``model``-rank's slice of the dimension its spec names,
    or a copy of the whole leaf, float32 on the mesh's device."""
    dev, tp = mesh_device(mesh), axis_size(mesh, AXIS_MODEL)
    r = axis_rank(mesh, AXIS_MODEL)

    def shard(x, dim):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        x = x.detach().to(dev, torch.float32)
        if dim is not None:
            x = x.chunk(tp, dim)[r]
        return x.contiguous().clone()

    return map_specs(shard, full, specs)


def gather_tree(local, specs, mesh) -> dict:
    """The inverse of `shard_tree`: every split leaf all-gathered over
    ``model`` into the whole tensor (detached), the others as they are."""
    group, tp = mesh.get_group(AXIS_MODEL), axis_size(mesh, AXIS_MODEL)

    def gather(x, dim):
        x = x.detach().contiguous()
        if dim is None:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(tp)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    return map_specs(gather, local, specs)


def shard_params(full, cfg, mesh) -> dict:
    """This rank's shards of the full parameter tree ``full`` (the port's
    `init_params`, or a JAX tree carried across as numpy) under
    `param_pspecs`. Raises for a config ``tp`` does not divide."""
    check_mesh(mesh)
    check_tp(cfg, axis_size(mesh, AXIS_MODEL))
    return shard_tree(full, param_pspecs(cfg), mesh)


def gather_params(local, cfg, mesh) -> dict:
    """The full parameter tree from every ``model`` rank's shards."""
    return gather_tree(local, param_pspecs(cfg), mesh)


# -- differentiable collectives (the Megatron pair and its relatives) ------

class _AllReduce(torch.autograd.Function):
    """Sum over ``group`` forward, identity backward: a row-parallel
    product's output, or a statistic whose every rank's copy feeds the
    same replicated value."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, sum over ``group`` backward: a replicated input
    entering a column-parallel region, each rank's gradient partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dimension forward; backward keeps this
    rank's slice (the gathered value feeds a replicated computation, so
    every rank's cotangent is the same)."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.n, ctx.r = n, r
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.r].contiguous(), None


def reduce_from(mesh, x, axes=(AXIS_MODEL,)):
    """``x`` summed over the mesh ``axes``, identity in the backward
    (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    for name in axes:
        x = _AllReduce.apply(x, mesh.get_group(name))
    return x


def copy_to(mesh, x, axis: str = AXIS_MODEL):
    """``x`` unchanged, its gradient summed over ``axis`` in the backward
    (``x`` itself without a mesh)."""
    return x if mesh is None else _CopyToGroup.apply(x, mesh.get_group(axis))


def gather_last(mesh, x, axis: str = AXIS_MODEL):
    """``x`` all-gathered over ``axis`` along its last dimension (``x``
    itself without a mesh)."""
    return x if mesh is None else _GatherLast.apply(x, mesh.get_group(axis))


def all_reduce_grads(leaves, mesh, axes=(AXIS_DATA, AXIS_SEQ)) -> None:
    """Sum every leaf's ``.grad`` over the mesh ``axes`` in place, through
    flat buffers of at most `GRAD_BUCKET_BYTES` each (one collective per
    buffer and axis, not one per leaf). A leaf without a gradient counts
    as zeros, so every rank reduces the same buffers."""
    for x in leaves:
        if x.grad is None:
            x.grad = torch.zeros_like(x)
    buckets, cur, size = [], [], 0
    for x in leaves:
        nbytes = x.grad.numel() * x.grad.element_size()
        if cur and (size + nbytes > GRAD_BUCKET_BYTES
                    or x.grad.dtype != cur[0].grad.dtype):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(x)
        size += nbytes
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        flat = torch.cat([x.grad.reshape(-1) for x in bucket])
        for name in axes:
            dist.all_reduce(flat, group=mesh.get_group(name))
        offset = 0
        for x in bucket:
            n = x.grad.numel()
            x.grad.copy_(flat[offset:offset + n].view_as(x.grad))
            offset += n


# -- process worlds for the dry run and the tests -------------------------

def _spawned(rank: int, world: int, init_file: str, device_type: str, fn,
             args) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device_type),
                            init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), device="cpu", timeout: float = 300.0):
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes joined in one
    process group (gloo on the CPU, NCCL on CUDA, one GPU a rank) through
    a ``file://`` store in a temporary directory. Raises the first
    failure of any rank (the others are terminated) or TimeoutError after
    ``timeout`` seconds; ``fn`` must be importable by name."""
    import torch.multiprocessing as mp

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"{nprocs} ranks on cuda need {nprocs} GPUs, "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="kgt-world-") as tmp:
        ctx = mp.start_processes(
            _spawned, args=(nprocs, os.path.join(tmp, "store"), dev.type, fn,
                            tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nprocs}-rank world did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
