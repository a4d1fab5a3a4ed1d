"""The port's counterparts of ``__graft_entry__.py``: ``entry()``, the
flagship model's forward pass with its example arguments, and
``dryrun_multichip(n)``, full sharded training steps and sharded serving
over an n-rank mesh."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kubegpu_tpu_torch._device import resolve_device
from kubegpu_tpu_torch.workload.model import (TransformerConfig, init_params,
                                              make_forward)


def entry(device=None):
    """``(forward, (params, tokens))``: the reference entry's config on
    tokens ``[2, 128]``, on ``cuda`` unless ``device`` says otherwise. On
    CUDA, attention resolves to the flash kernel (T is a multiple of
    128)."""
    dev = resolve_device(device)
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=8, n_layers=4,
                            d_ff=1024, max_seq=512)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=dev)
    return make_forward(cfg), (params, tokens)


def _dryrun_factors(n: int) -> tuple:
    """(dp, sp, tp) of the dry run's mesh (``__graft_entry__.py:71-79``)."""
    if n % 8 == 0:
        return n // 8, 2, 4
    if n % 4 == 0:
        return n // 4, 2, 2
    if n % 2 == 0:
        return n // 2, 2, 1
    return n, 1, 1


def _serving_factors(n: int) -> tuple:
    """(dp, tp) of the serving leg's mesh. The reference serves over
    ``(2, 1, min(4, n/2))`` devices, a part of its n; the port's mesh
    spans the whole group (`spmd.make_mesh`), so an even ``n`` takes the
    largest ``tp <= 4`` dividing ``n/2`` (``n/2`` itself up to 4) and
    ``dp = n/tp``; an odd ``n`` is all data parallel."""
    if n % 2:
        return n, 1
    tp = next(t for t in (4, 2, 1) if (n // 2) % t == 0)
    return n // tp, tp


def _serving_leg(n_devices: int, device_type: str) -> None:
    """``__graft_entry__.py:105-143``: the sharded `make_generate`, the
    server and its speculative mode (draft = target, lookahead 3), each
    equal token for token to the same call without a mesh on this rank
    (float32)."""
    import math

    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.decode import make_generate
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    dp, tp = _serving_factors(n_devices)
    mesh = spmd.make_mesh(n_devices, dp=dp, sp=1, tp=tp, device=device_type)
    dev = spmd.mesh_device(mesh)
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_seq=64, dtype="float32")
    full = init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    local = spmd.shard_params(full, cfg, mesh)
    # the reference's four rows and four slots, repeated until dp divides
    reps = dp // math.gcd(4, dp)
    batch = np.tile([[1, 2, 3, 4], [9, 8, 7, 6], [2, 7, 1, 8],
                     [5, 5, 5, 5]], (reps, 1))
    sharded = make_generate(cfg, mesh)(local, batch, 6)
    single = make_generate(cfg)(full, torch.from_numpy(batch).to(dev), 6)
    if not torch.equal(sharded, single):
        raise AssertionError("sharded decode diverged")

    def serve_tokens(params, **kw):
        srv = DecodeServer(cfg, params, slots=4 * reps, prefill_buckets=(8,),
                           **kw)
        rids = [srv.submit(list(p), max_new=5) for p in
                ([1, 2, 3], [9, 8, 7, 6], [2, 7], [5, 5, 5])]
        srv.run()
        return [srv.result(r) for r in rids]

    want = serve_tokens(full)
    if serve_tokens(local, mesh=mesh) != want:
        raise AssertionError("sharded server diverged")
    if serve_tokens(local, mesh=mesh, draft_params=local, draft_cfg=cfg,
                    lookahead=3) != want:
        raise AssertionError("sharded speculative server diverged")


def _dryrun_rank(rank: int, n_devices: int, device_type: str) -> None:
    """The dry run's legs on this rank of an n-rank group."""
    from torch.distributed.device_mesh import init_device_mesh

    from kubegpu_tpu_torch.workload.pipeline import (make_pipelined_apply,
                                                     stack_stage_params)
    from kubegpu_tpu_torch.workload.spmd import make_mesh, mesh_device
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    dp, sp, tp = _dryrun_factors(n_devices)
    mesh = make_mesh(n_devices, dp=dp, sp=sp, tp=tp, device=device_type)
    dev = mesh_device(mesh)

    def run_step(**kw):
        cfg = TransformerConfig(**{**dict(vocab=64, d_model=32, n_heads=4,
                                          n_layers=2, d_ff=64, max_seq=64),
                                   **kw})
        params, opt_state, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(0), cfg, mesh)
        step = make_train_step(cfg, mesh, optimizer)
        tokens = np.zeros((max(2, 2 * dp), 33), np.int64)
        _, _, loss = step(params, opt_state, tokens)
        if not torch.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss.item()} for {kw}")

    # dense dp x sp x tp with ring attention on the seq axis
    run_step()
    # the same under per-layer remat "dots"
    run_step(remat="dots")
    # Ulysses: tp shards the heads, sp all-to-alls them
    run_step(n_heads=max(4, sp * tp), seq_impl="ulysses")
    # expert parallel: the experts split over the model axis
    run_step(n_experts=max(2, tp))

    # pipeline parallel: the GPipe schedule over a stage axis (2 stages,
    # replicated over the rest of an even world)
    if n_devices >= 2:
        stages = 2 if n_devices % 2 == 0 else n_devices
        pmesh = init_device_mesh(device_type, (n_devices // stages, stages),
                                 mesh_dim_names=("data", "stage"))
        d = 16
        gen = torch.Generator(device=dev).manual_seed(0)
        per_stage = [{"w": torch.randn((d, d), generator=gen, device=dev)
                      * 0.1} for _ in range(stages)]

        def stage_fn(p, x):
            return x + torch.tanh(x @ p["w"])

        out = make_pipelined_apply(stage_fn, pmesh, 4)(
            stack_stage_params(per_stage),
            torch.ones((4, 2, 8, d), device=dev))
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite pipeline output")

    _serving_leg(n_devices, device_type)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Full sharded training steps over an ``n_devices``-rank mesh: a dense
    dp x sp x tp step with ring attention, the same under remat "dots",
    one with Ulysses, an expert-parallel MoE step, and a 2-stage pipeline
    (the training legs of ``__graft_entry__.py:57-103, :145-169``); then
    the serving leg (:105-143): the sharded `make_generate`, the server
    and its speculative mode over a dp x tp mesh (`_serving_factors`: the
    reference's ``(2, 1, min(4, n/2))`` where ``n/2 <= 4``), each equal
    to one device token for token.

    Inside a formed process group of ``n_devices`` ranks (every rank
    calling it) it runs the legs there; otherwise it spawns
    ``n_devices`` processes joined in one group: gloo for
    ``device="cpu"``, NCCL on ``cuda`` (the default), which needs that
    many GPUs and raises without them."""
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a process "
                             f"group of {dist.get_world_size()}")
        _dryrun_rank(dist.get_rank(), n_devices, dev.type)
        return
    from kubegpu_tpu_torch.workload.spmd import spawn

    spawn(_dryrun_rank, n_devices, args=(n_devices, dev.type),
          device=dev.type)
