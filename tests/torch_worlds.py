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


def _serve_streams(cfg, params, reqs, **kw) -> tuple:
    """The streams of ``reqs`` (``(prompt, max_new)``) through a fresh
    port server, and the server."""
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    srv = DecodeServer(cfg, params, **kw)
    rids = [srv.submit(p, max_new=n) for p, n in reqs]
    srv.run()
    return [srv.result(r) for r in rids], srv


def job_serve_mesh8(rank: int, in_dir: str) -> dict:
    """The 8-rank world of tests/test_torch_serve_mesh.py: the server over
    (2, 1, 4) against the same server on one device (greedy, the per-token
    oracle, the prefix cache, the speculative server), and the cache
    layout over (1, 1, 8)."""
    from kubegpu_tpu_torch.workload.decode import cache_pspecs
    from kubegpu_tpu_torch.workload.model import params_from_jax

    inp = _load(in_dir)
    out = {}
    cfg = _cfg(inp["cfg"])
    full = inp["params"]
    mesh = spmd.make_mesh(8, 2, 1, 4, device="cpu")
    local = spmd.shard_params(full, cfg, mesh)
    one = params_from_jax(full, device="cpu")
    for name, kw in inp["serve_cases"].items():
        reqs = inp["prefix_reqs"] if "prefix_cache_size" in kw \
            else inp["reqs"]
        if kw.pop("oracle", False):
            os.environ["KGTPU_FUSED_SERVE"] = "0"
        try:
            spec = {"draft_params": local, "draft_cfg": cfg} \
                if "lookahead" in kw else {}
            got, srv = _serve_streams(cfg, local, reqs, mesh=mesh, **kw,
                                      **spec)
            spec = {"draft_params": one, "draft_cfg": cfg} if spec else {}
            want, ref = _serve_streams(cfg, one, reqs, **kw, **spec)
        finally:
            os.environ.pop("KGTPU_FUSED_SERVE", None)
        out[name] = {"mesh": got, "one": want,
                     "counts": [(s.prefix_hits, s.prefix_misses,
                                 s.spec_accepted, s.spec_proposed)
                                for s in (srv, ref)],
                     "cache_rows": tuple(srv.cache[0]["k"].shape)}
    try:
        _serve_streams(cfg, local, inp["reqs"], mesh=mesh, slots=3)
        out["odd_slots"] = None
    except ValueError as exc:
        out["odd_slots"] = str(exc)
    # the cache layout at tp = 8: two kv heads replicated, eight split
    gqa = _cfg(inp["gqa_cfg"])
    tp8 = spmd.make_mesh(8, 1, 1, 8, device="cpu")
    out["cache_pspecs"] = {
        kv: cache_pspecs(_cfg({**inp["gqa_cfg"], "n_kv_heads": kv}), tp8)
        for kv in (2, 8)}
    try:
        spmd.shard_params(full, gqa, tp8)
        out["gqa_refusal"] = None
    except ValueError as exc:
        out["gqa_refusal"] = str(exc)
    return out


def _forward_cases(cfg, mesh, full, tokens, decode_pos, decode_toks) -> dict:
    """This rank's logits of the sharded forward step: a prefill chunk at
    position 0, then per-row decode steps at ``decode_pos``."""
    from kubegpu_tpu_torch.workload.decode import (_data_rows, init_cache,
                                                   make_forward_step)

    local = spmd.shard_params(full, cfg, mesh)
    r0, n = _data_rows(mesh, tokens.shape[0])
    step = make_forward_step(cfg, mesh)
    cache = init_cache(cfg, tokens.shape[0], cfg.max_seq, "cpu", mesh)
    logits, cache = step(local, cache, torch.from_numpy(tokens[r0:r0 + n]),
                         0)
    out = {"rows": (r0, n), "prefill": logits.numpy(), "decode": []}
    for pos, tok in zip(decode_pos, decode_toks):
        logits, cache = step(local, cache,
                             torch.from_numpy(tok[r0:r0 + n, None]),
                             torch.from_numpy(pos[r0:r0 + n]))
        out["decode"].append(logits.numpy())
    return out


def job_mesh4(rank: int, in_dir: str) -> dict:
    """The 4-rank world of tests/test_torch_checkpoint_mesh.py: the sharded
    forward step, `make_generate`, speculative decoding and sampled
    serving over meshes of 4, and sharded checkpoints saved at (2, 1, 2)
    and restored at (2, 1, 2) and (1, 1, 4)."""
    from kubegpu_tpu_torch.workload.checkpoint import (
        adamw_state, adamw_template, load_train_state, restore_checkpoint,
        save_checkpoint, train_state_specs)
    from kubegpu_tpu_torch.workload.decode import make_generate
    from kubegpu_tpu_torch.workload.model import params_from_jax
    from kubegpu_tpu_torch.workload.speculative import \
        make_speculative_generate
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    inp = _load(in_dir)
    out = {}
    cfg = _cfg(inp["cfg"])
    full = inp["params"]
    meshes = {shape: spmd.make_mesh(4, *shape, device="cpu")
              for shape in ((2, 1, 2), (1, 1, 4), (4, 1, 1))}
    for shape in ((2, 1, 2), (1, 1, 4)):
        for name, kw, params in (("dense", inp["cfg"], full),
                                 ("moe", inp["moe_cfg"], inp["moe_params"])):
            out[("forward", shape, name)] = _forward_cases(
                _cfg(kw), meshes[shape], params, inp["tokens"],
                inp["decode_pos"], inp["decode_toks"])
    mesh = meshes[(2, 1, 2)]
    local = spmd.shard_params(full, cfg, mesh)
    out["generate"] = make_generate(cfg, mesh)(
        local, inp["tokens"], inp["n_new"]).numpy()
    try:
        make_generate(cfg, mesh)(local, inp["tokens"][:3], 2)
        out["odd_batch"] = None
    except ValueError as exc:
        out["odd_batch"] = str(exc)
    tp4 = meshes[(1, 1, 4)]
    t4 = spmd.shard_params(full, cfg, tp4)
    out["speculative"] = make_speculative_generate(cfg, cfg, k=3, mesh=tp4)(
        t4, t4, inp["tokens"][0].tolist(), inp["n_new"])
    # sampled serving with the rows split four ways and no sum changed
    dp4 = meshes[(4, 1, 1)]
    out["sampled"] = {
        "mesh": _serve_streams(cfg, spmd.shard_params(full, cfg, dp4),
                               inp["reqs"], mesh=dp4, **inp["sampled"])[0],
        "one": _serve_streams(cfg, params_from_jax(full, device="cpu"),
                              inp["reqs"], **inp["sampled"])[0]}

    # checkpoints: 2 steps at (2, 1, 2), save, 2 more; then restore at
    # (2, 1, 2) and (1, 1, 4) into fresh shards and take the same 2 steps
    specs = train_state_specs(spmd.param_pspecs(cfg))
    ckpt = os.path.join(in_dir, "ckpt")
    params = spmd.shard_params(full, cfg, mesh)
    step = make_train_step(cfg, mesh)
    opt, losses = None, []
    for i, batch in enumerate(inp["batches"]):
        params, opt, loss = step(params, opt, batch)
        losses.append(loss.item())
        if i == 1:
            save_checkpoint(ckpt, {"params": params,
                                   "opt_state": adamw_state(opt, params)},
                            2, mesh=mesh, specs=specs)
            out["saved"] = _numpy_tree(spmd.gather_tree(
                {"params": params, "opt_state": adamw_state(opt, params)},
                specs, mesh))
    out["losses"] = losses
    for shape in ((2, 1, 2), (1, 1, 4)):
        m = meshes[shape]
        fresh, opt, optimizer = init_sharded(
            torch.Generator().manual_seed(9), cfg, m)
        state, at = restore_checkpoint(
            ckpt, {"params": fresh, "opt_state": adamw_template(fresh)},
            mesh=m, specs=specs)
        load_train_state(opt, fresh, state)
        step = make_train_step(cfg, m, optimizer)
        resumed = []
        for batch in inp["batches"][at:]:
            fresh, opt, loss = step(fresh, opt, batch)
            resumed.append(loss.item())
        out[("resumed", shape)] = (at, resumed)
    # a rank that cannot read: every rank returns (None, -1), and the next
    # collective still meets
    like = {"params": local, "opt_state": adamw_template(local)}
    path = os.path.join(in_dir, "missing") if rank == 1 else ckpt
    state, at = restore_checkpoint(path, like, mesh=mesh, specs=specs)
    out["one_rank_unreadable"] = (state is None, at)
    dist.barrier()
    return out
