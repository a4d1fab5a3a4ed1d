"""A training cell: ``make_train_step`` with ``default_optimizer``, fed by
the program's token loader, over a corpus written from the seed.

Set-up builds the one step object, its weights and optimizer, and drives
it through the first ``check_steps`` steps by the window's own call and
feed; those steps warm every shape and are the ones the reference
follows. The window then runs whole steps until ``seconds`` have passed,
reading no loss inside it; the losses are read once the device is done.
After the window the program's state is freed and the reference trains
three steps from the same weights on the same rows, worked out again
from the raw corpus.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from pathlib import Path

import torch

from . import compare, shard, traffic, weights
from .common import TRACE_SECONDS, Tracer, clock, free, span, sync
from .port import port_config
from .spec import Cell, derive_seed

CHECK_STEPS = 3


def _change_norms(m, seed: int, params: dict, device) -> dict:
    """Per leaf, the norm of the parameters' change since the seed's
    weights (drawn again)."""
    p0 = dict(weights.leaves(weights.make_params(m, seed, device)))
    out = {k: float((v.detach() - p0[k]).norm())
           for k, v in weights.leaves(params)}
    del p0
    return out


def _reference(cell: Cell, seed: int, batches: list, device,
               quant=None, rows_kept=None) -> dict:
    """Three reference AdamW steps from the seed's weights: the losses,
    the first gradient's and the three steps' change's leaf norms."""
    from perfbench.reference import AdamW, Ref, strict_float32

    strict_float32()
    m, mix = cell.model, cell.mix
    ref = Ref(m, quant=quant)
    params = weights.make_params(m, seed, device)
    named = weights.leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    opt = AdamW([p for _, p in named], lr=mix["lr"])
    losses, grad1 = [], None
    aux = float(mix.get("aux_weight", 0.01)) if m.moe else 0.0
    for i, rows in enumerate(batches):
        if rows_kept is not None:
            rows = rows[:rows_kept]
        loss = ref.loss(params, torch.from_numpy(rows).to(device), aux)
        loss.backward()
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = {k: float(p.grad.norm()) for k, p in named}
        opt.step()
        for _, p in named:
            p.grad = None
    del opt
    free()
    change = _change_norms(m, seed, params, device)
    del params, named
    free()
    return {"losses": losses, "grad1": grad1, "change3": change}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    from kubegpu_tpu_torch.workload import data as kdata
    from kubegpu_tpu_torch.workload import train as ktrain

    m, mix = cell.model, cell.mix
    batch, seq = int(mix["batch"]), int(mix["seq"])
    cfg = port_config(m, max_seq=seq,
                      aux_weight=float(mix.get("aux_weight", 0.01)))
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-",
                                dir=os.environ.get("TMPDIR")))
    try:
        path = tmp / "corpus.kgt"
        shard.write(path, traffic.corpus(mix, seed, m.vocab))
        loader_seed = derive_seed(seed, "loader")
        loader = kdata.make_loader([str(path)], batch, seq, seed=loader_seed)

        params = weights.make_params(m, seed, device)
        step = ktrain.make_train_step(
            cfg, optimizer=ktrain.default_optimizer(mix["lr"]))
        opt = None
        losses = []
        grad1 = None
        for i in range(CHECK_STEPS):
            params, opt, loss = step(params, opt, next(loader))
            losses.append(float(loss.detach()))
            if i == 0:
                b1 = opt.param_groups[0]["betas"][0]
                grad1 = {k: float((opt.state[p]["exp_avg"] / (1 - b1))
                                  .norm())
                         for k, p in weights.leaves(params)}
        change3 = _change_norms(m, seed, params, device)
        free()
        sync(device)
        setup_s = clock() - t_start

        if trace:
            seconds = min(seconds, TRACE_SECONDS)
        steps = 0
        window_losses = []
        with Tracer(trace, device) as tracer:
            tracer.warm()
            tracer.start()
            t0 = clock()
            while True:
                with span("loader"):
                    tokens = next(loader)
                with span("train_step"):
                    params, opt, loss = step(params, opt, tokens)
                window_losses.append(loss.detach())
                steps += 1
                if clock() - t0 >= seconds:
                    break
            with span("drain"):
                sync(device)
            t1 = clock()
            tracer.stop()
        finite = torch.isfinite(torch.stack(window_losses)).cpu()
        peak = int(torch.cuda.max_memory_allocated(device)) \
            if torch.device(device).type == "cuda" else 0
        loader.close()
        del step, opt, params, window_losses, loader
        free()

        batches = shard.rows([shard.read(path)], batch, seq, loader_seed,
                             CHECK_STEPS)
        prog = {"losses": losses, "grad1": grad1, "change3": change3}
        ref = _reference(cell, seed, batches, device)
        numbers = compare.train_numbers(prog, ref)
        readings = None
        if control:
            ctl = _reference(cell, seed, batches, device, quant="fp8")
            half = _reference(cell, seed, batches, device,
                              rows_kept=batch // 2)
            readings = {"program": numbers,
                        "worst_grad1": compare.worst_leaves(grad1,
                                                            ref["grad1"]),
                        "worst_change3": compare.worst_leaves(
                            change3, ref["change3"]),
                        "worst_grad1_fp8": compare.worst_leaves(
                            ctl["grad1"], ref["grad1"]),
                        "control_numbers": compare.train_numbers(ctl, ref),
                        "fault_half_batch": compare.train_numbers(half, ref),
                        "losses": {"program": losses, "reference":
                                   ref["losses"], "fp8": ctl["losses"]}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n_bad = int((~finite).sum())
    return {"kind": "train", "setup_s": setup_s, "window_s": t1 - t0,
            "steps": steps, "batch": batch, "seq": seq,
            "tokens": steps * batch * seq, "attempted": CHECK_STEPS + steps,
            "failed": n_bad + sum(not math.isfinite(x) for x in losses),
            "memory_peak_bytes": peak, "numbers": numbers,
            "trace": tracer.summary, "trace_seconds": tracer.seconds,
            "readings": readings}
