"""Whole runs of the tiny benchmark on the CPU: a sound run is correct, and
a run whose timed path is broken underneath comes out not correct, once
for each fault a cell can have (one chip: no exchange between chips to
leave out)."""

import json

import pytest
import torch

from perfbench.harness import runner, spec
from perfbench.tests import tiny

SEED = 2**31 + 101


# the tiny model's own limit for the training cell: its sound runs read
# change3_leaf about 0.002 (the committed limit is the full size's), the
# faults 0.2 and 1
TINY_TRAIN = {"mistral7b-train4k": {"change3_leaf": 0.01}}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"), limits=TINY_TRAIN)


def run(base, workload, seed=SEED):
    bench = json.loads((base.parent / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, workload, base)
    return runner.run(cell, seed, 1.0, False, "cpu", 0.0, base=base)


def wrap_train_step(monkeypatch, fault):
    from kubegpu_tpu_torch.workload import train as ktrain

    real = ktrain.make_train_step

    def make(cfg, *a, **kw):
        step = real(cfg, *a, **kw)

        def broken(params, opt, tokens):
            return fault(step, params, opt, tokens)
        return broken

    monkeypatch.setattr(ktrain, "make_train_step", make)


TRAIN = "mistral7b-train4k"
SERVE = ["mistral7b-chat", "mixtral8x7b-longprompt", "mistral7b-reasoning"]


@pytest.mark.parametrize("workload", [TRAIN] + SERVE)
def test_sound_run_is_correct(base, workload):
    r = run(base, workload)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"


def test_step_that_leaves_state_unchanged(base, monkeypatch):
    def unchanged(step, params, opt, tokens):
        from perfbench.harness.weights import leaves
        keep = [p.detach().clone() for _, p in leaves(params)]
        params, opt, loss = step(params, opt, tokens)
        with torch.no_grad():
            for (_, p), k in zip(leaves(params), keep):
                p.copy_(k)
        return params, opt, loss

    wrap_train_step(monkeypatch, unchanged)
    r = run(base, TRAIN)
    assert not r["correct"]
    assert r["check"]["change3_leaf"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(base, monkeypatch):
    def half(step, params, opt, tokens):
        return step(params, opt, tokens[:len(tokens) // 2])

    wrap_train_step(monkeypatch, half)
    r = run(base, TRAIN)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("workload", SERVE)
def test_token_altered_where_produced(base, monkeypatch, workload):
    from kubegpu_tpu_torch.workload import decode, serve

    real = decode._select_token_rows

    def off_by_one(logits, *a, **kw):
        return (real(logits, *a, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(decode, "_select_token_rows", off_by_one)
    monkeypatch.setattr(serve, "_select_token_rows", off_by_one)
    r = run(base, workload)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("workload", SERVE)
def test_answer_cut_short(base, monkeypatch, workload):
    """The server stops each answer at half its tokens: every finished
    request is owed the rest, so the run fails however fast it reads."""
    from kubegpu_tpu_torch.workload import serve

    real = serve.DecodeServer.submit

    def half(self, prompt, max_new):
        return real(self, prompt, max(1, max_new // 2))

    monkeypatch.setattr(serve.DecodeServer, "submit", half)
    r = run(base, workload)
    assert not r["correct"] and r["failed"] > 0, (r["failed"], r["check"])


@pytest.mark.parametrize("workload", SERVE)
def test_request_dropped(base, monkeypatch, workload):
    """The server finishes every third request at admission with no
    tokens: each such request counts as failed."""
    from kubegpu_tpu_torch.workload import serve

    real = serve.DecodeServer._admit

    def drop(self, slot, req):
        if req.rid % 3 == 1:
            req.done = True
            self._free.append(slot)
            return
        real(self, slot, req)

    monkeypatch.setattr(serve.DecodeServer, "_admit", drop)
    r = run(base, workload)
    assert not r["correct"] and r["failed"] > 0, (r["failed"], r["check"])
