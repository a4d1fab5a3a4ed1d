"""The port's serving path under a profiler: the workload ranges of
`obs.trace.device_span` (``kgt.serve.admit`` / ``decode`` / ``commit``
around the server's stages, ``kgt.model.attn`` / ``ffn`` / ``moe`` inside
each layer of the forward step), the per-request timeline
(`DecodeServer.timeline`) and ``SERVE_TTFT_MS`` taken when ``step()``
returns a request's first token.

With no profiler running a span is one shared no-op context and never
reaches ``record_function``; its cost is measured on a card, not here
(timing tests are flaky on busy workers)."""

import time

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.obs import trace  # noqa: E402
from kubegpu_tpu_torch.workload.model import (TransformerConfig,  # noqa: E402
                                              init_params)
from kubegpu_tpu_torch.workload.serve import DecodeServer  # noqa: E402

DENSE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, attn_impl="xla", dtype="float32")
MOE = dict(DENSE, n_experts=4, moe_top_k=2)
DRAFT = dict(DENSE, n_layers=1)
CHUNK = 4
PROMPTS = ([1, 2, 3], [7, 8, 9, 10, 11])
SPANS = ("kgt.serve.admit", "kgt.serve.decode", "kgt.serve.commit",
         "kgt.model.attn", "kgt.model.ffn", "kgt.model.moe")


def _params(cfg, seed=0):
    return init_params(torch.Generator().manual_seed(seed), cfg)


@pytest.fixture(scope="module")
def dense():
    cfg = TransformerConfig(**DENSE)
    return cfg, _params(cfg)


def _server(cfg, params, spec=False, **kw):
    if spec:
        dcfg = TransformerConfig(**DRAFT)
        kw.update(draft_cfg=dcfg, draft_params=_params(dcfg, 1),
                  lookahead=2, spec_rounds=2)
    return DecodeServer(cfg, params, slots=2, prefill_buckets=(8, 16),
                        chunk=CHUNK, **kw)


def _traced_step(srv) -> list:
    """The ``kgt.*`` ranges of one traced ``step()`` (after submitting
    `PROMPTS`) as ``(name, [enclosing kgt names, outermost first])``."""
    for p in PROMPTS:
        srv.submit(p, max_new=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv.step()
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU or \
                not e.name.startswith("kgt."):
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("kgt."):
                up.append(p.name)
            p = p.cpu_parent
        out.append((e.name, up[::-1]))
    return out


def _under(ranges, name, parent) -> int:
    return sum(1 for n, up in ranges if n == name and up == [parent])


# -- the helper ---------------------------------------------------------------

def test_device_span_off_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.device_span("kgt.a"), trace.device_span("kgt.b")
    assert a is b
    with a as got:
        assert got is None
    with pytest.raises(ValueError):
        with trace.device_span("kgt.c"):
            raise ValueError("a span swallows nothing")


def test_device_span_on_opens_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = trace.device_span("kgt.test.range")
        assert span is not trace.device_span("kgt.test.other")
        with span:
            torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("kgt.test.range") == 1
    assert "kgt.test.other" not in names
    # outside the profiler again: the shared no-op
    assert trace.device_span("kgt.x") is trace.device_span("kgt.y")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model", ["dense", "moe", "spec"])
def test_spans_off_never_call_record_function(monkeypatch, fused, model):
    """A whole drain with no profiler running reaches ``record_function``
    nowhere: the helper reads the flag and stops there."""
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1" if fused else "0")
    cfg = TransformerConfig(**(MOE if model == "moe" else DENSE))
    srv = _server(cfg, _params(cfg), spec=model == "spec")
    rids = [srv.submit(p, max_new=6) for p in PROMPTS]
    srv.run()
    assert [len(srv.result(r)) for r in rids] == [6, 6]


# -- spans in the serving path ------------------------------------------------

def test_fused_step_spans_nest_as_documented(dense):
    """One fused step admitting two requests: each admission's prefill
    runs every layer under ``kgt.serve.admit``, the chunk's ``CHUNK``
    forward steps under ``kgt.serve.decode``, then one commit."""
    cfg, params = dense
    ranges = _traced_step(_server(cfg, params))
    layers = cfg.n_layers
    names = [n for n, _ in ranges]
    assert names.count("kgt.serve.admit") == len(PROMPTS)
    assert names.count("kgt.serve.decode") == 1
    assert names.count("kgt.serve.commit") == 1
    for inner in ("kgt.model.attn", "kgt.model.ffn"):
        assert _under(ranges, inner, "kgt.serve.admit") == \
            layers * len(PROMPTS)
        assert _under(ranges, inner, "kgt.serve.decode") == layers * CHUNK
    assert "kgt.model.moe" not in names
    # the server's stages are outermost, and the commit holds no layer
    assert all(up == [] for n, up in ranges if n.startswith("kgt.serve."))
    assert not any("kgt.serve.commit" in up for _, up in ranges)
    assert set(names) <= set(SPANS)


def test_moe_layers_are_moe_spans():
    cfg = TransformerConfig(**MOE)
    ranges = _traced_step(_server(cfg, _params(cfg)))
    names = [n for n, _ in ranges]
    assert "kgt.model.ffn" not in names
    assert _under(ranges, "kgt.model.moe", "kgt.serve.admit") == \
        cfg.n_layers * len(PROMPTS)
    assert _under(ranges, "kgt.model.moe", "kgt.serve.decode") == \
        cfg.n_layers * CHUNK


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("spec", [False, True])
def test_every_data_plane_has_decode_and_commit(dense, monkeypatch, fused,
                                                spec):
    """The fused chunk, the per-token oracle and both speculative paths
    each open one decode and one commit a step, with the layers' spans
    inside the decode only."""
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1" if fused else "0")
    cfg, params = dense
    ranges = _traced_step(_server(cfg, params, spec=spec))
    names = [n for n, _ in ranges]
    assert names.count("kgt.serve.decode") == 1
    assert names.count("kgt.serve.commit") == 1
    assert _under(ranges, "kgt.model.attn", "kgt.serve.decode") > 0
    assert _under(ranges, "kgt.model.ffn", "kgt.serve.decode") == \
        _under(ranges, "kgt.model.attn", "kgt.serve.decode")


# -- the per-request timeline and TTFT ---------------------------------------

def test_timeline_orders_stages_and_goes_with_the_result(dense):
    cfg, params = dense
    srv = _server(cfg, params)
    t0 = time.perf_counter()
    rid = srv.submit([1, 2, 3], max_new=3)
    tl = srv.timeline(rid)
    assert tl["admit"] is None and tl["first"] is None
    assert t0 <= tl["submit"] <= time.perf_counter()
    srv.step()
    tl = srv.timeline(rid)
    assert tl["submit"] <= tl["admit"] <= tl["first"] <= time.perf_counter()
    srv.run()
    assert srv.timeline(rid) == tl          # later steps stamp nothing
    assert srv.result(rid) is not None
    with pytest.raises(KeyError):
        srv.timeline(rid)
    with pytest.raises(KeyError):
        srv.timeline(rid + 1)


def test_ttft_is_observed_when_step_returns_the_first_token(dense):
    """``SERVE_TTFT_MS`` counts the decode that follows the admission in
    the same step: a caller sees the first token only when ``step()``
    returns."""
    cfg, params = dense
    srv = _server(cfg, params)
    real, ends = srv._fused_step, []

    def slow(active):
        out = real(active)
        time.sleep(0.05)
        ends.append(time.perf_counter())
        return out

    srv._fused_step = slow
    metrics.reset_all()
    rids = [srv.submit(p, max_new=6) for p in PROMPTS]
    srv.step()
    assert metrics.SERVE_TTFT_MS.n == len(PROMPTS)
    tls = [srv.timeline(r) for r in rids]
    assert all(tl["first"] < ends[0] for tl in tls)
    floor_ms = sum(ends[0] - tl["submit"] for tl in tls) * 1e3
    assert metrics.SERVE_TTFT_MS.total >= floor_ms
    srv.run()
    assert metrics.SERVE_TTFT_MS.n == len(PROMPTS)   # once a request
    metrics.reset_all()
