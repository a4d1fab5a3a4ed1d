"""The port's continuous-batching server (kubegpu_tpu_torch.workload.serve)
held against the JAX package's `DecodeServer`: greedy per-request streams
equal the JAX server's token for token, through the scenarios of
tests/test_serve.py and tests/test_serve_fused.py (mixed prompt lengths,
slot recycling, late admission, EOS, eviction on read, fused chunk
against the per-token oracle, chunk sizes, serving metrics), the
speculative server (greedy against the JAX speculative server) and the
prefix cache (hits, misses and streams against the JAX server's). Sampled
streams cannot match threefry's bits; they are held to the fused/oracle,
chunk-size, admission-order and slot invariance that position-keyed
draws give. Also the serving CLI on the CPU and the smoke script's
refusal without a GPU.

Greedy streams are prefix-stable (a request's first n tokens do not
depend on its max_new), so one JAX server run of 12 tokens per distinct
prompt is the reference for every scenario."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload.serve import DecodeServer as JaxServer  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload.serve import DecodeServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, attn_impl="xla", dtype="float32")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13], [5] * 12, [2, 7],
           [7, 8, 9, 10, 11], [9, 8, 7], [5, 6], list(range(1, 12))] \
    + [[i + 1, i + 2] for i in range(5)]
REF_LEN = 12


@pytest.fixture(scope="module")
def setup():
    """(cfg, port params, {prompt: JAX server's 12-token greedy stream})."""
    jcfg = jmodel.TransformerConfig(**SMALL)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    srv = JaxServer(jcfg, jp, slots=4, prefill_buckets=(8, 16))
    prompts = list({tuple(p): None for p in PROMPTS})
    rids = [srv.submit(list(p), max_new=REF_LEN) for p in prompts]
    srv.run()
    ref = {p: srv.result(r) for p, r in zip(prompts, rids)}
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return tmodel.TransformerConfig(**SMALL), params, ref


def _want(ref, prompt, n, eos=None):
    out = ref[tuple(prompt)][:n]
    return out[:out.index(eos) + 1] if eos in out else out


def _serve(cfg, params, reqs, **kw):
    srv = DecodeServer(cfg, params, **kw)
    rids = [srv.submit(p, max_new=n) for p, n in reqs]
    srv.run()
    return [srv.result(r) for r in rids], srv


def test_matches_jax_server_per_request(setup):
    """Requests of different prompt lengths decoding in one batch each
    emit the JAX server's stream."""
    cfg, params, ref = setup
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13], [5] * 12]
    outs, _ = _serve(cfg, params, [(p, 6) for p in prompts], slots=2,
                     prefill_buckets=(8, 16))
    for p, toks in zip(prompts, outs):
        assert toks == _want(ref, p, 6), p


def test_slot_recycling_more_requests_than_slots(setup):
    cfg, params, ref = setup
    reqs = [([i + 1, i + 2], 3) for i in range(5)]
    outs, _ = _serve(cfg, params, reqs, slots=2, prefill_buckets=(8,))
    assert outs == [_want(ref, p, n) for p, n in reqs]


def test_late_submission_joins_running_batch(setup):
    cfg, params, ref = setup
    srv = DecodeServer(cfg, params, slots=2, prefill_buckets=(8,), chunk=2)
    r1 = srv.submit([1, 2, 3], max_new=8)
    srv.step()
    srv.step()
    r2 = srv.submit([9, 8, 7], max_new=4)
    srv.run()
    assert srv.result(r1) == _want(ref, [1, 2, 3], 8)
    assert srv.result(r2) == _want(ref, [9, 8, 7], 4)


def test_result_evicts_and_rejects_unknown_rid(setup):
    cfg, params, _ = setup
    srv = DecodeServer(cfg, params, slots=1, prefill_buckets=(8,))
    rid = srv.submit([5, 6], max_new=3)
    assert srv.result(rid) is None          # in flight: no eviction
    srv.run()
    assert len(srv.result(rid)) == 3
    assert not srv._requests                 # evicted after the read
    with pytest.raises(KeyError, match="already read"):
        srv.result(rid)
    with pytest.raises(KeyError, match="unknown request id 999"):
        srv.result(999)


def test_eos_frees_slot_early(setup):
    cfg, params, ref = setup
    first = ref[(1, 2, 3)][0]
    outs, _ = _serve(cfg, params, [([1, 2, 3], 10)], slots=1,
                     eos_id=first, prefill_buckets=(8,))
    assert outs == [[first]]


def test_fused_matches_oracle_and_jax(setup, monkeypatch):
    """The fused chunk path and the per-token oracle (KGTPU_FUSED_SERVE=0)
    emit identical streams, equal to the JAX server's."""
    cfg, params, ref = setup
    reqs = [(p, 9) for p in ([1, 2, 3], [7, 8, 9, 10, 11], [5] * 12,
                             [2, 7])]
    kw = dict(slots=2, prefill_buckets=(8, 16), chunk=4)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1")
    fused, srv = _serve(cfg, params, reqs, **kw)
    assert srv.fused
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "0")
    oracle, srv0 = _serve(cfg, params, reqs, **kw)
    assert not srv0.fused
    assert fused == oracle == [_want(ref, p, n) for p, n in reqs]


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_streams_do_not_depend_on_chunk_size(setup, chunk):
    cfg, params, ref = setup
    reqs = [([1, 2, 3], 10), ([9, 8, 7], 10), ([5, 6], 7)]
    outs, _ = _serve(cfg, params, reqs, slots=2, prefill_buckets=(8,),
                     chunk=chunk)
    assert outs == [_want(ref, p, n) for p, n in reqs]


def test_mid_chunk_eos_freezes_row_and_frees_slot(setup):
    cfg, params, ref = setup
    stream = ref[(1, 2, 3)]
    # EOS = a token whose first appearance is at index >= 2: inside the
    # first chunk (chunk=8 spans indices 1..8), never at admission
    eos = next(t for i, t in enumerate(stream)
               if i >= 2 and t not in stream[:i])
    outs, _ = _serve(cfg, params, [([1, 2, 3], 12), ([9, 8, 7], 4)],
                     slots=1, eos_id=eos, prefill_buckets=(8,), chunk=8)
    assert outs[0] == _want(ref, [1, 2, 3], 12, eos)
    assert outs[1] == _want(ref, [9, 8, 7], 4, eos)


def test_admission_mid_stream_preserves_other_slots(setup):
    cfg, params, ref = setup
    srv = DecodeServer(cfg, params, slots=2, prefill_buckets=(8,), chunk=3)
    r1 = srv.submit([1, 2, 3], max_new=12)
    srv.step()                          # r1 running, r2 not yet known
    r2 = srv.submit([9, 8, 7], max_new=5)
    srv.run()
    assert srv.result(r1) == _want(ref, [1, 2, 3], 12)
    assert srv.result(r2) == _want(ref, [9, 8, 7], 5)


def test_prompt_beyond_configured_buckets_uses_max_seq_bucket(setup):
    cfg, params, ref = setup
    prompt = list(range(1, 12))  # 11 tokens > largest configured bucket 8
    outs, srv = _serve(cfg, params, [(prompt, 3)], slots=1,
                       prefill_buckets=(8,))
    assert srv.buckets == (8, 64)
    assert outs == [_want(ref, prompt, 3)]


def test_serving_metrics_observed(setup):
    cfg, params, _ = setup
    metrics.reset_all()
    reqs = [(p, 6) for p in ([1, 2, 3], [7, 8, 9, 10, 11], [5] * 12,
                             [2, 7])]
    _serve(cfg, params, reqs, slots=2, prefill_buckets=(8, 16), chunk=4)
    assert metrics.SERVE_TTFT_MS.n == len(reqs)
    assert metrics.SERVE_ITL_MS.n > 0
    assert metrics.SERVE_ITL_MS.percentile(0.5) >= 0
    assert metrics.SERVE_QUEUE_DEPTH.value == 0       # drained
    assert 0.0 <= metrics.SERVE_SLOT_UTILIZATION.value <= 1.0
    metrics.reset_all()
    assert metrics.SERVE_TTFT_MS.n == 0


def test_validation(setup):
    cfg, params, _ = setup
    srv = DecodeServer(cfg, params, slots=1, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        srv.submit([1, 2], max_new=0)
    with pytest.raises(ValueError, match="max_seq"):
        srv.submit([1] * 60, max_new=10)
    with pytest.raises(ValueError, match="temperature"):
        DecodeServer(cfg, params, top_k=3)
    with pytest.raises(ValueError, match="top_p"):
        DecodeServer(cfg, params, temperature=1.0, top_p=0.0)
    with pytest.raises(ValueError, match="slots"):
        DecodeServer(cfg, params, slots=0)
    with pytest.raises(ValueError, match="chunk"):
        DecodeServer(cfg, params, chunk=0)
    with pytest.raises(ValueError, match="spec_rounds"):
        DecodeServer(cfg, params, spec_rounds=0)
    with pytest.raises(ValueError, match="go together"):
        DecodeServer(cfg, params, draft_params=params)


def test_out_of_slice_options_raise(setup):
    """Nothing is out of the slice now: a mesh builds (an object that is
    not one raises TypeError); sampling, a draft and the prefix cache
    build."""
    from tests.torch_worlds import single_rank_mesh

    cfg, params, _ = setup
    with pytest.raises(TypeError, match="DeviceMesh"):
        DecodeServer(cfg, params, mesh=object())
    with single_rank_mesh() as mesh:
        assert DecodeServer(cfg, params, mesh=mesh).mesh is mesh
    assert DecodeServer(cfg, params, temperature=0.8).sampling
    assert DecodeServer(cfg, params, draft_params=params, draft_cfg=cfg).spec
    assert DecodeServer(cfg, params, prefix_cache_size=2) \
        .prefix_cache_size == 2


DRAFT = dict(SMALL, n_layers=1, d_model=16, d_ff=32)
SAMPLED = dict(temperature=0.9, top_p=0.85, rng=7)


@pytest.fixture(scope="module")
def draft():
    """(JAX draft config and params, port draft config and params)."""
    jcfg = jmodel.TransformerConfig(**DRAFT)
    jp = jmodel.init_params(jax.random.PRNGKey(9), jcfg)
    return (jcfg, jp, tmodel.TransformerConfig(**DRAFT),
            tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"))


def _jax_serve(reqs, **kw):
    jcfg = jmodel.TransformerConfig(**SMALL)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    srv = JaxServer(jcfg, jp, **kw)
    rids = [srv.submit(p, max_new=n) for p, n in reqs]
    srv.run()
    return [srv.result(r) for r in rids], srv


@pytest.mark.parametrize("fused", ["1", "0"])
def test_spec_server_matches_jax_greedy(setup, draft, monkeypatch, fused):
    """The speculative server, greedy, on both data planes: the JAX
    speculative server's streams and acceptance tallies, which are the
    target's greedy streams."""
    cfg, params, ref = setup
    jdc, jdp, tdc, tdp = draft
    reqs = [([1, 2, 3], 8), ([9, 8, 7], 8), ([5] * 12, 8), ([2, 7], 5)]
    kw = dict(slots=2, prefill_buckets=(8, 16), lookahead=3, spec_rounds=2)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", fused)
    outs, srv = _serve(cfg, params, reqs, draft_params=tdp, draft_cfg=tdc,
                       **kw)
    want, jsrv = _jax_serve(reqs, draft_params=jdp, draft_cfg=jdc, **kw)
    assert outs == want == [_want(ref, p, n) for p, n in reqs]
    assert (srv.spec_accepted, srv.spec_proposed) == \
        (jsrv.spec_accepted, jsrv.spec_proposed)


@pytest.mark.parametrize("rounds", [1, 3])
def test_spec_self_draft_greedy_rounds(setup, rounds):
    """Draft == target accepts every proposal and, whatever the rounds a
    dispatch, emits the greedy streams."""
    cfg, params, ref = setup
    reqs = [([1, 2, 3], 7), ([7, 8, 9, 10, 11], 7), ([2, 7], 7)]
    outs, srv = _serve(cfg, params, reqs, slots=2, prefill_buckets=(8, 16),
                       draft_params=params, draft_cfg=cfg, lookahead=3,
                       spec_rounds=rounds)
    assert outs == [_want(ref, p, n) for p, n in reqs]
    assert srv.spec_acceptance == 1.0


def test_fused_matches_oracle_sampled(setup, monkeypatch):
    """Sampled: the fused chunk and the per-token oracle draw the same
    tokens (float32, the same position-keyed selection on both)."""
    cfg, params, _ = setup
    reqs = [(p, 7) for p in ([1, 2, 3], [7, 8, 9, 10, 11], [5] * 12,
                             [2, 7])]
    kw = dict(slots=2, prefill_buckets=(8, 16), chunk=4, **SAMPLED)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1")
    fused, _ = _serve(cfg, params, reqs, **kw)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "0")
    oracle, _ = _serve(cfg, params, reqs, **kw)
    assert fused == oracle and all(len(t) == 7 for t in fused)
    greedy, _ = _serve(cfg, params, reqs, slots=2, prefill_buckets=(8, 16))
    assert fused != greedy


def test_sampled_streams_do_not_depend_on_chunk_order_or_slot(setup):
    """A request's sampled stream is a function of (rng, rid, prompt):
    the same under chunk sizes 2, 5 and 16, under the reverse admission
    order (each request keeps its rid), and alone in a one-slot server
    when it is the first request."""
    cfg, params, _ = setup
    reqs = [([3, 1, 4], 10), ([2, 6, 5, 3], 10), ([8, 8], 6)]
    kw = dict(prefill_buckets=(8,), temperature=1.0, top_k=12, rng=5)
    outs = [_serve(cfg, params, reqs, slots=2, chunk=c, **kw)[0]
            for c in (2, 5, 16)]
    assert outs[0] == outs[1] == outs[2]
    srv = DecodeServer(cfg, params, slots=2, **kw)
    rids = [srv.submit(p, max_new=n) for p, n in reqs]
    srv._queue.reverse()
    srv.run()
    assert [srv.result(r) for r in rids] == outs[0]
    alone, _ = _serve(cfg, params, reqs[:1], slots=1, **kw)
    assert alone[0] == outs[0][0]


def test_sampled_admission_mid_stream_preserves_other_slots(setup):
    cfg, params, _ = setup
    srv = DecodeServer(cfg, params, slots=2, prefill_buckets=(8,), chunk=3,
                       **SAMPLED)
    r1 = srv.submit([1, 2, 3], max_new=12)
    srv.step()
    r2 = srv.submit([9, 8, 7], max_new=5)
    srv.run()
    solo, _ = _serve(cfg, params, [([1, 2, 3], 12)], slots=2,
                     prefill_buckets=(8,), chunk=3, **SAMPLED)
    assert srv.result(r1) == solo[0] and len(srv.result(r2)) == 5


def test_fused_spec_matches_oracle_spec_sampled(setup, draft, monkeypatch):
    """Sampled speculation: the fused rounds and the oracle's per-round
    host commit emit the same tokens with the same acceptance tallies."""
    cfg, params, _ = setup
    _, _, tdc, tdp = draft
    reqs = [([3, 1, 4], 8), ([9, 8, 7, 6, 5], 8), ([4, 4], 8)]
    kw = dict(slots=2, prefill_buckets=(8, 16), temperature=0.9, top_p=0.9,
              rng=3, draft_params=tdp, draft_cfg=tdc, lookahead=3,
              spec_rounds=2)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1")
    fused, fsrv = _serve(cfg, params, reqs, **kw)
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "0")
    oracle, osrv = _serve(cfg, params, reqs, **kw)
    assert fused == oracle
    assert (fsrv.spec_accepted, fsrv.spec_proposed) == \
        (osrv.spec_accepted, osrv.spec_proposed)
    assert fsrv.spec_proposed > 0


def test_fused_spec_self_draft_accepts_everything_sampled(setup):
    cfg, params, _ = setup
    srv = DecodeServer(cfg, params, slots=2, prefill_buckets=(8,),
                       temperature=1.0, top_p=0.95, rng=2,
                       draft_params=params, draft_cfg=cfg, lookahead=4,
                       spec_rounds=2)
    rid = srv.submit([3, 1, 4, 1, 5], max_new=12)
    srv.run()
    assert len(srv.result(rid)) == 12
    assert srv.spec_proposed > 0 and srv.spec_acceptance == 1.0


def test_spec_eos_and_validation(setup, draft):
    """EOS inside a speculative round cuts the stream at the EOS; the
    lookahead must leave room in the smallest bucket, and the submit
    reserves the verify's headroom."""
    cfg, params, ref = setup
    _, _, tdc, tdp = draft
    stream = ref[(1, 2, 3)]
    eos = next(t for i, t in enumerate(stream)
               if i >= 2 and t not in stream[:i])
    outs, _ = _serve(cfg, params, [([1, 2, 3], 12)], slots=1, eos_id=eos,
                     prefill_buckets=(8,), draft_params=tdp, draft_cfg=tdc,
                     lookahead=3)
    assert outs == [_want(ref, [1, 2, 3], 12, eos)]
    with pytest.raises(ValueError, match="lookahead"):
        DecodeServer(cfg, params, prefill_buckets=(8,), draft_params=tdp,
                     draft_cfg=tdc, lookahead=7)
    with pytest.raises(ValueError, match="lookahead"):
        DecodeServer(cfg, params, draft_params=tdp, draft_cfg=tdc,
                     lookahead=0)
    with pytest.raises(ValueError, match="vocab"):
        DecodeServer(cfg, params, draft_params=tdp, draft_cfg=tmodel
                     .TransformerConfig(**dict(DRAFT, vocab=32)))
    srv = DecodeServer(cfg, params, draft_params=tdp, draft_cfg=tdc,
                       lookahead=4)
    with pytest.raises(ValueError, match="headroom 5"):
        srv.submit([1] * 50, max_new=10)


PREFIX_REQS = [([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 20], 5),
               ([9, 9, 9], 4),
               ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                 18], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 30, 31], 5)]


@pytest.mark.parametrize("slots,size", [(1, 4), (2, 2), (2, 8)])
def test_prefix_cache_matches_jax(setup, slots, size):
    """The same request sequence through the port's and the JAX server's
    prefix caches: equal hits and misses (LRU eviction included), and
    streams equal to the uncached greedy streams. One slot reuses its
    rows for every request, so a stored prefix that were a view of them
    would be overwritten before its hit."""
    cfg, params, _ = setup
    kw = dict(slots=slots, prefill_buckets=(8, 16), prefix_cache_size=size)
    outs, srv = _serve(cfg, params, PREFIX_REQS, **kw)
    want, jsrv = _jax_serve(PREFIX_REQS, **kw)
    cold, _ = _serve(cfg, params, PREFIX_REQS, slots=slots,
                     prefill_buckets=(8, 16))
    assert outs == want == cold
    assert (srv.prefix_hits, srv.prefix_misses) == \
        (jsrv.prefix_hits, jsrv.prefix_misses)
    assert srv.prefix_hits > 0
    assert len(srv._prefix_cache) <= size
    for entry in srv._prefix_cache.values():
        for layer, big in zip(entry, srv.cache):
            assert layer["k"].untyped_storage().data_ptr() != \
                big["k"].untyped_storage().data_ptr()


def test_prefix_cache_refuses_remainder_past_max_seq(setup):
    """A hit whose padded remainder would write past the cache end runs
    the full prefill instead, as the reference does."""
    cfg, params, ref = setup
    reqs = [(list(range(1, 18)), 3), (list(range(1, 18)) + [5] * 23, 3)]
    kw = dict(slots=1, prefill_buckets=(8, 16), prefix_cache_size=4)
    outs, srv = _serve(cfg, params, reqs, **kw)
    _, jsrv = _jax_serve(reqs, **kw)
    assert (srv.prefix_hits, srv.prefix_misses) == \
        (jsrv.prefix_hits, jsrv.prefix_misses) == (0, 2)
    cold, _ = _serve(cfg, params, reqs, slots=1, prefill_buckets=(8, 16))
    assert outs == cold


def test_prefix_cache_sampled_first_token_equals_full_prefill(setup):
    """A prefix hit keys its first draw at the full prompt's last
    position, so sampled streams equal the uncached server's."""
    cfg, params, _ = setup
    kw = dict(slots=1, prefill_buckets=(8, 16), **SAMPLED)
    outs, srv = _serve(cfg, params, PREFIX_REQS, prefix_cache_size=4, **kw)
    cold, _ = _serve(cfg, params, PREFIX_REQS, **kw)
    assert srv.prefix_hits > 0 and outs == cold


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_serve_demo_cli_on_cpu():
    base = [sys.executable, "-m", "kubegpu_tpu_torch.cmd.serve_demo",
            "--device", "cpu", "--requests", "3", "--slots", "2",
            "--max-new", "5", "--d-model", "32", "--n-layers", "1",
            "--seq", "64"]
    r = subprocess.run(base, capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-1500:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["mode"] == "serve" and out["tokens"] == 15
    assert out["device"] == "cpu" and out["data_plane"] == "fused"
    for flags, mode in ((["--speculative", "--temperature", "0.8"],
                         "speculative"),
                        (["--spec-server", "--prefix-cache", "4",
                          "--top-k", "5", "--temperature", "1.0"],
                         "spec-serve")):
        r = subprocess.run(base + flags, capture_output=True, text=True,
                           timeout=300, env=_env(), cwd=REPO)
        assert r.returncode == 0, r.stderr[-1500:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["mode"] == mode and out["tokens"] == 15
    assert out["prefix_misses"] + out["prefix_hits"] == 3
    for flags in (["--checkpoint-dir", "x"],
                  ["--speculative", "--prefix-cache", "2"]):
        r = subprocess.run(base + flags, capture_output=True, text=True,
                           timeout=300, env=_env(), cwd=REPO)
        assert r.returncode == 2
    assert "no readable checkpoint in x" in subprocess.run(
        base + ["--checkpoint-dir", "x"], capture_output=True, text=True,
        timeout=300, env=_env(), cwd=REPO).stderr


def test_chip_smoke_refuses_without_gpu_or_package(tmp_path):
    """The smoke script prints no result and exits non-zero without CUDA,
    and in a directory holding nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    runs = [(str(lone), str(tmp_path))]
    if not torch.cuda.is_available():
        runs.append((os.path.join(REPO, "chip_smoke.py"), REPO))
    for script, cwd in runs:
        r = subprocess.run([sys.executable, script], capture_output=True,
                           text=True, timeout=300, env=_env(), cwd=cwd)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
