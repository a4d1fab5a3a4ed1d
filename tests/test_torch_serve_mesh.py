"""The port's sharded serving (kubegpu_tpu_torch.workload.decode's
`cache_pspecs` and `DecodeServer(mesh=...)`) held against the same server
on one device and against the JAX package's server, over a (2, 1, 4) mesh
of 8 gloo ranks: the slots split over ``data`` (two a rank), the heads
over ``model``.

One world of 8 ranks per file (`tests/torch_worlds.job_serve_mesh8`, a
module-scoped fixture): every rank runs the same submissions and reports
its streams; each test asserts one result. Parameters come from JAX and
are carried across as numpy; float32, TF32 off, so greedy streams equal
token for token (tests/test_serve.py:355-370 holds the JAX server's mesh
the same way). The cache layout at tp = 8 mirrors tests/test_gqa.py:80-97
and tests/test_decode.py:115."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import spmd as jspmd  # noqa: E402
from kubegpu_tpu.workload.decode import cache_pspecs as jcache_pspecs  # noqa: E402
from kubegpu_tpu.workload.serve import DecodeServer as JaxServer  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload.decode import (cache_pspecs,  # noqa: E402
                                               init_cache, make_generate)
from kubegpu_tpu_torch.workload.serve import DecodeServer  # noqa: E402
from kubegpu_tpu_torch.workload.speculative import \
    make_speculative_generate  # noqa: E402
from tests.test_workload import cpu8  # noqa: E402,F401  (fixture reuse)
from tests.torch_worlds import run_world, single_rank_mesh  # noqa: E402

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=64, dtype="float32")
GQA_CFG = dict(CFG, d_model=64, n_heads=8, n_kv_heads=2)
REQS = [([1, 2, 3], 6), ([7, 8, 9, 10, 11, 12, 13], 6), ([5] * 12, 6),
        ([2, 7], 6), ([9, 8, 7], 4), ([5, 6], 6), (list(range(1, 12)), 5)]
# a shared system prompt with different tails, as the prefix cache serves
PREFIX_REQS = [([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 20], 5),
               ([9, 9, 9], 4),
               ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                 18], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 30, 31], 5)]
BUCKETS = (8, 16)
SERVE_CASES = {
    "greedy": dict(slots=4, prefill_buckets=BUCKETS),
    "oracle": dict(slots=4, prefill_buckets=BUCKETS, oracle=True),
    "prefix": dict(slots=2, prefill_buckets=BUCKETS, prefix_cache_size=4),
    "speculative": dict(slots=4, prefill_buckets=BUCKETS, lookahead=3)}


@pytest.fixture(scope="module")
def jax_params():
    return jmodel.init_params(jax.random.PRNGKey(0),
                              jmodel.TransformerConfig(**CFG))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("serve_mesh8")
    torch.save({"cfg": CFG, "gqa_cfg": GQA_CFG,
                "params": jax.tree.map(np.asarray, jax_params),
                "reqs": REQS, "prefix_reqs": PREFIX_REQS,
                "serve_cases": SERVE_CASES}, tmp / "inputs.pt")
    return run_world("tests.torch_worlds.job_serve_mesh8", 8, str(tmp),
                     str(tmp / "out"))


def _jax_serve(params, reqs, **kw):
    srv = JaxServer(jmodel.TransformerConfig(**CFG), params, **kw)
    rids = [srv.submit(p, max_new=n) for p, n in reqs]
    srv.run()
    return [srv.result(r) for r in rids], srv


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_mesh_server_equals_one_device_and_jax(world, jax_params, case):
    """Every rank's streams over (2, 1, 4) equal the single-device port
    server's and the JAX server's (greedy, so the speculative server's
    too), and so do the prefix hits and misses; a self-draft accepts every
    proposal."""
    kw = {k: v for k, v in SERVE_CASES[case].items()
          if k not in ("oracle", "lookahead")}
    reqs = PREFIX_REQS if "prefix_cache_size" in kw else REQS
    want, jsrv = _jax_serve(jax_params, reqs, **kw)
    counts = [res[case]["counts"] for res in world]
    assert all(c == counts[0] for c in counts)
    (hits, misses, acc, prop), one = counts[0]
    for res in world:
        assert res[case]["mesh"] == res[case]["one"] == want
    if "prefix_cache_size" in kw:
        assert (hits, misses) == one[:2] == \
            (jsrv.prefix_hits, jsrv.prefix_misses)
        assert hits > 0
    if case == "speculative":
        assert acc == prop > 0 and (acc, prop) == one[2:]


def test_mesh_server_cache_holds_its_slots_and_heads(world):
    """Each rank's cache block: 4 slots / dp 2 rows, 4 heads / tp 4."""
    for res in world:
        assert res["greedy"]["cache_rows"] == (2, CFG["max_seq"], 1, 8)


def test_cache_pspecs_match_cache_structure_and_reference():
    """One spec a cache dimension, per layer and k/v (the structure of
    `init_cache`), equal to the reference's PartitionSpec without a
    mesh."""
    cfg = tmodel.TransformerConfig(**CFG)
    cache = init_cache(cfg, 2, 32, "cpu")
    specs = cache_pspecs(cfg)
    assert [sorted(x) for x in specs] == [sorted(x) for x in cache]
    ref = jcache_pspecs(jmodel.TransformerConfig(**CFG))
    for layer, rlayer, clayer in zip(specs, ref, cache):
        for kv in ("k", "v"):
            assert len(layer[kv]) == clayer[kv].dim()
            assert layer[kv] == tuple(rlayer[kv])


def test_cache_pspecs_replicate_undividable_kv_heads(world, cpu8):
    """At tp = 8 two kv heads are replicated and eight split, leaf for leaf
    as the reference's rule; the sharded forward still refuses the
    replicated layout, naming it."""
    mesh = jspmd.make_mesh(8, dp=1, sp=1, tp=8, devices=cpu8)
    for kv in (2, 8):
        ref = jcache_pspecs(jmodel.TransformerConfig(
            **dict(GQA_CFG, n_kv_heads=kv)), mesh)
        got = world[0]["cache_pspecs"][kv]
        assert [{k: tuple(s) for k, s in x.items()} for x in ref] == got
    assert got[0]["k"][2] == "model"
    assert world[0]["cache_pspecs"][2][0]["k"][2] is None
    assert "n_kv_heads 2" in world[0]["gqa_refusal"]
    assert "replicated wk/wv" in world[0]["gqa_refusal"]


def test_mesh_refusals(world):
    """Slots that dp does not divide raise; an object that is not a mesh
    raises TypeError in every decoding entry point."""
    assert "slots 3 not divisible by dp 2" in world[0]["odd_slots"]
    cfg = tmodel.TransformerConfig(**CFG)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    for build in (lambda: DecodeServer(cfg, params, mesh=object()),
                  lambda: make_generate(cfg, mesh=object()),
                  lambda: make_speculative_generate(cfg, cfg,
                                                    mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            build()
    with single_rank_mesh() as mesh:
        assert DecodeServer(cfg, params, mesh=mesh).rows == 4
