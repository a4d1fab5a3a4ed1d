"""Tensor parallelism over head counts that tp does not divide, decoding
(kubegpu_tpu_torch.workload.decode, serve, speculative and checkpoint)
held against the JAX package on the CPU and against one device.

Where tp does not divide ``kv_heads`` the cache's head axis is replicated
(`decode.cache_pspecs`, the reference's rule): each rank gathers the new
K/V over ``model``, writes every kv head and attends the heads its
columns overlap.

One world of 4 gloo ranks per file (`tests/torch_worlds.job_tp_heads_serve4`,
module-scoped) runs every config of ``TP_HEADS_CASES`` (8 heads with kv 2
and kv 1 and 6 heads at d_model 24 over (1, 1, 4); kv 1 and 3 heads at
d_model 24 over (2, 1, 2)): `make_generate`, the greedy `DecodeServer` and
the speculative server with a 1-layer draft sharded over the same mesh,
each against the same call on one device and against the reference's
``make_generate`` and ``DecodeServer`` on the same mesh of the virtual CPU
devices; the prefix-cached server against one device; the sampled server's
agreement across ranks; and a sharded checkpoint saved and restored into fresh shards,
which the reference's ``restore_checkpoint`` also reads. Parameters come
from JAX, float32, TF32 off, so greedy streams equal token for token and
restored leaves bit for bit.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import checkpoint as jckpt  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import spmd as jspmd  # noqa: E402
from kubegpu_tpu.workload.decode import make_generate as jgenerate  # noqa: E402
from kubegpu_tpu.workload.serve import DecodeServer as JaxServer  # noqa: E402
from tests.test_workload import cpu8  # noqa: E402,F401  (fixture reuse)
from tests.torch_worlds import (TP_HEADS_BASE, TP_HEADS_CASES,  # noqa: E402
                                run_world)

CASES = list(TP_HEADS_CASES)
REQS = [([1, 2, 3], 6), ([7, 8, 9, 10, 11, 12, 13], 6), ([5] * 12, 6),
        ([2, 7], 6), ([9, 8, 7], 4), ([5, 6], 6)]
# a shared system prompt with different tails, as the prefix cache serves
PREFIX_REQS = [([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 5),
               ([1, 2, 3, 4, 5, 6, 7, 8, 20], 5), ([9, 9, 9], 4)]
SERVE = dict(slots=4, prefill_buckets=(8, 16))
SAMPLED = dict(temperature=0.8, top_k=8, rng=11)
N_NEW = 6


def _jcfg(kw, **extra):
    return jmodel.TransformerConfig(**{**TP_HEADS_BASE, **kw, **extra})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    params, draft = {}, {}
    for i, (name, (_, kw)) in enumerate(TP_HEADS_CASES.items()):
        params[name] = _np(jmodel.init_params(jax.random.PRNGKey(i),
                                              _jcfg(kw)))
        draft[name] = _np(jmodel.init_params(jax.random.PRNGKey(10 + i),
                                             _jcfg(kw, n_layers=1)))
    prompt = np.random.default_rng(3).integers(
        0, TP_HEADS_BASE["vocab"], (4, 9))
    return {"params": params, "draft": draft, "reqs": REQS, "serve": SERVE,
            "prefix_reqs": PREFIX_REQS, "sampled": SAMPLED,
            "prompt": prompt, "n_new": N_NEW}


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_heads_serve4")


@pytest.fixture(scope="module")
def world(world_dir, inputs):
    torch.save(inputs, world_dir / "inputs.pt")
    return run_world("tests.torch_worlds.job_tp_heads_serve4", 4,
                     str(world_dir), str(world_dir / "out"))


@pytest.fixture(scope="module")
def jax_streams(inputs, cpu8):
    """The reference server's greedy streams over each config's mesh."""
    done = {}

    def streams(case):
        if case not in done:
            shape, kw = TP_HEADS_CASES[case]
            srv = JaxServer(_jcfg(kw), jax.tree.map(
                jnp.asarray, inputs["params"][case]),
                mesh=jspmd.make_mesh(4, *shape, devices=cpu8), **SERVE)
            rids = [srv.submit(p, max_new=n) for p, n in REQS]
            srv.run()
            done[case] = [srv.result(r) for r in rids]
        return done[case]

    return streams


@pytest.mark.parametrize("case", CASES)
def test_generate_equals_one_device_and_jax(world, inputs, cpu8, case):
    shape, kw = TP_HEADS_CASES[case]
    want = np.asarray(jgenerate(_jcfg(kw), jspmd.make_mesh(
        4, *shape, devices=cpu8))(jax.tree.map(jnp.asarray,
                                               inputs["params"][case]),
                                  jnp.asarray(inputs["prompt"]), N_NEW))
    for res in world:
        mesh, one = res[case]["generate"]
        np.testing.assert_array_equal(mesh, one)
        np.testing.assert_array_equal(mesh, want)


@pytest.mark.parametrize("case", CASES)
def test_greedy_server_equals_one_device_and_jax(world, jax_streams,
                                                 case):
    want = jax_streams(case)
    for res in world:
        mesh, one = res[case]["greedy"]
        assert mesh == one == want


@pytest.mark.parametrize("case", CASES)
def test_speculative_server_equals_greedy(world, jax_streams, case):
    """The speculative server with a 1-layer draft over the same mesh:
    greedy, so its streams are the target's own (the reference's server
    on the mesh), with as many drafts accepted as on one device."""
    want = jax_streams(case)
    for res in world:
        (mesh, acc, prop), (one, acc1, prop1) = res[case]["speculative"]
        assert mesh == one == want
        assert (acc, prop) == (acc1, prop1) and prop > 0


@pytest.mark.parametrize("case", CASES)
def test_prefix_cached_server_equals_one_device(world, case):
    """The prefix cache over the mesh (its blocks keep every kv head where
    the cache's head axis is replicated): the streams and the hits and
    misses of one device, with hits."""
    for res in world:
        (mesh, hits, misses), one = res[case]["prefix"]
        assert (mesh, hits, misses) == one and hits > 0


@pytest.mark.parametrize("case", CASES)
def test_sampled_server_agrees_on_every_rank(world, case):
    """Sampling over the mesh: the split sums change the logits' last
    bits, so the draws are not one device's; every rank holds the same
    streams (the server's host state must not diverge), each of the
    requested length within the vocabulary."""
    streams = world[0][case]["sampled"]
    assert all(res[case]["sampled"] == streams for res in world)
    assert [len(x) for x in streams] == [n for _, n in REQS]
    assert all(0 <= tok < TP_HEADS_BASE["vocab"] for x in streams for tok in x)


@pytest.mark.parametrize("case", CASES)
def test_sharded_checkpoint_round_trip(world, world_dir, inputs, case):
    """Shards saved over the mesh and restored into fresh shards give the
    parameters back bit for bit, and the reference reads the same file."""
    want = inputs["params"][case]
    for res in world:
        at, got = res[case]["restored"]
        assert at == 1
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    state, at = jckpt.restore_checkpoint(
        os.path.join(world_dir, f"ckpt_{case}"), {"params": want})
    assert at == 1
    for a, b in zip(jax.tree.leaves(state["params"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
