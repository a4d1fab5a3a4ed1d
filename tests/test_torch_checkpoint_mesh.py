"""The port's sharded decoding and sharded checkpoints over meshes of 4
gloo ranks, held against the JAX package on the CPU and against one
device:

- the sharded forward step (kubegpu_tpu_torch.workload.decode) at (2, 1,
  2) and (1, 1, 4), dense and MoE (experts over ``model``): each rank's
  logits on a prefill chunk and on per-row decode steps equal JAX's
  ``make_forward_step(cfg, mesh)`` on the same mesh of the virtual CPU
  devices within 1e-4 (the reference's logits tolerance);
- `make_generate` at (2, 1, 2) equal to JAX's sharded and single-device
  decode token for token (tests/test_decode.py:94-112);
- `make_speculative_generate` at (1, 1, 4) equal to one device, greedy;
- sampled serving with the slots split four ways at (4, 1, 1): no sum
  changes, so the streams equal the single-device server's;
- sharded checkpoints (kubegpu_tpu_torch.workload.checkpoint): saved at
  (2, 1, 2) after 2 AdamW steps and restored at (2, 1, 2), at (1, 1, 4)
  and on one device, the next 2 losses equal to the uninterrupted run's
  (bit for bit on the same mesh, within 1e-6 relative elsewhere); the
  reference's ``restore_checkpoint`` reads the file, and a rank that
  cannot read makes every rank return (None, -1).

One world per file (`tests/torch_worlds.job_mesh4`, module-scoped); each
test asserts one result. float32, TF32 off."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from kubegpu_tpu.workload import checkpoint as jckpt  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import spmd as jspmd  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu.workload.decode import (init_cache as jinit_cache,  # noqa: E402
                                         make_forward_step as jstep,
                                         make_generate as jgenerate)
from kubegpu_tpu_torch.workload import checkpoint as tckpt  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload.speculative import \
    make_speculative_generate  # noqa: E402
from kubegpu_tpu_torch.workload.train import (init_sharded,  # noqa: E402
                                              make_train_step,
                                              param_leaves)
from tests.test_workload import cpu8  # noqa: E402,F401  (fixture reuse)
from tests.torch_worlds import run_world  # noqa: E402

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=64, dtype="float32")
MOE_CFG = dict(CFG, n_experts=4, moe_top_k=2)
SHAPES = [(2, 1, 2), (1, 1, 4)]
N_NEW = 6
REQS = [([1, 2, 3], 6), ([7, 8, 9, 10, 11, 12, 13], 6), ([5] * 12, 6),
        ([2, 7], 6), ([9, 8, 7], 4), ([5, 6], 6), (list(range(1, 12)), 5),
        ([3, 1, 4, 1, 5], 6), ([2, 6], 5)]
SAMPLED = dict(slots=8, prefill_buckets=(8, 16), temperature=0.8, top_k=8,
               rng=11)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    params = jmodel.init_params(jax.random.PRNGKey(0),
                                jmodel.TransformerConfig(**CFG))
    moe = jmodel.init_params(jax.random.PRNGKey(1),
                             jmodel.TransformerConfig(**MOE_CFG))
    return {"cfg": CFG, "moe_cfg": MOE_CFG,
            "params": jax.tree.map(np.asarray, params),
            "moe_params": jax.tree.map(np.asarray, moe),
            "tokens": rng.integers(0, CFG["vocab"], (4, 8)),
            # two per-row decode steps, each row at its own position
            "decode_pos": [np.array([8, 5, 7, 8]), np.array([9, 6, 8, 9])],
            "decode_toks": [rng.integers(0, CFG["vocab"], 4)
                            for _ in range(2)],
            "n_new": N_NEW, "reqs": REQS, "sampled": SAMPLED,
            "batches": [rng.integers(0, CFG["vocab"], (4, 17))
                        for _ in range(4)]}


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("mesh4")
    torch.save(inputs, tmp / "inputs.pt")
    return tmp, run_world("tests.torch_worlds.job_mesh4", 4, str(tmp),
                          str(tmp / "out"))


def _jax_mesh(shape, devices):
    return jspmd.make_mesh(4, *shape, devices=devices)


def _place(tree, cfg, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh,
                                                                     s)),
                        tree, jspmd.param_pspecs(cfg))


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("shape", SHAPES, ids=["2x1x2", "1x1x4"])
def test_sharded_forward_step_matches_jax(world, inputs, cpu8, shape,
                                          model):
    kw = CFG if model == "dense" else MOE_CFG
    cfg = jmodel.TransformerConfig(**kw)
    mesh = _jax_mesh(shape, cpu8)
    params = _place(inputs["params" if model == "dense" else "moe_params"],
                    cfg, mesh)
    step = jax.jit(jstep(cfg, mesh))
    tokens = jnp.asarray(inputs["tokens"], jnp.int32)
    cache = jinit_cache(cfg, tokens.shape[0], cfg.max_seq)
    logits, cache = step(params, cache, tokens, 0)
    want = [np.asarray(logits)]
    for pos, tok in zip(inputs["decode_pos"], inputs["decode_toks"]):
        logits, cache = step(params, cache, jnp.asarray(tok[:, None],
                                                        jnp.int32),
                             jnp.asarray(pos, jnp.int32))
        want.append(np.asarray(logits))
    for res in world[1]:
        got = res[("forward", shape, model)]
        r0, n = got["rows"]
        for g, w in zip([got["prefill"], *got["decode"]], want):
            np.testing.assert_allclose(g, w[r0:r0 + n], atol=1e-4,
                                       rtol=1e-4)


def test_make_generate_over_a_mesh_matches_jax(world, inputs, cpu8):
    """Every rank returns the global tokens, equal to JAX's sharded and
    single-device decode; a batch dp does not divide raises."""
    cfg = jmodel.TransformerConfig(**CFG)
    tokens = jnp.asarray(inputs["tokens"], jnp.int32)
    single = jax.jit(jgenerate(cfg), static_argnums=(2,))(
        jax.tree.map(jnp.asarray, inputs["params"]), tokens, N_NEW)
    mesh = _jax_mesh((2, 1, 2), cpu8)
    sharded = jax.jit(jgenerate(cfg, mesh), static_argnums=(2,))(
        _place(inputs["params"], cfg, mesh),
        jax.device_put(tokens, NamedSharding(mesh, P(jspmd.AXIS_DATA,
                                                     None))), N_NEW)
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(single))
    for res in world[1]:
        np.testing.assert_array_equal(res["generate"], np.asarray(single))
        assert "batch 3 not divisible by dp 2" in res["odd_batch"]


def test_speculative_generate_over_a_mesh_matches_one_device(world, inputs):
    cfg = tmodel.TransformerConfig(**CFG)
    params = tmodel.params_from_jax(inputs["params"], device="cpu")
    want = make_speculative_generate(cfg, cfg, k=3)(
        params, params, inputs["tokens"][0].tolist(), N_NEW)
    for res in world[1]:
        assert res["speculative"] == want


def test_sampled_serving_over_data_is_bit_identical(world):
    """Rows split over data at tp = 1 change no sum: the sampled streams
    (temperature 0.8, top-k 8) equal the single-device server's."""
    for res in world[1]:
        assert res["sampled"]["mesh"] == res["sampled"]["one"]
        assert all(len(s) == n for s, (_, n) in
                   zip(res["sampled"]["mesh"], REQS))


def _one_device_resume(ckpt, inputs) -> tuple:
    """The mesh-written step restored on one device, and its next 2
    losses."""
    cfg = tmodel.TransformerConfig(**CFG)
    params, opt, optimizer = init_sharded(torch.Generator().manual_seed(9),
                                          cfg)
    state, at = tckpt.restore_checkpoint(
        ckpt, {"params": params, "opt_state": tckpt.adamw_template(params)})
    tckpt.load_train_state(opt, params, state)
    step = make_train_step(cfg, optimizer=optimizer)
    losses = []
    for batch in inputs["batches"][at:]:
        params, opt, loss = step(params, opt, batch)
        losses.append(loss.item())
    return at, losses


@pytest.mark.parametrize("where", ["2x1x2", "1x1x4", "one-device"])
def test_checkpoint_resumes_across_mesh_shapes(world, inputs, where):
    tmp, results = world
    whole = results[0]["losses"]
    assert all(res["losses"] == whole for res in results)
    if where == "one-device":
        runs = [_one_device_resume(str(tmp / "ckpt"), inputs)]
    else:
        shape = tuple(int(c) for c in where.split("x"))
        runs = [res[("resumed", shape)] for res in results]
    for at, resumed in runs:
        assert at == 2
        if where == "2x1x2":
            assert resumed == whole[2:]
        else:
            np.testing.assert_allclose(resumed, whole[2:], rtol=1e-6)


def test_reference_reads_the_mesh_checkpoint(world, inputs):
    """The JAX package's ``restore_checkpoint`` (its numpy branch) reads
    the step the mesh wrote; its leaves equal the gathered state."""
    tmp, results = world
    params = jax.tree.map(jnp.asarray, inputs["params"])
    like = {"params": params,
            "opt_state": jtrain.default_optimizer().init(params)}
    state, at = jckpt.restore_checkpoint(str(tmp / "ckpt"), like)
    assert at == 2
    got = jax.tree.leaves(state)
    want = param_leaves(results[0]["saved"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_a_rank_that_cannot_read_fails_every_rank(world):
    """Rank 1 reads a missing directory: every rank returns (None, -1)
    and meets the next collective instead of hanging."""
    for res in world[1]:
        assert res["one_rank_unreadable"] == (True, -1)
