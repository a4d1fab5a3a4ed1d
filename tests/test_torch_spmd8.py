"""The port's sharded training (kubegpu_tpu_torch.workload.model, train,
moe and lora over a mesh) held against the JAX package's on the CPU, at
dp x sp x tp = 2 x 2 x 2 and, for expert parallelism, (dp, tp) = (2, 4).

One world of 8 gloo ranks per file (`tests/torch_worlds.job_spmd8`, a
module-scoped fixture): the ranks write their results, each test asserts
one. Parameters and adapters come from JAX and are carried across as
numpy; tokens from numpy with a seed; float32, TF32 off. The JAX side runs
in this process: single-device ``jax.value_and_grad`` for the losses and
gradients, and ``make_train_step`` on the same 2 x 2 x 2 mesh of the
virtual CPU devices for the AdamW steps. Tolerances, and why:
- losses within 1e-4 relative, gradients atol 5e-5 / rtol 5e-4 (ROADMAP's
  attention-gradient tolerance);
- AdamW steps: tests/test_torch_train.py's (losses 1e-5 relative, params
  atol 1e-5 / rtol 1e-4);
- remat dots and full against none on the same mesh: the same float32
  operations replayed, so atol 1e-6 / rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import lora as jlora  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import spmd as jspmd  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from tests.test_workload import cpu8  # noqa: E402,F401  (fixture reuse)
from tests.torch_worlds import run_world  # noqa: E402

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=64, dtype="float32")
MOE_CFG = dict(CFG, n_experts=4)
LORA_RANK, LORA_SCALING, LORA_TARGETS = 4, 2.0, ("wq", "wv", "wo")
STEPS = 3


@pytest.fixture(scope="module")
def inputs():
    cfg = jmodel.TransformerConfig(**CFG)
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    moe_params = jmodel.init_params(
        jax.random.PRNGKey(1), jmodel.TransformerConfig(**MOE_CFG))
    lora = jlora.init_lora(jax.random.PRNGKey(2), params, LORA_RANK,
                           LORA_TARGETS)
    rng = np.random.default_rng(7)
    # a nonzero b, so every adapter leaf has a gradient
    lora = jax.tree.map(np.asarray, lora)
    for layer in lora["layers"]:
        for ab in layer.values():
            ab["b"] = (rng.standard_normal(ab["b"].shape) * 0.1).astype(
                np.float32)
    return {"cfg": CFG, "params": jax.tree.map(np.asarray, params),
            "tokens": rng.integers(0, CFG["vocab"], (4, 33)),
            "batches": [rng.integers(0, CFG["vocab"], (4, 33))
                        for _ in range(STEPS)],
            "moe_cfg": MOE_CFG,
            "moe": {k: jax.tree.map(np.asarray, moe_params) for k in (1, 2)},
            "lora": lora, "lora_rank": LORA_RANK,
            "lora_scaling": LORA_SCALING, "lora_targets": LORA_TARGETS}


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("spmd8")
    torch.save(inputs, tmp / "inputs.pt")
    return run_world("tests.torch_worlds.job_spmd8", 8, str(tmp),
                     str(tmp / "out"))


def _jax_loss_and_grads(cfg_kw, params, tokens):
    cfg = jmodel.TransformerConfig(**cfg_kw)
    loss, grads = jax.value_and_grad(jmodel.make_loss_fn(cfg))(
        params, jnp.asarray(tokens))
    return float(loss), grads


def _same_loss(world, key, index=0):
    """The loss every rank reports (one global value)."""
    losses = [res[key][index] for res in world]
    assert max(losses) == min(losses), losses
    return losses[0]


def _close_trees(got, want, atol, rtol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    have = jax.tree.leaves(got)
    assert len(flat) == len(have)
    for (path, w), h in zip(flat, have):
        np.testing.assert_allclose(h, np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sharded_loss_and_grads_match_jax(world, inputs, impl):
    loss, grads = _jax_loss_and_grads(CFG, inputs["params"],
                                      inputs["tokens"])
    got = _same_loss(world, ("model", impl))
    assert abs(got - loss) <= 1e-4 * abs(loss)
    _close_trees(world[0][("model", impl)][1], grads, 5e-5, 5e-4)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_under_a_mesh(world, inputs, remat):
    """Remat none, dots and full through the ring's flash path at 2 x 2 x
    2: each equals JAX, and dots and full equal none."""
    loss, grads = _jax_loss_and_grads(CFG, inputs["params"],
                                      inputs["tokens"])
    got = _same_loss(world, ("remat", remat))
    assert abs(got - loss) <= 1e-4 * abs(loss)
    _close_trees(world[0][("remat", remat)][1], grads, 5e-5, 5e-4)
    none = world[0][("remat", "none")]
    assert abs(got - none[0]) <= 1e-5 * abs(none[0])
    for a, b in zip(jax.tree.leaves(world[0][("remat", remat)][1]),
                    jax.tree.leaves(none[1])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_adamw_steps_match_jax_on_the_same_mesh(world, inputs, cpu8):
    cfg = jmodel.TransformerConfig(**CFG)
    mesh = jspmd.make_mesh(8, dp=2, sp=2, tp=2, devices=cpu8)
    optimizer = jtrain.default_optimizer()
    params = jax.tree.map(jnp.asarray, inputs["params"])
    opt_state = optimizer.init(params)
    step = jtrain.make_train_step(cfg, mesh, optimizer)
    losses = []
    for batch in inputs["batches"]:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(batch))
        losses.append(float(loss))
    for res in world:
        np.testing.assert_allclose(res["adamw_losses"], losses, rtol=1e-5)
    _close_trees(world[0]["adamw_params"], params, 1e-5, 1e-4)


@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_parallel_moe_matches_jax(world, inputs, top_k):
    """Experts split over tp = 4 at dp = 2: the loss, the aux term (a
    product of global means) and the gradients equal JAX's."""
    kw = dict(MOE_CFG, moe_top_k=top_k)
    params = inputs["moe"][top_k]
    loss, grads = _jax_loss_and_grads(kw, params, inputs["tokens"])
    _, aux = jmodel.make_forward_with_aux(jmodel.TransformerConfig(**kw))(
        params, jnp.asarray(inputs["tokens"])[:, :-1])
    got = _same_loss(world, ("moe", top_k))
    assert abs(got - loss) <= 1e-4 * abs(loss)
    aux_got = _same_loss(world, ("moe", top_k), index=2)
    assert abs(aux_got - float(aux)) <= 1e-4 * abs(float(aux))
    _close_trees(world[0][("moe", top_k)][1], grads, 5e-5, 5e-4)


def test_sharded_lora_matches_jax(world, inputs):
    """Adapters on wq, wv (column-parallel) and wo (row-parallel) at 2 x 2
    x 2: the loss and the adapters' gradients equal JAX's, and a step
    leaves the sharded base untouched, without gradients."""
    cfg = jmodel.TransformerConfig(**CFG)
    loss_fn = jmodel.make_loss_fn(cfg)
    tokens = jnp.asarray(inputs["tokens"])

    def lora_loss(lora):
        return loss_fn(jlora.merge_lora(inputs["params"], lora,
                                        LORA_SCALING), tokens)

    loss, grads = jax.value_and_grad(lora_loss)(
        jax.tree.map(jnp.asarray, inputs["lora"]))
    losses = [res["lora_loss"] for res in world]
    assert max(losses) == min(losses)
    assert abs(losses[0] - float(loss)) <= 1e-4 * abs(float(loss))
    _close_trees(world[0]["lora_grads"], grads, 5e-5, 5e-4)
    assert all(res["lora_base_untouched"] for res in world)
