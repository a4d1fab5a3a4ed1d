"""Tensor parallelism over head counts that tp does not divide, training
(kubegpu_tpu_torch.workload.spmd, model, train and lora), held against the
JAX package on the CPU.

The reference needs only the weight widths to divide: ``wq``/``wk``/``wv``
split by columns and GSPMD splits a head in the middle where it must. The
port gathers a rank's q/k/v columns over ``model`` (`spmd.gather_columns`),
applies RoPE to whole heads and attends the heads its columns overlap
(`model.head_span`, `model.span_attention`).

One world of 4 gloo ranks per file (`tests/torch_worlds.job_tp_heads4`, a
module-scoped fixture) runs every config of ``TP_HEADS_CASES``: 8 heads
with kv 2 and kv 1 and 6 heads at d_model 24 over (1, 1, 4), kv 1 and 3
heads at d_model 24 over (2, 1, 2) (at tp 2, kv 2 and 6 heads divide and
take the unchanged path). The JAX side runs in this process on the same
mesh shape of the virtual CPU devices: ``make_train_step`` for the AdamW
steps, ``value_and_grad`` of ``make_loss_fn(cfg, mesh)`` for the first
step's gradients, ``make_lora_train_step`` for the LoRA step. Parameters
come from JAX's ``init_params``, tokens from numpy with a seed; float32,
TF32 off. Tolerances (ROADMAP's North star): losses within 1e-4 relative,
gradients atol 5e-5 / rtol 5e-4; parameters after AdamW steps, whose
update is about the learning rate in every element, atol 1e-5 / rtol
1e-4 (tests/test_torch_spmd8.py's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from kubegpu_tpu.workload import lora as jlora  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import spmd as jspmd  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import spmd  # noqa: E402
from tests.test_workload import cpu8  # noqa: E402,F401  (fixture reuse)
from tests.torch_worlds import (TP_HEADS_BASE, TP_HEADS_CASES,  # noqa: E402
                                TP_HEADS_SP, TP_HEADS_SP_REFUSED, run_world)

CASES = list(TP_HEADS_CASES)
LORA_RANK = 4
STEPS = 3


def _jcfg(kw, **extra):
    return jmodel.TransformerConfig(**{**TP_HEADS_BASE, **kw, **extra})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    params, lora = {}, {}
    for i, (name, (_, kw)) in enumerate(TP_HEADS_CASES.items()):
        p = jmodel.init_params(jax.random.PRNGKey(i), _jcfg(kw))
        params[name] = _np(p)
        # a nonzero b, so every adapter leaf has a gradient
        ab = _np(jlora.init_lora(jax.random.PRNGKey(10 + i), p, LORA_RANK))
        for layer in ab["layers"]:
            for x in layer.values():
                x["b"] = (rng.standard_normal(x["b"].shape) * 0.1).astype(
                    np.float32)
        lora[name] = ab
    params["sp"] = _np(jmodel.init_params(jax.random.PRNGKey(20),
                                          _jcfg(TP_HEADS_SP[1])))
    return {"params": params, "lora": lora, "lora_rank": LORA_RANK,
            "batches": [rng.integers(0, TP_HEADS_BASE["vocab"], (4, 33))
                        for _ in range(STEPS)]}


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("tp_heads4")
    torch.save(inputs, tmp / "inputs.pt")
    return run_world("tests.torch_worlds.job_tp_heads4", 4, str(tmp),
                     str(tmp / "out"))


def _mesh(shape, cpu8):
    return jspmd.make_mesh(4, *shape, devices=cpu8)


def _shardings(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def _same(world, key, index=None):
    """The value every rank reports (one global value)."""
    vals = [res[key] if index is None else res[key][index] for res in world]
    assert all(v == vals[0] for v in vals), vals
    return vals[0]


def _close_trees(got, want, atol, rtol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    have = jax.tree.leaves(got)
    assert len(flat) == len(have)
    for (path, w), h in zip(flat, have):
        np.testing.assert_allclose(h, np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def _jax_adamw(cfg, mesh, params, batches):
    optimizer = jtrain.default_optimizer()
    params = jax.tree.map(jnp.asarray, params)
    opt_state = optimizer.init(params)
    step = jtrain.make_train_step(cfg, mesh, optimizer)
    losses = []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(batch))
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("case", CASES)
def test_first_step_grads_match_jax_on_the_same_mesh(world, inputs, cpu8,
                                                     case):
    """The global loss and the per-leaf gradients of the first step equal
    the reference's ``value_and_grad`` on the same mesh."""
    shape, kw = TP_HEADS_CASES[case]
    cfg, mesh = _jcfg(kw), _mesh(shape, cpu8)
    vg = jax.jit(jax.value_and_grad(jmodel.make_loss_fn(cfg, mesh)),
                 in_shardings=(_shardings(mesh, jspmd.param_pspecs(cfg)),
                               NamedSharding(mesh, jspmd.batch_pspec())))
    loss, grads = vg(jax.tree.map(jnp.asarray, inputs["params"][case]),
                     jnp.asarray(inputs["batches"][0]))
    got = _same(world, ("grads", case), 0)
    assert abs(got - float(loss)) <= 1e-4 * abs(float(loss))
    _close_trees(world[0][("grads", case)][1], grads, 5e-5, 5e-4)


@pytest.mark.parametrize("case", CASES)
def test_adamw_steps_match_jax_on_the_same_mesh(world, inputs, cpu8, case):
    shape, kw = TP_HEADS_CASES[case]
    losses, params = _jax_adamw(_jcfg(kw), _mesh(shape, cpu8),
                                inputs["params"][case], inputs["batches"])
    for res in world:
        got, _ = res[("adamw", case)]
        np.testing.assert_allclose(got, losses, rtol=1e-4)
    _close_trees(world[0][("adamw", case)][1], params, 1e-5, 1e-4)


@pytest.mark.parametrize("case", CASES)
def test_lora_step_matches_jax_on_the_same_mesh(world, inputs, cpu8, case):
    """One LoRA step (rank 4 on wq and wv, the default targets): the loss,
    the adapters' gradients and the updated adapters equal the
    reference's on the same mesh."""
    shape, kw = TP_HEADS_CASES[case]
    cfg, mesh = _jcfg(kw), _mesh(shape, cpu8)
    params = jax.tree.map(jnp.asarray, inputs["params"][case])
    lora = jax.tree.map(jnp.asarray, inputs["lora"][case])
    loss_fn = jmodel.make_loss_fn(cfg, mesh)
    batch = jnp.asarray(inputs["batches"][0])
    _, grads = jax.value_and_grad(
        lambda a: loss_fn(jlora.merge_lora(params, a, 1.0), batch))(lora)
    step = jlora.make_lora_train_step(cfg, mesh, LORA_RANK)
    optimizer = jtrain.default_optimizer()
    new, _, loss = step(lora, optimizer.init(lora), params, batch)
    got = _same(world, ("lora", case), 0)
    assert abs(got - float(loss)) <= 1e-4 * abs(float(loss))
    _close_trees(world[0][("lora", case)][1], grads, 5e-5, 5e-4)
    _close_trees(world[0][("lora", case)][2], new, 1e-5, 1e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_kv_split_matches_jax(world, inputs, cpu8, impl):
    """At (1, 2, 2) kv 1 does not divide by tp = 2: K/V are gathered over
    ``model`` and widened to the rank's 4 query heads before the ring or
    Ulysses; 3 AdamW losses equal the reference's."""
    shape, kw = TP_HEADS_SP
    losses, _ = _jax_adamw(_jcfg(kw, seq_impl=impl), _mesh(shape, cpu8),
                           inputs["params"]["sp"], inputs["batches"])
    for res in world:
        np.testing.assert_allclose(res[("sp", impl)], losses, rtol=1e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_refuses_split_heads_as_jax(world, cpu8, impl):
    """3 heads over tp = 2 at sp = 2: the reference's ``shard_map`` over
    ``model`` refuses the head axis, and the port refuses the config."""
    shape, kw = TP_HEADS_SP_REFUSED
    cfg = _jcfg(kw, seq_impl=impl)
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    optimizer = jtrain.default_optimizer()
    step = jtrain.make_train_step(cfg, _mesh(shape, cpu8), optimizer)
    with pytest.raises(ValueError, match="divisible"):
        step(params, optimizer.init(params),
             jnp.zeros((4, 33), jnp.int32))
    msg = world[0]["sp_refusal"]
    assert msg is not None and "n_heads 3" in msg and "sp=2" in msg
    with pytest.raises(ValueError, match="n_heads 3"):
        spmd.check_tp(tmodel.TransformerConfig(**TP_HEADS_BASE, **kw), 2,
                      sp=2)


def test_gather_columns_sums_the_ranks_partial_cotangents(world):
    """Each rank consumes the gathered value with its own weight: the
    gradient of rank r's slice is the sum over ranks of their weights'
    slice r (`gather_columns`); `gather_last`, which takes every rank's
    cotangent as the same, keeps only rank r's own and is wrong here."""
    for res in world:
        g = res["gather"]
        r, w = g["rank"], g["w"]
        tp, width = w.shape[0], g["x"].shape[-1]
        want = w.sum(0)[..., r * width:(r + 1) * width]
        np.testing.assert_allclose(g["columns"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            g["last"], w[r][..., r * width:(r + 1) * width], rtol=1e-6)
        assert np.abs(g["last"] - want).max() > 0.1


def test_head_span_at_the_training_config():
    """18 heads at d_model 2304 (chip_smoke.py's training config): over tp
    = 4 each rank takes 576 columns, 4.5 heads, and attends the 5 its
    columns overlap; over tp = 2 the columns fall on head boundaries."""
    cfg = tmodel.TransformerConfig(vocab=8192, d_model=2304, n_heads=18)
    assert [tmodel.head_span(cfg, 4, r) for r in range(4)] == [
        (0, 576, 0, 5), (576, 1152, 4, 9), (1152, 1728, 9, 14),
        (1728, 2304, 13, 18)]
    assert [tmodel.head_span(cfg, 2, r) for r in range(2)] == [
        (0, 1152, 0, 9), (1152, 2304, 9, 18)]


@pytest.mark.parametrize("heads,kv,tp", [(18, 18, 4), (18, 18, 2),
                                         (6, 2, 4), (8, 1, 4)])
def test_tp_attention_in_process_equals_one_device(heads, kv, tp):
    """Every virtual rank's `span_attention` times its ``wo`` rows, summed
    (`tp_attention_in_process`, as chip_smoke.py drives the kernels), and
    the q/k/v gradients autograd sums over the ranks, equal the attention
    over all heads times ``wo`` on one device (float32; the reference's
    attention tolerances, 2e-5 forward, atol 5e-5 / rtol 5e-4
    gradients)."""
    cfg = tmodel.TransformerConfig(d_model=heads * 8, n_heads=heads,
                                   n_kv_heads=kv, dtype="float32")
    rng = np.random.default_rng(heads + kv + tp)
    b, t, d = 2, 16, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((b, t, heads, d), (b, t, kv, d),
                                           (b, t, kv, d)))
    wo = torch.from_numpy(rng.standard_normal((heads * d, heads * d))
                          .astype(np.float32) / (heads * d) ** 0.5)
    do = torch.from_numpy(rng.standard_normal((b, t, heads * d))
                          .astype(np.float32))

    def attend(q, k, v):
        return tmodel._causal_attention(q, k, v, d ** -0.5)

    got = tmodel.tp_attention_in_process(cfg, q, k, v, wo, tp, attend)
    got_grads = torch.autograd.grad(got, (q, k, v), do)
    ke, ve = tmodel._expand_kv(cfg, k, v)
    want = attend(q, ke, ve).reshape(b, t, -1) @ wo
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    np.testing.assert_allclose(got.detach(), want.detach(), atol=2e-5,
                               rtol=2e-5)
    for name, a, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a, w, atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{name}")
