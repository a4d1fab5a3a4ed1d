"""The port's LoRA fine-tuning (kubegpu_tpu_torch.workload.lora) held
against the JAX package's (kubegpu_tpu/workload/lora.py), mirroring
tests/test_lora.py: identity at init, adapter-only training with the base
frozen, validation, a trained adapter changing the model, the CLI, and
three AdamW steps against JAX's ``make_lora_train_step``.

Parameters and adapters come from JAX (``init_params``, ``init_lora``)
and are carried across with ``params_from_jax``; tokens come from numpy
with a seed; float32 on the CPU. Tolerances, and why:
- logits 1e-4: tests/test_torch_model.py's forward tolerance;
- losses 1e-5, adapters atol 1e-5 / rtol 1e-4: tests/test_torch_train.py's
  AdamW-step tolerances (Adam moves each element about lr = 3e-4 a step
  whatever the gradient's size, so float32 rounding of the gradients moves
  it far less than 1e-5). Step 1 moves ``a`` by weight decay alone, since
  ``b = 0`` gives ``a`` a zero gradient; three steps exercise both.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import lora as jlora  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu_torch.workload import lora as tlora  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import train as ttrain  # noqa: E402

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32", attn_impl="xla")


def _to_port(tree):
    return tmodel.params_from_jax(jax.tree.map(np.asarray, tree),
                                  device="cpu")


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, JAX params, port params, tokens [2, 33])."""
    jcfg, tcfg = (jmodel.TransformerConfig(**SMALL),
                  tmodel.TransformerConfig(**SMALL))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(1).integers(0, 64, (2, 33)).astype(np.int32)
    return jcfg, tcfg, jp, _to_port(jp), tok


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(ttrain.param_leaves(a), ttrain.param_leaves(b)))


def test_zero_init_is_identity(setup):
    """b == 0 makes the merged model equal the base model exactly."""
    _, tcfg, _, tp, tok = setup
    lora = tlora.init_lora(torch.Generator().manual_seed(2), tp, rank=4)
    merged = tlora.merge_lora(tp, lora, scaling=1.0)
    fwd = tmodel.make_forward(tcfg)
    x = torch.from_numpy(tok[:, :-1])
    assert torch.equal(fwd(tp, x), fwd(merged, x))


def test_init_lora_layout_matches_reference(setup):
    """The port's adapters have the reference's tree, shapes and init
    (a: normal times in^-0.5, b: zeros), drawn reproducibly from the
    generator; other leaves pass through merge_lora by reference."""
    _, _, jp, tp, _ = setup
    jl = jlora.init_lora(jax.random.PRNGKey(2), jp, rank=4)
    tl = tlora.init_lora(torch.Generator().manual_seed(2), tp, rank=4)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jl)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, _to_port(jl)))
    for jl_layer, tl_layer in zip(jl["layers"], tl["layers"]):
        assert sorted(tl_layer) == sorted(jl_layer) == \
            sorted(tlora.DEFAULT_TARGETS)
        for name in tl_layer:
            for k in ("a", "b"):
                assert tuple(tl_layer[name][k].shape) == \
                    jl_layer[name][k].shape
            assert not tl_layer[name]["b"].any()
    a = torch.cat([layer[n]["a"].flatten() for layer in tl["layers"]
                   for n in layer])
    assert abs(a.std().item() * 32 ** 0.5 - 1.0) < 0.15
    again = tlora.init_lora(torch.Generator().manual_seed(2), tp, rank=4)
    assert _leaves_equal(tl, again)
    assert tlora.count_params(tl) == jlora.count_params(jl)
    merged = tlora.merge_lora(tp, tl, 1.0)
    assert merged["embed"] is tp["embed"]
    assert merged["layers"][0]["wk"] is tp["layers"][0]["wk"]


def test_lora_trains_adapters_only(setup):
    """Loss decreases; every base leaf keeps requires_grad off, its .grad
    None and its bits; the adapters are a small fraction of the model."""
    _, tcfg, _, _, tok = setup
    params, _, _ = ttrain.init_sharded(torch.Generator().manual_seed(0),
                                       tcfg, init_optimizer=False)
    base = [x.detach().clone() for x in ttrain.param_leaves(params)]
    lora = tlora.init_lora(torch.Generator().manual_seed(2), params, rank=4)
    assert tlora.count_params(lora) < 0.1 * tlora.count_params(params)
    step = tlora.make_lora_train_step(
        tcfg, None, rank=4,
        optimizer=lambda leaves: torch.optim.Adam(leaves, lr=1e-2))
    state, losses = None, []
    for _ in range(5):
        lora, state, loss = step(lora, state, params, torch.from_numpy(tok))
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert {id(p) for g in state.param_groups for p in g["params"]} == \
        {id(x) for x in ttrain.param_leaves(lora)}
    for x, was in zip(ttrain.param_leaves(params), base):
        assert not x.requires_grad and x.grad is None
        assert torch.equal(x, was)


def test_lora_validation_matches_reference(setup):
    _, _, jp, tp, _ = setup
    for init, p, key in ((jlora.init_lora, jp, jax.random.PRNGKey(0)),
                         (tlora.init_lora, tp, torch.Generator())):
        with pytest.raises(ValueError, match="rank must be >= 1, got 0"):
            init(key, p, rank=0)
        with pytest.raises(KeyError) as exc:
            init(key, p, rank=2, targets=("nope",))
        messages = str(exc.value)
        assert "'nope' not in layer 0" in messages
        assert "'w_down', 'w_gate', 'w_up', 'wk', 'wo', 'wq', 'wv'" \
            in messages


def test_lora_changes_model_after_training(setup):
    """A trained adapter alters the forward, and the merged model's
    logits equal JAX's merged model's (1e-4)."""
    jcfg, tcfg, jp, tp, tok = setup
    jl = jax.tree.map(lambda x: x + 0.01,
                      jlora.init_lora(jax.random.PRNGKey(2), jp, rank=4))
    tl = _to_port(jl)
    x = tok[:, :-1]
    base = tmodel.make_forward(tcfg)(tp, torch.from_numpy(x))
    got = tmodel.make_forward(tcfg)(tlora.merge_lora(tp, tl, 2.0),
                                    torch.from_numpy(x))
    assert not torch.allclose(base, got, atol=1e-5)
    want = jmodel.make_forward(jcfg)(jlora.merge_lora(jp, jl, 2.0),
                                     jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("alpha", [None, 8.0])
def test_lora_steps_match_jax(setup, alpha):
    """Three AdamW steps of the port's step against JAX's
    ``make_lora_train_step(cfg, None, rank)`` (default optimizer): losses
    within 1e-5, adapters atol 1e-5 / rtol 1e-4."""
    jcfg, tcfg, jp, tp, _ = setup
    jl = jlora.init_lora(jax.random.PRNGKey(2), jp, rank=4)
    tl = _to_port(jl)
    jopt = jtrain.default_optimizer()
    jstate = jopt.init(jl)
    jstep = jlora.make_lora_train_step(jcfg, None, 4, jopt, alpha=alpha)
    tstep = tlora.make_lora_train_step(tcfg, None, 4, alpha=alpha)
    tstate = None
    rng = np.random.default_rng(5)
    for i in range(3):
        tok = rng.integers(0, 64, (2, 33)).astype(np.int32)
        jl, jstate, jloss = jstep(jl, jstate, jp, jnp.asarray(tok))
        tl, tstate, tloss = tstep(tl, tstate, tp, torch.from_numpy(tok))
        assert abs(tloss.item() - float(jloss)) <= 1e-5, i
    assert isinstance(tstate, torch.optim.AdamW)
    for jlayer, tlayer in zip(jl["layers"], tl["layers"]):
        for name in tlayer:
            for k in ("a", "b"):
                np.testing.assert_allclose(
                    tlayer[name][k].detach().numpy(),
                    np.asarray(jlayer[name][k]), atol=1e-5, rtol=1e-4,
                    err_msg=f"{name}.{k}")
    assert tl["layers"][0]["wq"]["b"].abs().max() > 0


def test_lora_step_refuses_a_mesh(setup):
    """A mesh builds the LoRA step now (slice 6); an object that is not a
    mesh is refused."""
    _, tcfg, _, _, _ = setup
    from tests.torch_worlds import single_rank_mesh

    with single_rank_mesh() as mesh:
        tlora.make_lora_train_step(tcfg, mesh, 4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tlora.make_lora_train_step(tcfg, object(), 4)


def test_train_demo_lora_mode(capsys):
    """CLI: --lora-rank trains adapters, reports finite losses, and
    decodes from the merged model; --accum-steps is refused with it."""
    from kubegpu_tpu_torch.cmd import train_demo

    rc = train_demo.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "32", "--d-model", "32", "--n-layers",
                          "1", "--lora-rank", "4", "--generate", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert len(out["generated"]) == 4
    with pytest.raises(SystemExit) as exc:
        train_demo.main(["--device", "cpu", "--lora-rank", "4",
                         "--accum-steps", "2"])
    assert exc.value.code == 2
    assert "--accum-steps is not supported with --lora-rank" in \
        capsys.readouterr().err
