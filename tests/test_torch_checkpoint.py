"""The port's train-state checkpoints (kubegpu_tpu_torch.workload.checkpoint)
held against the JAX package's numpy format (kubegpu_tpu/workload/
checkpoint.py: ``_save_numpy`` and the npz branch of
``restore_checkpoint``), mirroring tests/test_workload_parallel.py's
round trip and absent directory, tests/test_dataloader.py's torn newest
step, resume and serve-from-checkpoint, and tests/test_gqa.py's named-leaf
shape mismatch.

Across packages, in both directions: a JAX train state written by
``_save_numpy`` restores into the port's params and AdamW, and the port's
third step then matches JAX's third within tests/test_torch_train.py's
AdamW-step tolerances (loss 1e-5, parameters atol 1e-5 / rtol 1e-4); a
state the port writes reads back through JAX's ``restore_checkpoint``
leaf for leaf, bit for bit, ``count`` as int32."""

import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import checkpoint as jckpt  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu_torch.workload import checkpoint as tckpt  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import train as ttrain  # noqa: E402

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32", attn_impl="xla")


def _params(seed=0, **kw):
    cfg = tmodel.TransformerConfig(**{**SMALL, **kw})
    return cfg, tmodel.init_params(torch.Generator().manual_seed(seed), cfg)


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 64, (2, 33)) \
        .astype(np.int32)


def _equal(a, b):
    la, lb = ttrain.param_leaves(a), ttrain.param_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    _, params = _params()
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, params, step=3)
    tckpt.save_checkpoint(path, params, step=7)
    restored, step = tckpt.restore_checkpoint(path, params)
    assert step == 7 and _equal(params, restored)
    assert list(restored) == list(params)
    assert json.load(open(os.path.join(path, "step_7", "meta.json"))) == \
        {"step": 7, "n_leaves": len(ttrain.param_leaves(params))}


def test_checkpoint_restore_empty(tmp_path):
    state, step = tckpt.restore_checkpoint(str(tmp_path / "missing"),
                                           {"a": torch.zeros(1)})
    assert state is None and step == -1


def test_restore_skips_corrupt_newest_step(tmp_path):
    """A torn newest step (directory, no payload) and an orbax step (no
    leaves.npz) fall back to the next older one; saves leave no temp
    directory behind."""
    state = {"w": torch.arange(4.0)}
    tckpt.save_checkpoint(str(tmp_path), state, step=2)
    (tmp_path / "step_4").mkdir()
    (tmp_path / "step_6").mkdir()
    (tmp_path / "step_6" / "_CHECKPOINT_METADATA").write_text("{}")
    restored, step = tckpt.restore_checkpoint(str(tmp_path), state)
    assert step == 2 and torch.equal(restored["w"], torch.arange(4.0))
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]


def test_restore_rejects_checkpoint_from_other_config(tmp_path, caplog):
    """An MHA checkpoint restored into a GQA config fails at the named
    leaf, with a warning, and falls back to none."""
    _, saved = _params()
    tckpt.save_checkpoint(str(tmp_path), saved, step=5)
    _, like = _params(n_kv_heads=2)
    with caplog.at_level(logging.WARNING):
        state, step = tckpt.restore_checkpoint(str(tmp_path), like)
    assert state is None and step == -1
    text = "".join(r.message + str(r.exc_info[1]) for r in caplog.records
                   if r.exc_info)
    assert "unreadable" in text and "leaf" in text and "shape" in text


def _jax_state(jp):
    return {"params": jp, "opt_state": jtrain.default_optimizer().init(jp)}


@pytest.mark.parametrize("kw", [{}, dict(n_experts=4, moe_top_k=2)],
                         ids=["dense", "moe"])
def test_train_state_leaves_in_jax_flatten_order(kw):
    """The port's train state flattens as JAX flattens
    ``{"params", "opt_state"}`` (optax adamw: count, mu, nu, then params;
    dict keys sorted, a layer's ``moe`` among its weights): the same
    number of leaves with the same shapes and dtypes."""
    jcfg = jmodel.TransformerConfig(**SMALL, **kw)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    _, tp = _params(**kw)
    opt = ttrain.default_optimizer()(ttrain.param_leaves(tp))
    ours = ttrain.param_leaves({"params": tp,
                              "opt_state": tckpt.adamw_state(opt, tp)})
    theirs = jax.tree.leaves(_jax_state(jp))
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in ours] == \
        [(tuple(x.shape), str(x.dtype)) for x in theirs]
    template = ttrain.param_leaves({"params": tp,
                                  "opt_state": tckpt.adamw_template(tp)})
    assert [tuple(x.shape) for x in template] == \
        [tuple(x.shape) for x in ours]
    assert all(x.device.type == "meta" for x in template[:-len(
        ttrain.param_leaves(tp))])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains 2 steps and writes with ``_save_numpy``; the port
    restores params and AdamW state and its step 3 matches JAX's."""
    jcfg = jmodel.TransformerConfig(**SMALL)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jtrain.default_optimizer()
    jstate = jopt.init(jp)
    jstep = jtrain.make_train_step(jcfg, None, jopt)
    for s in (10, 11):
        jp, jstate, _ = jstep(jp, jstate, jnp.asarray(_tokens(s)))
    jckpt._save_numpy(str(tmp_path), {"params": jp, "opt_state": jstate},
                      step=2)
    jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(_tokens(12)))

    tcfg, tp = _params(seed=9)                   # other values, same shapes
    opt = ttrain.default_optimizer()(ttrain.param_leaves(tp))
    state, step = tckpt.restore_checkpoint(
        str(tmp_path), {"params": tp, "opt_state": tckpt.adamw_template(tp)})
    assert step == 2 and state["opt_state"][0].dtype == torch.int32
    tckpt.load_train_state(opt, tp, state)
    assert all(opt.state[x]["step"].item() == 2.0
               and opt.state[x]["step"].device.type == "cpu"
               for x in ttrain.param_leaves(tp))
    _, _, loss = ttrain.make_train_step(tcfg)(tp, opt,
                                              torch.from_numpy(_tokens(12)))
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for x, w in zip(ttrain.param_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)


def test_port_checkpoint_reads_back_in_jax(tmp_path):
    """The port trains 2 steps and saves; JAX's ``restore_checkpoint``
    (its npz branch) reads every leaf back bit for bit into a JAX train
    state template."""
    tcfg, tp = _params()
    opt = ttrain.default_optimizer()(ttrain.param_leaves(tp))
    step = ttrain.make_train_step(tcfg)
    for s in (10, 11):
        tp, opt, _ = step(tp, opt, torch.from_numpy(_tokens(s)))
    state = {"params": tp, "opt_state": tckpt.adamw_state(opt, tp)}
    tckpt.save_checkpoint(str(tmp_path), state, step=2)
    assert os.path.exists(tmp_path / "step_2" / "leaves.npz")
    jp = jmodel.init_params(jax.random.PRNGKey(1),
                            jmodel.TransformerConfig(**SMALL))
    restored, at = jckpt.restore_checkpoint(str(tmp_path), _jax_state(jp))
    assert at == 2
    count = restored["opt_state"][0].count
    assert count.dtype == jnp.int32 and int(count) == 2
    ours = ttrain.param_leaves(state)
    theirs = jax.tree.leaves(restored)
    assert len(ours) == len(theirs)
    for x, y in zip(ours, theirs):
        assert np.array_equal(x.detach().numpy(), np.asarray(y))
    mu = restored["opt_state"][0].mu["layers"][1]["wq"]
    assert np.array_equal(np.asarray(mu),
                          opt.state[tp["layers"][1]["wq"]]["exp_avg"])


SIZE = ["--seq", "32", "--vocab", "64", "--d-model", "32", "--n-layers",
        "1", "--n-heads", "4"]


def _train(capsys, *flags):
    from kubegpu_tpu_torch.cmd import train_demo

    assert train_demo.main(["--device", "cpu", "--batch", "2", *SIZE,
                            *flags]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", [[], ["--lora-rank", "4"]],
                         ids=["full", "lora"])
def test_train_demo_checkpoint_resume(tmp_path, capsys, mode):
    """A second run on the same --checkpoint-dir resumes from step 2,
    skips the batches the first run consumed, and its losses equal the
    last two of an uninterrupted 4-step run's."""
    ck = ["--checkpoint-dir", str(tmp_path / "ckpt"), "--checkpoint-every",
          "2"]
    first = _train(capsys, "--steps", "2", *mode, *ck)
    second = _train(capsys, "--steps", "2", *mode, *ck)
    whole = _train(capsys, "--steps", "4", *mode)
    assert first["resumed_from_step"] == 0
    assert second["resumed_from_step"] == 2
    assert first["losses_full"] + second["losses_full"] == \
        whole["losses_full"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2", "step_4"]


def test_train_demo_checkpoint_serves(tmp_path, capsys):
    """serve_demo --checkpoint-dir restores what train_demo saved (params
    and AdamW state on disk; the server drops the moments) and reports
    the step; an empty directory is refused."""
    from kubegpu_tpu_torch.cmd import serve_demo

    ck = str(tmp_path / "ckpt")
    size = ["--seq", "64", "--vocab", "64", "--d-model", "32",
            "--n-layers", "1", "--n-heads", "4"]
    _train(capsys, "--steps", "2", "--checkpoint-dir", ck,
           "--checkpoint-every", "2")
    argv = ["--device", "cpu", "--requests", "2", "--max-new", "4", *size]
    assert serve_demo.main([*argv, "--checkpoint-dir", ck]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["restored_step"] == 2 and out["tokens"] == 2 * 4
    assert serve_demo.main(argv) == 0
    fresh = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "restored_step" not in fresh
    with pytest.raises(SystemExit) as exc:
        serve_demo.main([*argv, "--checkpoint-dir", str(tmp_path / "none")])
    assert exc.value.code == 2
    assert "no readable checkpoint" in capsys.readouterr().err


def test_train_demo_rejects_bad_checkpoint_every(capsys):
    from kubegpu_tpu_torch.cmd import train_demo

    with pytest.raises(SystemExit) as exc:
        train_demo.main(["--device", "cpu", "--checkpoint-every", "0"])
    assert exc.value.code == 2
    assert "--checkpoint-every must be >= 1" in capsys.readouterr().err
