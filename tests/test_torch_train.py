"""The port's training path (kubegpu_tpu_torch.workload.model's loss,
workload.train, workload.data, cmd.train_demo) held against the JAX
package's: the same parameters (JAX ``init_params`` carried across with
``params_from_jax``), the same tokens from numpy with a seed, float32 on
the CPU.

Tolerances, and why:
- loss 1e-5: the float32 forwards agree to 1e-4 in the logits
  (tests/test_torch_model.py) and the loss is a token mean of them;
- parameters after AdamW steps atol 1e-5 / rtol 1e-4: Adam's update is
  about lr = 3e-4 per element per step whatever the gradient's size, so
  float32 rounding of the gradients moves the parameters far less than
  1e-5 over three steps;
- accumulation and remat against the full step, through plain SGD with
  lr 1 (so the parameter change is the gradient itself), 1e-6: the same
  float32 sums split or recomputed.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import data as jdata  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import presets as jpresets  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu_torch.workload import data as tdata  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import presets as tpresets  # noqa: E402
from kubegpu_tpu_torch.workload import train as ttrain  # noqa: E402

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32", attn_impl="xla")
PRESET_CASES = {"dense": {}, "gqa": {}, "windowed": dict(attn_window=16)}


def _configs(name="dense", **kw):
    over = {**SMALL, **PRESET_CASES.get(name, {}), **kw}
    return (jpresets.make_config(name, **over),
            tpresets.make_config(name, **over))


def _params(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _tokens(b=2, t=33, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)


def _sgd(lr=1.0):
    return functools.partial(torch.optim.SGD, lr=lr)


@pytest.mark.parametrize("name", sorted(PRESET_CASES))
def test_loss_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    tok = _tokens()
    want = float(jax.jit(jmodel.make_loss_fn(jcfg))(jp, jnp.asarray(tok)))
    got = tmodel.make_loss_fn(tcfg)(tp, torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - want) <= 1e-5


def test_adamw_steps_match_jax_train_step():
    jcfg, tcfg = _configs("dense")
    jp, tp = _params(jcfg)
    jopt = jtrain.default_optimizer()
    jstate = jopt.init(jp)
    jstep = jtrain.make_train_step(jcfg, None, jopt)
    tparams, tstate, topt = tp, None, ttrain.default_optimizer()
    tstep = ttrain.make_train_step(tcfg, optimizer=topt)
    for i in range(3):
        tok = _tokens(seed=10 + i)
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(tok))
        tparams, tstate, tloss = tstep(tparams, tstate,
                                       torch.from_numpy(tok))
        assert abs(tloss.item() - float(jloss)) <= 1e-5, i
    assert isinstance(tstate, torch.optim.AdamW)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    tleaves = ttrain.param_leaves(tparams)
    # same leaf order: jax sorts dict keys, the port keeps insertion order
    jflat = {tuple(str(k) for k in path): np.asarray(x) for path, x in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert len(jleaves) == len(tleaves) == len(jflat)

    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, prefix + (f"['{k}']",))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, prefix + (f"[{i}]",))
        else:
            yield prefix, tree

    for path, x in walk(tparams):
        np.testing.assert_allclose(x.detach().numpy(), jflat[path],
                                   atol=1e-5, rtol=1e-4, err_msg=str(path))


def test_accum_steps_equal_the_full_batch():
    jcfg, tcfg = _configs("dense")
    _, full = _params(jcfg)
    _, accum = _params(jcfg)
    tok = torch.from_numpy(_tokens(b=4))
    _, _, l1 = ttrain.make_train_step(tcfg, optimizer=_sgd())(full, None,
                                                               tok)
    _, _, l2 = ttrain.make_train_step(tcfg, optimizer=_sgd(),
                                      accum_steps=2)(accum, None, tok)
    assert abs(l1.item() - l2.item()) <= 1e-6
    for a, b in zip(ttrain.param_leaves(full), ttrain.param_leaves(accum)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_accum_steps_errors_match_reference():
    _, tcfg = _configs("dense")
    _, tp = _params(_configs("dense")[0])
    with pytest.raises(ValueError, match="accum_steps"):
        ttrain.make_train_step(tcfg, accum_steps=0)
    with pytest.raises(ValueError, match="accum_steps"):
        jtrain.make_train_step(_configs("dense")[0], None, accum_steps=0)
    step = ttrain.make_train_step(tcfg, accum_steps=2)
    with pytest.raises(ValueError, match="divisible"):
        step(tp, None, torch.from_numpy(_tokens(b=3)))


def test_remat_full_equals_none_and_dots_raises():
    jcfg, tcfg = _configs("dense")
    _, a = _params(jcfg)
    _, b = _params(jcfg)
    tok = torch.from_numpy(_tokens())
    _, _, la = ttrain.make_train_step(tcfg, optimizer=_sgd())(a, None, tok)
    full = tmodel.TransformerConfig(**{**SMALL, "remat": "full"})
    _, _, lb = ttrain.make_train_step(full, optimizer=_sgd())(b, None, tok)
    assert abs(la.item() - lb.item()) <= 1e-6
    for x, y in zip(ttrain.param_leaves(a), ttrain.param_leaves(b)):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    dots = tmodel.TransformerConfig(**{**SMALL, "remat": "dots"})
    with pytest.raises(NotImplementedError, match="slice"):
        tmodel.make_loss_fn(dots)
    with pytest.raises(ValueError, match="remat"):
        tmodel.make_loss_fn(tmodel.TransformerConfig(remat="some"))


def test_remat_full_recomputes_through_the_flash_function():
    """With attn_impl "flash" (the plain versions on CPU tensors) a full
    remat step gives the gradients of the no-remat step."""
    cfg = {**SMALL, "attn_impl": "flash"}
    jcfg, _ = _configs("dense")
    _, a = _params(jcfg)
    _, b = _params(jcfg)
    tok = torch.from_numpy(_tokens())
    ttrain.make_train_step(tmodel.TransformerConfig(**cfg),
                           optimizer=_sgd())(a, None, tok)
    ttrain.make_train_step(
        tmodel.TransformerConfig(**{**cfg, "remat": "full"}),
        optimizer=_sgd())(b, None, tok)
    for x, y in zip(ttrain.param_leaves(a), ttrain.param_leaves(b)):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(), dict(vocab=8192, d_model=2304, n_heads=18, n_layers=6,
                 d_ff=12288, max_seq=2048)], ids=["default", "headline"])
def test_train_step_model_flops_equal_reference(kw):
    j, t = jmodel.TransformerConfig(**kw), tmodel.TransformerConfig(**kw)
    for batch, seq in ((4, 2048), (2, 33)):
        assert ttrain.train_step_model_flops(t, batch, seq) == \
            jtrain.train_step_model_flops(j, batch, seq)


def test_init_sharded_and_optimizer():
    _, tcfg = _configs("dense")
    params, state, opt = ttrain.init_sharded(
        torch.Generator().manual_seed(0), tcfg)
    leaves = ttrain.param_leaves(params)
    assert all(x.requires_grad and x.dtype == torch.float32 for x in leaves)
    assert isinstance(state, torch.optim.AdamW)
    group = state.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.95), 1e-8, 0.01)
    _, none, _ = ttrain.init_sharded(torch.Generator().manual_seed(0), tcfg,
                                     init_optimizer=False)
    assert none is None
    with pytest.raises(NotImplementedError, match="slice 6"):
        ttrain.init_sharded(torch.Generator(), tcfg, mesh=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        ttrain.make_train_step(tcfg, mesh=object())


def _shards(tmp_path, writer, sizes=(5000, 3000), seed=7):
    rng = np.random.default_rng(seed)
    return [writer(str(tmp_path / f"s{i}.kgtd"),
                   rng.integers(0, 1000, size=n, dtype=np.uint32))
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_loader_stream_equals_reference_bit_for_bit(tmp_path, writer):
    write = tdata.write_token_shard if writer == "port" \
        else jdata.write_token_shard
    paths = _shards(tmp_path, write)
    for p in paths:
        assert np.array_equal(tdata.read_token_shard(p),
                              jdata.read_token_shard(p))
    ours = tdata.make_loader(paths, batch=4, seq_len=32, seed=3)
    ref = jdata.PyTokenLoader(paths, batch=4, seq_len=32, seed=3)
    assert isinstance(ours, tdata.PyTokenLoader)
    for _ in range(6):
        a, b = next(ours), next(ref)
        assert a.dtype == b.dtype == np.int32 and a.shape == (4, 33)
        assert np.array_equal(a, b)
    ours.close()


def test_shard_validation_matches_reference(tmp_path):
    import struct

    bad = tmp_path / "bad.kgtd"
    bad.write_bytes(b"NOTASHARD1234567")
    trunc = tmp_path / "trunc.kgtd"
    trunc.write_bytes(b"KGTDSH01" + struct.pack("<Q", 999) + b"\x00" * 8)
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="not a KGTDSH01"):
            mod.read_token_shard(str(bad))
        with pytest.raises(ValueError, match="truncated"):
            mod.read_token_shard(str(trunc))
    with pytest.raises(ValueError, match="no shards"):
        tdata.PyTokenLoader([], 1, 8)
    short = tdata.write_token_shard(str(tmp_path / "short.kgtd"),
                                    np.arange(5, dtype=np.uint32))
    with pytest.raises(ValueError, match="shorter"):
        tdata.PyTokenLoader([short], 1, 8)


def test_train_demo_on_cpu_prints_its_json_line(capsys):
    from kubegpu_tpu_torch.cmd import train_demo

    rc = train_demo.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "32", "--d-model", "32", "--n-layers",
                          "1", "--vocab", "64", "--generate", "4",
                          "--accum-steps", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    for key in ("first_loss", "last_loss", "losses_full", "tokens_per_s",
                "steps", "loader", "devices", "resumed_from_step"):
        assert key in out
    assert out["steps"] == 3 and len(out["losses_full"]) == 3
    assert np.isfinite(out["losses_full"]).all()
    assert out["loader"] == "PyTokenLoader" and out["devices"] == 1
    assert len(out["generated"]) == 4


@pytest.mark.parametrize("flags,slice_no", [
    (["--temperature", "0.8"], 4), (["--top-k", "5"], 4),
    (["--lora-rank", "2"], 5), (["--checkpoint-dir", "x"], 5),
    (["--dp", "1", "--sp", "1", "--tp", "1"], 6), (["--remat", "dots"], 3)])
def test_train_demo_refuses_later_slices(capsys, flags, slice_no):
    from kubegpu_tpu_torch.cmd import train_demo

    with pytest.raises(SystemExit) as exc:
        train_demo.main(["--device", "cpu", *flags])
    assert exc.value.code == 2
    assert f"slice {slice_no}" in capsys.readouterr().err
