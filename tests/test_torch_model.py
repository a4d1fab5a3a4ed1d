"""The port's model (kubegpu_tpu_torch.workload.model) held against the JAX
package's: the same parameters (JAX ``init_params`` carried across with
``params_from_jax``), the same tokens, float32 logits within 1e-4 (the
tolerance of tests/test_kernels.py::test_model_flash_impl_matches_xla).
Also the config checks, presets, scope guards, device rule, the entry
point and import hygiene of the port."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import presets as jpresets  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import presets as tpresets  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32", attn_impl="xla")
# windowed: the preset's 64-key window never bites at T=48, so narrow it
PRESET_CASES = {"dense": {}, "gqa": {}, "windowed": dict(attn_window=16)}


def _configs(name, **kw):
    over = {**SMALL, **PRESET_CASES.get(name, {}), **kw}
    return (jpresets.make_config(name, **over),
            tpresets.make_config(name, **over))


def _params(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _tokens(b=2, t=48, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)


@pytest.mark.parametrize("name", sorted(PRESET_CASES))
def test_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    tok = _tokens()
    want = np.asarray(jax.jit(jmodel.make_forward(jcfg))(jp,
                                                         jnp.asarray(tok)))
    got = tmodel.make_forward(tcfg)(tp, torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == (2, 48, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(PRESET_CASES))
def test_flash_impl_matches_plain_attention(name):
    _, tcfg = _configs(name)
    _, tp = _params(_configs(name)[0])
    tok = torch.from_numpy(_tokens())
    lx = tmodel.make_forward(tcfg)(tp, tok)
    lf = tmodel.make_forward(dataclasses.replace(tcfg, attn_impl="flash"))(
        tp, tok)
    torch.testing.assert_close(lf, lx, atol=1e-4, rtol=1e-4)


def test_bf16_logits_track_jax():
    """The default bf16 compute dtype: same cast points as the reference
    (RMSNorm variance in f32, cos/sin in bf16, f32 logits), so the logits
    stay within bf16 rounding of JAX's."""
    jcfg, tcfg = _configs("dense", dtype="bfloat16")
    jp, tp = _params(jcfg)
    tok = _tokens()
    want = np.asarray(jax.jit(jmodel.make_forward(jcfg))(jp,
                                                         jnp.asarray(tok)))
    got = tmodel.make_forward(tcfg)(tp, torch.from_numpy(tok)).numpy()
    assert np.abs(got - want).mean() < 2e-2


def test_init_params_layout_matches_reference():
    jcfg, tcfg = _configs("gqa")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree, conv):
        if isinstance(tree, dict):
            return {k: shapes(v, conv) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v, conv) for v in tree]
        return conv(tree)

    assert shapes(tp, lambda x: (tuple(x.shape), str(x.dtype))) == \
        shapes(jp, lambda x: (tuple(x.shape), "torch." + str(x.dtype)))
    # drawn from the generator: reproducible per seed, different across
    again = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    other = tmodel.init_params(torch.Generator().manual_seed(1), tcfg)
    assert torch.equal(tp["layers"][1]["wq"], again["layers"][1]["wq"])
    assert not torch.equal(tp["layers"][1]["wq"], other["layers"][1]["wq"])


def test_config_checks_match_reference():
    for kw in (dict(attn_window=-1), dict(n_experts=2, moe_top_k=3)):
        with pytest.raises(ValueError):
            jmodel.TransformerConfig(**kw)
        with pytest.raises(ValueError):
            tmodel.TransformerConfig(**kw)
    with pytest.raises(ValueError, match="must divide"):
        _ = tmodel.TransformerConfig(n_heads=8, n_kv_heads=3).kv_heads
    assert [f.name for f in dataclasses.fields(tmodel.TransformerConfig)] \
        == [f.name for f in dataclasses.fields(jmodel.TransformerConfig)]
    assert dataclasses.asdict(tmodel.TransformerConfig()) == \
        dataclasses.asdict(jmodel.TransformerConfig())


def test_presets_equal_reference():
    assert tpresets.PRESETS == jpresets.PRESETS
    assert tpresets.preset_names() == jpresets.preset_names()
    with pytest.raises(KeyError, match="unknown preset"):
        tpresets.make_config("nope")


def test_auto_resolves_to_plain_attention_on_cpu():
    cfg = tmodel.TransformerConfig()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tmodel._resolve_attn_impl(cfg, 1024, cpu) == "xla"
    assert tmodel._resolve_attn_impl(cfg, 1024, cuda) == "flash"
    assert tmodel._resolve_attn_impl(cfg, 1000, cuda) == "xla"
    flash = dataclasses.replace(cfg, attn_impl="flash")
    assert tmodel._resolve_attn_impl(flash, 77, cpu) == "flash"


def test_out_of_slice_paths_raise():
    """A mesh builds now (slice 6) and the ``moe`` preset builds; an object
    that is not a mesh raises TypeError."""
    from tests.torch_worlds import single_rank_mesh

    with single_rank_mesh() as mesh:
        tmodel.make_forward(tpresets.make_config("moe"), mesh=mesh)
        tmodel.make_forward(tmodel.TransformerConfig(), mesh=mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmodel.make_forward(tpresets.make_config("moe"), mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmodel.make_forward(tmodel.TransformerConfig(), mesh=object())
    params = tmodel.init_params(torch.Generator(),
                                tpresets.make_config("moe"))
    assert "moe" in params["layers"][0]


def test_cuda_is_the_default_device():
    """Without a GPU, entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodel.params_from_jax({"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32


def test_entry_forward_on_cpu():
    from kubegpu_tpu_torch.entry import entry

    fwd, (params, tokens) = entry(device="cpu")
    assert tuple(tokens.shape) == (2, 128)
    logits = fwd(params, tokens)
    assert logits.shape == (2, 128, 512) and torch.isfinite(logits).all()


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax, kubegpu_tpu and every kubegpu_tpu.* out of sys.modules (the
    port's own name starts with ``kubegpu_tpu`` too, so match exactly)."""
    pkg = os.path.join(REPO, "kubegpu_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    for name in ("workload.serve", "workload.train", "workload.data",
                 "cmd.train_demo", "workload.kernels.flash",
                 "workload.speculative", "workload.keys", "native",
                 "workload.lora", "workload.checkpoint", "workload.moe",
                 "workload.spmd", "workload.ring", "workload.ulysses",
                 "workload.pipeline", "entry", "core.types", "core.grammar",
                 "core.codec", "utils", "node.backend", "node.fake",
                 "node.nvml", "node.manager", "runtime.hook", "topology.tree",
                 "allocator.translate", "allocator.scorers",
                 "allocator.grpalloc", "scheduler.gpu_scheduler",
                 "plugins.device.gpu_device",
                 "plugins.scheduler.gpu_scheduler_plugin",
                 "cluster.httpapi", "cluster.stream", "node.advertiser",
                 "runtime.server",
                 "runtime.launcher", "cmd.common", "cmd.node_agent",
                 "cmd.cri_hook", "analysis.dispatchcount", "analysis.engine",
                 "analysis.dataflow", "analysis.rules.hostsync",
                 "analysis.rules.suppressions", "analysis.__main__",
                 "metrics", "obs", "obs.trace", "scheduler",
                 "scheduler.predicates", "scheduler.interpod",
                 "scheduler.priorities", "scheduler.equivalence",
                 "scheduler.volumebinder", "scheduler.queue",
                 "scheduler.cache", "scheduler.factory",
                 "scheduler.registry", "scheduler.gang", "scheduler.core",
                 "cluster.lease", "obs.flight", "obs.profile",
                 "obs.timeseries", "obs.validate", "cmd.scheduler_main",
                 "scheduler.lifecycle", "scheduler.vectorized",
                 "scheduler.batch", "cluster.apf", "scheduler.quota",
                 "scheduler.extender", "scheduler.repair",
                 "cluster.apiserver", "cluster.wal", "cmd.apiserver_main",
                 "cluster.proxy", "cluster.chaos", "cmd.proxy_main",
                 "cmd.simulate", "analysis.explore", "analysis.schedules",
                 "cluster.kubeclient", "cluster.mock_kube",
                 "analysis.locksets", "analysis.rules.locks",
                 "analysis.rules.clocks", "analysis.rules.exceptions",
                 "analysis.rules.codecs", "analysis.rules.charges",
                 "analysis.rules.lifecycle", "analysis.rules.metricsrule",
                 "analysis.rules.wire", "analysis.rules.racer",
                 "analysis.rules.twins", "analysis.mutate",
                 "analysis.lockgraph", "analysis.leakguard",
                 "analysis.pytest_plugin"):
        assert f"kubegpu_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kubegpu_tpu' or m.startswith('kubegpu_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    # and the smoke script, which the chip run imports alone
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke\n"
         "assert not [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'kubegpu_tpu')]"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
