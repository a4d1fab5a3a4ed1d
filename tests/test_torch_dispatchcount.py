"""The port's dispatch/sync/build counter
(`kubegpu_tpu_torch/analysis/dispatchcount.py`): the cases of
tests/test_dispatchcount.py at eager PyTorch's seams, and the counter held
against the reference's on the same tiny serving traffic (the JAX
`DecodeServer` under the JAX counter, the port's under the port's)."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from kubegpu_tpu.analysis import dispatchcount as jdc  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload.serve import DecodeServer as JaxServer  # noqa: E402
from kubegpu_tpu_torch.analysis import dispatchcount as dc  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import train as ttrain  # noqa: E402
from kubegpu_tpu_torch.workload.kernels import _build  # noqa: E402
from kubegpu_tpu_torch.workload.serve import DecodeServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, attn_impl="xla", dtype="float32")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [5] * 6, [2, 7]]
MAX_NEW = 9
CHUNK = 4


@pytest.fixture
def counter():
    """The installed counter with zeroed state; uninstalled after, so the
    rest of the suite sees the original torch.Tensor methods."""
    was = dc.installed()
    dc.install()
    dc.reset()
    yield dc
    dc.reset()
    if not was:
        dc.uninstall()


def test_install_is_idempotent_and_uninstall_restores():
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    before = {n: getattr(torch.Tensor, n) for n in dc.SYNC_METHODS}
    own = {n: n in torch.Tensor.__dict__ for n in dc.SYNC_METHODS}
    dc.install()
    try:
        wrapped = {n: getattr(torch.Tensor, n) for n in dc.SYNC_METHODS}
        assert all(wrapped[n] is not before[n] for n in dc.SYNC_METHODS)
        mode = _get_current_dispatch_mode()
        dc.install()                     # second install: no double wrap
        assert {n: getattr(torch.Tensor, n) for n in dc.SYNC_METHODS} == \
            wrapped
        assert _get_current_dispatch_mode() is mode
        assert _build.build_listeners.count(dc._on_build) == 1
    finally:
        dc.uninstall()
    dc.uninstall()                       # second uninstall: a no-op
    for n in dc.SYNC_METHODS:
        assert getattr(torch.Tensor, n) is before[n], n
        assert (n in torch.Tensor.__dict__) == own[n], n
    assert _get_current_dispatch_mode() is None
    assert dc._on_build not in _build.build_listeners
    assert not dc.installed()


def test_importing_the_counter_imports_no_torch():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import kubegpu_tpu_torch.analysis.dispatchcount; "
         "assert 'torch' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


def test_dispatches_and_syncs_attributed_to_sections(counter):
    x = torch.zeros(4)
    with counter.section("warmup"):
        y = x + 1
    with counter.section("steady"):
        for _ in range(5):
            y = y + 1
        y.tolist()
    assert counter.section_counts("warmup") == \
        {"dispatches": 1, "syncs": 0, "builds": 0}
    steady = counter.section_counts("steady")
    assert steady["dispatches"] >= 5 and steady["syncs"] == 1
    assert counter.op_counts("steady")["aten.add"] == 5
    assert counter.counts()["builds_total"] == 0


def test_sections_nest_and_the_innermost_wins(counter):
    x = torch.ones(2)
    with counter.section("outer"):
        x = x * 2
        with counter.section("inner"):
            x = x * 2
            x.sum().item()
        x = x * 2
    assert counter.op_counts("outer") == {"aten.mul": 2}
    assert counter.op_counts("inner")["aten.mul"] == 1
    assert counter.section_counts("inner")["syncs"] == 1
    assert counter.section_counts("outer")["syncs"] == 0


def test_counts_outside_any_section_are_not_attributed(counter):
    torch.ones(3).sum().item()
    counter._bump("dispatches")
    assert counter.counts()["sections"] == {}
    assert counter.counts()["ops"] == {}


@pytest.mark.parametrize("sink", [
    lambda t: t.item(), lambda t: t.tolist(), lambda t: t.cpu(),
    lambda t: t.numpy(), lambda t: bool(t), lambda t: int(t),
    lambda t: float(t), lambda t: [0, 1, 2][t],
    lambda t: t.cpu().numpy(), lambda t: t.cpu().tolist()],
    ids=["item", "tolist", "cpu", "numpy", "bool", "int", "float", "index",
         "cpu_numpy", "cpu_tolist"])
def test_each_sink_counts_one_sync(counter, sink):
    t = torch.tensor(1)
    with counter.section("s"):
        sink(t)
    assert counter.section_counts("s")["syncs"] == 1


def test_builds_are_counted_from_the_nvcc_seam(counter, tmp_path,
                                               monkeypatch):
    """A stand-in compiler that writes its ``-o`` target: `build_all`
    builds each missing library once, telling the counter each time."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    with counter.section("warmup"):
        assert sorted(_build.build_all()) == ["a", "b"]
    with counter.section("steady"):
        _build.build_all()               # both libraries exist: no build
    assert counter.section_counts("warmup")["builds"] == 2
    assert counter.section_counts("steady")["builds"] == 0
    assert counter.counts()["builds_total"] == 2


def test_train_step_counts_each_flash_operator_once_a_layer(counter):
    """One train step of a tiny model on the flash path: the forward and
    backward operators are each one dispatch a layer, and what they run
    inside is not counted again."""
    cfg = tmodel.TransformerConfig(**dict(SMALL, attn_impl="flash"))
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    step = ttrain.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with counter.section("train"):
        _, _, loss = step(params, None, tokens)
        float(loss)
    ops = counter.op_counts("train")
    assert ops["kgt.flash_fwd"] == cfg.n_layers
    assert ops["kgt.flash_bwd"] == cfg.n_layers
    # the loss read, and AdamW's read of each leaf's step counter, a host
    # tensor unless the optimizer is capturable: the same count on the card
    leaves = len(ttrain.param_leaves(params))
    assert counter.section_counts("train")["syncs"] == 1 + leaves


def _jax_counts(slots, fused, monkeypatch):
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1" if fused else "0")
    jdc.install()
    try:
        jcfg = jmodel.TransformerConfig(**SMALL)
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        srv = JaxServer(jcfg, jp, slots=slots, prefill_buckets=(8, 16),
                        chunk=CHUNK)
        for name in ("warm", "run"):
            jdc.reset()
            with jdc.section(name):
                rids = [srv.submit(p, max_new=MAX_NEW) for p in PROMPTS]
                srv.run()
        outs = [srv.result(r) for r in rids]
        return jdc.section_counts("run")["dispatches"], outs, jp
    finally:
        jdc.uninstall()


def _port_counts(slots, fused, jp, monkeypatch):
    monkeypatch.setenv("KGTPU_FUSED_SERVE", "1" if fused else "0")
    cfg = tmodel.TransformerConfig(**SMALL)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    srv = DecodeServer(cfg, params, slots=slots, prefill_buckets=(8, 16),
                       chunk=CHUNK)
    steps = [0]
    real = srv.step

    def step():
        steps[0] += 1
        return real()

    srv.step = step
    dc.install()
    try:
        dc.reset()
        with dc.section("run"):
            rids = [srv.submit(p, max_new=MAX_NEW) for p in PROMPTS]
            srv.run()
        return (dc.section_counts("run")["syncs"], steps[0],
                [srv.result(r) for r in rids])
    finally:
        dc.uninstall()


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "oracle"])
def test_serving_syncs_against_the_reference_counter(slots, fused,
                                                     monkeypatch):
    """The same greedy traffic through both servers: the JAX counter's
    dispatches and the port counter's syncs both come to one a decode
    step (a chunk on the fused path, a token step on the oracle's) plus
    one an admission. Per generated token the fused paths stay within the
    reference's 1.5/chunk budget; the oracles pay one a step, which is at
    least one a token with one slot."""
    jax_dispatches, want, jp = _jax_counts(slots, fused, monkeypatch)
    syncs, steps, got = _port_counts(slots, fused, jp, monkeypatch)
    assert got == want
    tokens = sum(map(len, got))
    assert tokens == len(PROMPTS) * MAX_NEW
    # every step() decodes once: a chunk, or one token step
    assert syncs == steps + len(PROMPTS)
    assert jax_dispatches == syncs
    for per_token in (syncs / tokens, jax_dispatches / tokens):
        if fused:
            assert per_token <= 1.5 / CHUNK
        elif slots == 1:
            assert per_token >= 1.0
    if not fused:
        assert syncs >= tokens / slots


def test_smoke_cli_emits_the_keys_and_gates():
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis.dispatchcount",
         "--smoke", "--tokens", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["decode_syncs_per_token"] == 1.0
    assert out["serve_syncs_per_token"] <= out["serve_sync_budget_per_token"]
    assert out["decode_fixed_builds"] == out["serve_fused_builds"] == 0
    assert out["workload_builds_total"] == 0
    assert out["decode_dispatches_per_token"] > 0


def test_smoke_cli_skips_only_without_torch():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['torch'] = None\n"
         "from kubegpu_tpu_torch.analysis import dispatchcount as d\n"
         "sys.exit(d.main(['--smoke']))"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "skipped" in json.loads(proc.stdout.strip().splitlines()[-1])


def test_smoke_exits_1_over_the_sync_budget(monkeypatch, capsys):
    """A chunk that reads back every token breaks the 1.5/chunk budget."""
    real = dc.section

    @contextlib.contextmanager
    def leaky(name):
        with real(name):
            if name == "serve_fused":
                for _ in range(8):
                    torch.ones(()).item()
            yield

    monkeypatch.setattr(dc, "section", leaky)
    assert dc.smoke(tokens=4, chunk=4) == 1
    assert "exceeds the fused budget" in capsys.readouterr().out


def test_the_key_root_is_a_host_int_equal_to_fold():
    """Admission computes a request's key root on the host
    (`keys.fold_int`), with the bits of the tensor `keys.fold`, so
    admitting reads back only its first token."""
    from kubegpu_tpu_torch.workload import keys

    rng = np.random.default_rng(0)
    for seed, rid in rng.integers(-2**40, 2**40, size=(200, 2)):
        assert keys.fold_int(int(seed), int(rid)) == \
            int(keys.fold(int(seed), int(rid)))
