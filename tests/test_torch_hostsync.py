"""The port's host-sync rule (`kubegpu_tpu_torch/analysis/rules/hostsync.py`)
against the JAX package's (`kubegpu_tpu/analysis/rules/deviceflow.py`):
torch twins of tests/fixtures/analysis/{bad,good}/deviceflow_*.py give the
same findings, the stale-waiver audit, the report over the port ranked as
the reference's is over the JAX package, and the CLI."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.analysis.engine import run_analysis as jax_analysis  # noqa: E402
from kubegpu_tpu_torch.analysis.engine import run_analysis  # noqa: E402
from kubegpu_tpu_torch.analysis.rules import hostsync  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BAD = os.path.join(REPO, "tests", "fixtures", "analysis", "bad",
                       "deviceflow_bad.py")
PORT = os.path.join(REPO, "kubegpu_tpu_torch")

BAD = '''"""Bad twin (torch) of deviceflow_bad.py: per-iteration host syncs, an
unjustified waiver and a stale one. Analysed, never imported."""

import torch


def make_token_step():
    def token_step(cache, tok):
        return cache + tok, tok + 1

    return token_step


step = make_token_step()


def serve_loop(cache, tok):
    out = []
    for _ in range(8):
        cache, tok = step(cache, tok)
        out.append(float(tok))  # host-sync: scalar readback per token
        if tok > 0:  # host-sync: implicit bool() blocks on device value
            out.append(1)
    return cache, out


def report_step(metrics):
    total = torch.sum(metrics)
    # host-sync: allowed
    host_total = float(total)  # waiver above has no `-- justification`
    return host_total


def batched_flush(vals):
    # host-sync: allowed -- the flush used to read back per step (fixed
    # by the batched rewrite; this waiver is now stale)
    total = torch.add(vals, vals)
    return total
'''

GOOD = '''"""Good twin (torch) of deviceflow_good.py: the one deliberate
per-step readback is batched and waived with a justification, and shape
logic reads host metadata, never a device value."""

import torch


def make_token_step():
    def token_step(cache, tok):
        return cache + tok, tok + 1

    return token_step


step = make_token_step()


def serve_loop(cache, tok, n):
    outs = []
    for _ in range(n):
        cache, tok = step(cache, tok)
        # host-sync: allowed -- one batched readback per step is the
        # product: EOS tests and output append are host decisions
        outs.append(tok.cpu().numpy())
    return cache, outs


def shape_guard(x):
    # host metadata, not device data: this never blocks
    if x.shape[0] != 4:
        raise ValueError("bad batch width")
    return torch.sum(x)
'''

# The port's DecodeServer.run sites beside the JAX package's
# (kubegpu_tpu/workload/serve.py), by the function that holds each.
SITE_TWINS = {
    ("DecodeServer.step", ".cpu()"): ("DecodeServer.step", "np.asarray()"),
    ("DecodeServer._fused_step", ".cpu()"):
        ("DecodeServer._fused_step", "jax.device_get()"),
    ("DecodeServer._spec_fused_step", ".cpu()"):
        ("DecodeServer._spec_fused_step", "jax.device_get()"),
    ("DecodeServer._spec_step", ".cpu()"):
        ("DecodeServer._spec_step", "jax.device_get()"),
    ("DecodeServer._admit", "int()"): ("DecodeServer._admit", "int()"),
}
# The JAX server's sixth site has no twin: it mirrors each admitted
# request's threefry key to the host (np.asarray of a device key), while
# the port computes a request's key root on the host as a Python int
# (keys.fold_int), so there is nothing to read back.
JAX_ONLY_SITES = {("DecodeServer._admit", "np.asarray()")}


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _shape(findings) -> list:
    """(kind, function) of each host-sync finding."""
    out = []
    for f in findings:
        fn = re.search(r"\(([\w.]+)\); batch", f.message)
        if "waiver without a justification" in f.message:
            out.append(("waiver", None))
        elif "implicit bool()" in f.message:
            out.append(("implicit", fn.group(1)))
        else:
            out.append((f.message.split(" ", 1)[0], fn.group(1)))
    return sorted(out, key=str)


def test_bad_twin_gives_the_reference_findings(tmp_path):
    port = run_analysis([_write(tmp_path, "bad.py", BAD)],
                        select=["host-sync"])
    ref = jax_analysis([JAX_BAD], select=["host-sync"])
    assert len(port) == len(ref) == 3
    assert _shape(port) == _shape(ref) == sorted([
        ("float()", "serve_loop"), ("implicit", "serve_loop"),
        ("waiver", None)], key=str)


def test_good_twin_is_clean(tmp_path):
    path = _write(tmp_path, "good.py", GOOD)
    assert run_analysis([path], select=["host-sync"]) == []
    assert run_analysis([path]) == []


def test_stale_waiver_is_flagged_only_when_host_sync_ran(tmp_path):
    path = _write(tmp_path, "bad.py", BAD)
    hits = run_analysis([path], select=["host-sync", "unused-suppression"])
    stale = [f for f in hits if f.rule == "unused-suppression"]
    assert len(stale) == 1 and "no longer covers" in stale[0].message
    assert stale[0].line == BAD.splitlines().index(
        "    # host-sync: allowed -- the flush used to read back per step "
        "(fixed") + 1
    assert run_analysis([path], select=["unused-suppression"]) == []


def test_scope_is_torch_files_under_workload(tmp_path):
    """A tree is scanned only under ``workload``; a file there without
    torch is out of scope."""
    tree = tmp_path / "pkg"
    (tree / "workload").mkdir(parents=True)
    (tree / "cmd").mkdir()
    (tree / "workload" / "w.py").write_text(BAD)
    (tree / "cmd" / "c.py").write_text(BAD)
    (tree / "workload" / "n.py").write_text(BAD.replace("import torch", ""))
    hits = run_analysis([str(tree)], select=["host-sync"])
    assert {os.path.basename(f.path) for f in hits} == {"w.py"}


def test_report_ranks_the_serving_loop_first_all_waived():
    reports = {}
    assert run_analysis([PORT], select=["host-sync"], reports=reports) == []
    top = reports["host-sync"]["roots"][0]
    assert top["function"] == "DecodeServer.run"
    assert all(site["waived"] for site in top["sites"])
    port_sites = {(s["function"], s["desc"].split(" ", 1)[0])
                  for s in top["sites"]}
    assert port_sites == set(SITE_TWINS)
    assert top["syncs_per_iteration"] == len(SITE_TWINS)
    # the JAX rule over the JAX package: the twins plus the JAX-only site
    jreports = {}
    jax_analysis([os.path.join(REPO, "kubegpu_tpu", "workload")],
                 select=["host-sync"], reports=jreports)
    jtop = jreports["host-sync"]["roots"][0]
    assert jtop["function"] == "DecodeServer.run"
    jax_sites = {(s["function"], s["desc"].split(" ", 1)[0])
                 for s in jtop["sites"]}
    assert jax_sites == set(SITE_TWINS.values()) | JAX_ONLY_SITES
    assert jtop["syncs_per_iteration"] == 6
    text = hostsync.render_report(reports["host-sync"])
    assert "#1 DecodeServer.run" in text and "[waived]" in text


def test_stripping_the_waivers_brings_the_findings_back(tmp_path):
    with open(os.path.join(PORT, "workload", "serve.py")) as f:
        text = f.read()
    stripped = re.sub(r"# host-sync: allowed -- ", "# ", text)
    assert stripped != text
    hits = run_analysis([_write(tmp_path, "serve.py", stripped)],
                        select=["host-sync"])
    assert len(hits) >= 3
    assert {re.search(r"\((DecodeServer\.\w+)\)", f.message).group(1)
            for f in hits} >= {"DecodeServer.step",
                               "DecodeServer._fused_step",
                               "DecodeServer._admit"}


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_cli_is_clean_over_the_port_and_ranks_the_report():
    proc = _cli("--rule", "host-sync", "--report", "kubegpu_tpu_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean: no findings" in proc.stdout
    assert "#1 DecodeServer.run" in proc.stdout
    assert _cli("kubegpu_tpu_torch").returncode == 0


def test_cli_exits_1_on_findings_and_2_on_a_bad_rule(tmp_path):
    path = _write(tmp_path, "bad.py", BAD)
    proc = _cli(path)
    assert proc.returncode == 1
    assert "4 finding(s): 3 host-sync, 1 unused-suppression" in proc.stdout
    proc = _cli("--rule", "no-such-rule", path)
    assert proc.returncode == 2 and "unknown rule" in proc.stderr
