"""The port's control-plane static rules (``kubegpu_tpu_torch/analysis``:
locks, clocks, exceptions, codecs, charges, lifecycle, metrics, wire,
racer, hot-path and the twin rules, with the suppression audit) held
against the JAX package's: the same findings (rule, file, line, message)
on every fixture of tests/fixtures/analysis, the detail tests of
tests/test_analysis.py and the lockset-model tests of
tests/test_locksets.py as port tests, and the port's own tree clean under
its rules and under the JAX package's."""

import json
import os
import subprocess
import sys

import pytest

from kubegpu_tpu.analysis import run_analysis as jax_run_analysis
from kubegpu_tpu_torch.analysis.engine import (AnalysisError, all_rules,
                                               load_sources, run_analysis)
from kubegpu_tpu_torch.analysis.locksets import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
BAD = os.path.join(FIXTURES, "bad")
GOOD = os.path.join(FIXTURES, "good")
TESTS_DIR = os.path.join(REPO, "tests")
PKG = os.path.join(REPO, "kubegpu_tpu_torch")

# the rules ported from the JAX package, the 16 its tree is gated by
PORTED = ["lock-discipline", "no-blocking-under-lock", "transitive-locks",
          "monotonic-time", "codec-pairing", "no-swallowed-exceptions",
          "metric-registration", "charge-pairing", "resource-lifecycle",
          "wire-contract", "racer", "hot-path", "twin-coverage",
          "mirror-maintenance", "reason-parity", "unused-suppression"]
TWIN_RULES = ["twin-coverage", "mirror-maintenance", "reason-parity"]
TWIN_FIXTURES = sorted(
    os.path.join(tree, name) for tree in ("bad", "good")
    for name in os.listdir(os.path.join(FIXTURES, tree))
    if name.startswith(("twins_", "mirror_", "reasons_")))
RULES = PORTED + ["host-sync"]
FIXTURE_FILES = sorted(
    os.path.join(tree, name) for tree in ("bad", "good")
    for name in os.listdir(os.path.join(FIXTURES, tree))
    if name.endswith(".py"))


def findings_for(root, rule=None):
    select = [rule] if rule else None
    return run_analysis([root], select=select, tests_dir=TESTS_DIR)


# twin-coverage names the differential tests it read: the port's two
# files where the JAX rule names its test_vector*.py glob
_PORT_DIFF_TESTS = "(test_torch_vectorized.py, test_torch_batch.py)"
_JAX_DIFF_TESTS = "(test_vector*.py)"


def _keyed(findings) -> list:
    return [(f.rule, f.path, f.line,
             f.message.replace(_PORT_DIFF_TESTS, _JAX_DIFF_TESTS))
            for f in findings]


@pytest.fixture(scope="module")
def evidence(tmp_path_factory):
    """A tests directory both packages' rules read alike. The fixtures'
    twin pairs model the JAX package's (its mesh search among them), which
    its differential suites exercise, so those suites stand here under
    both rules' names: test_vectorized.py and test_vector_batch.py (the
    JAX rule's test_vector*.py) and test_torch_vectorized.py and
    test_torch_batch.py (the port's). The codec round-trip tests are
    copied as they are. Each rule then judges the same pairs against the
    same identifiers."""
    import shutil

    out = tmp_path_factory.mktemp("evidence")
    for name in os.listdir(TESTS_DIR):
        if name.startswith(("test_codec", "test_torch_codec")):
            shutil.copy(os.path.join(TESTS_DIR, name), out / name)
    for jax_name, port_name in (("test_vectorized.py",
                                 "test_torch_vectorized.py"),
                                ("test_vector_batch.py",
                                 "test_torch_batch.py")):
        shutil.copy(os.path.join(TESTS_DIR, jax_name), out / jax_name)
        shutil.copy(os.path.join(TESTS_DIR, jax_name), out / port_name)
    return str(out)


def _both(root, rules, tests_dir=TESTS_DIR) -> tuple:
    """(the port's findings, the JAX rules' findings) on one input."""
    return (run_analysis([root], select=rules, tests_dir=tests_dir),
            jax_run_analysis([root], select=rules, tests_dir=tests_dir))


def test_rule_registry_is_complete():
    assert sorted(r.name for r in all_rules()) == sorted(RULES)


# ---- parity with the JAX rules ---------------------------------------------


@pytest.mark.parametrize("tree", ["bad", "good"])
@pytest.mark.parametrize("rule", PORTED)
def test_findings_equal_the_jax_rule_on_each_fixture_tree(tree, rule,
                                                          evidence):
    root = os.path.join(FIXTURES, tree)
    got, want = _both(root, [rule], evidence)
    assert _keyed(got) == _keyed(want)
    if tree == "good":
        assert got == []
    elif rule != "unused-suppression":
        assert got and all(f.rule == rule for f in got)


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_findings_equal_the_jax_rules_on_each_fixture_file(fixture,
                                                           evidence):
    path = os.path.join(FIXTURES, fixture)
    got, want = _both(path, PORTED, evidence)
    assert _keyed(got) == _keyed(want)


# ---- the tree is clean -------------------------------------------------------


def test_port_tree_is_clean_via_cli_with_every_rule():
    """`python -m kubegpu_tpu_torch.analysis kubegpu_tpu_torch` exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--stats",
         "kubegpu_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no findings" in proc.stdout
    for rule in RULES:
        assert rule in proc.stderr  # every registered rule ran


def test_jax_rules_find_nothing_in_the_port():
    assert jax_run_analysis([PKG], select=PORTED, tests_dir=TESTS_DIR) == []


def test_bad_fixtures_fail_via_cli_with_every_ported_rule():
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis",
         os.path.join("tests", "fixtures", "analysis", "bad")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    for rule in PORTED:
        assert f"[{rule}]" in proc.stdout, f"{rule} did not fire via CLI"


def test_codec_pairing_reads_the_port_codec_tests(tmp_path):
    """The rule's round-trip evidence is the port's tests
    (test_torch_codec*.py), never the reference's (test_codec*.py), which
    exercise another codec."""
    codec = tmp_path / "codec.py"
    codec.write_text("def encode_thing(x):\n    return x\n"
                     "def decode_thing(x):\n    return x\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_codec_ref.py").write_text(
        "from m import encode_thing, decode_thing\n"
        "decode_thing(encode_thing(1))\n")
    (tests / "test_torch_codec_port.py").write_text("x = 1\n")
    hits = run_analysis([str(codec)], select=["codec-pairing"],
                        tests_dir=str(tests))
    assert {f.line for f in hits} == {1, 3}
    (tests / "test_torch_codec_port.py").write_text(
        "from m import encode_thing, decode_thing\n"
        "decode_thing(encode_thing(1))\n")
    assert run_analysis([str(codec)], select=["codec-pairing"],
                        tests_dir=str(tests)) == []


# ---- the detail tests of tests/test_analysis.py ------------------------------




def test_lock_discipline_details():
    hits = findings_for(BAD, "lock-discipline")
    lines = {f.line for f in hits}
    by_msg = " ".join(f.message for f in hits)
    assert "RacyCounter.count" in by_msg
    assert len(lines) == 2  # the unlocked read AND the unlocked write


def test_locked_suffix_convention_is_exempt():
    hits = findings_for(GOOD, "lock-discipline")
    assert hits == []  # _bump_locked in the good fixture must not flag


def test_suppression_requires_matching_rule(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text(
        "import time\n"
        "# analysis: disable=codec-pairing -- wrong rule, must NOT silence\n"
        "t = time.time()\n")
    hits = run_analysis([str(src)], select=["monotonic-time"])
    assert len(hits) == 1
    src.write_text(
        "import time\n"
        "# analysis: disable=monotonic-time -- right rule\n"
        "t = time.time()\n")
    assert run_analysis([str(src)], select=["monotonic-time"]) == []


def test_disable_file_scope(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text(
        "# analysis: disable-file=monotonic-time -- whole-file waiver\n"
        "import time\n"
        "a = time.time()\n"
        "b = time.time()\n")
    assert run_analysis([str(src)], select=["monotonic-time"]) == []


def test_unknown_rule_is_an_error():
    with pytest.raises(AnalysisError):
        run_analysis([GOOD], select=["not-a-rule"])


# ---- the twin rules (tests/test_analysis.py's, in parity form) -------------


@pytest.mark.parametrize("fixture", TWIN_FIXTURES)
def test_twin_rules_equal_the_jax_rules_on_each_twin_fixture(fixture,
                                                             evidence):
    path = os.path.join(FIXTURES, fixture)
    for rule in TWIN_RULES:
        got, want = _both(path, [rule], evidence)
        assert _keyed(got) == _keyed(want), rule
        if fixture.startswith("good"):
            assert got == [], rule


def test_twin_coverage_flags_each_contract_breach(evidence):
    hits, want = _both(os.path.join(BAD, "twins_bad.py"), ["twin-coverage"],
                       evidence)
    msgs = " ".join(f.message for f in hits)
    assert "dangling" in msgs                      # unresolvable twin-of
    assert "never appears in the differential tests" in msgs
    assert _PORT_DIFF_TESTS in msgs                # the port's suites
    assert "no declared vector twin and no `# vector-gate:`" in msgs
    assert "binds to no function definition" in msgs  # orphaned comment
    assert len(hits) == 4
    assert _keyed(hits) == _keyed(want)


def test_twin_coverage_resolution_requires_the_right_owner(tmp_path):
    """A target resolves only through its last two segments — a moved
    original cannot hide behind a same-named function elsewhere."""
    src = tmp_path / "mod.py"
    src.write_text(
        "class Right:\n"
        "    def original(self):\n"
        "        pass\n"
        "# twin-of: mod.Wrong.original\n"
        "def masked(rows):\n"
        "    return rows\n")
    hits, want = _both(str(src), ["twin-coverage"], None)
    assert len(hits) == 1 and "does not resolve" in hits[0].message
    assert _keyed(hits) == _keyed(want)
    src.write_text(
        "class Right:\n"
        "    def original(self):\n"
        "        pass\n"
        "# twin-of: kubegpu_tpu_torch.mod.Right.original\n"
        "def masked(rows):\n"
        "    return rows\n")
    hits, want = _both(str(src), ["twin-coverage"], None)
    assert all("does not resolve" not in f.message for f in hits)
    assert _keyed(hits) == _keyed(want)


def test_twin_coverage_reads_only_the_port_differential_tests(tmp_path):
    """The exercised check reads test_torch_vectorized.py and
    test_torch_batch.py; a pair named only in the reference's
    test_vector*.py or test_vector_batch.py is unexercised."""
    src = tmp_path / "mod.py"
    src.write_text(
        "def original(rows):\n"
        "    return rows\n"
        "# twin-of: mod.original\n"
        "def masked(rows):\n"
        "    return rows\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    for name in ("test_vectorized.py", "test_vector_batch.py"):
        (tests / name).write_text("from mod import masked\nmasked([])\n")
    (tests / "test_torch_vectorized.py").write_text("x = 1\n")
    hits = run_analysis([str(src)], select=["twin-coverage"],
                        tests_dir=str(tests))
    assert len(hits) == 1 and "never appears" in hits[0].message
    for name in ("test_torch_vectorized.py", "test_torch_batch.py"):
        (tests / "test_torch_vectorized.py").write_text("x = 1\n")
        (tests / name).write_text("from mod import original\noriginal([])\n")
        assert run_analysis([str(src)], select=["twin-coverage"],
                            tests_dir=str(tests)) == [], name
        (tests / name).write_text("x = 1\n")


def test_hot_path_contract_binds_through_stacked_comments(tmp_path):
    """A `# twin-of:` (or any comment) stacked between `# hot-path:
    pure` and its def must not unbind the purity contract."""
    src = tmp_path / "mod.py"
    src.write_text(
        "import threading\n"
        "lock = threading.Lock()\n"
        "\n"
        "# hot-path: pure\n"
        "# twin-of: mod.scalar_original\n"
        "def kernel(x):\n"
        "    with lock:\n"
        "        return x\n"
        "\n"
        "def scalar_original(x):\n"
        "    return x\n")
    hits, want = _both(str(src), ["hot-path"], None)
    assert hits and "contracted" in hits[0].message
    assert _keyed(hits) == _keyed(want)


def test_twin_coverage_good_twin_is_clean(evidence):
    """Gate comments, one-hop builder resolution, and pairs whose names
    the port's differential tests reference all satisfy the contract."""
    assert _both(GOOD, ["twin-coverage"], evidence) == ([], [])


def test_mirror_maintenance_flags_all_path_shapes():
    hits, want = _both(BAD, ["mirror-maintenance"])
    msgs = " ".join(f.message for f in hits)
    assert "never mirrors them into the fleet columns" in msgs
    assert "a normal path" in msgs
    assert "exception edge" in msgs
    assert "writes the generation map directly" in msgs
    assert len(hits) == 4
    assert _keyed(hits) == _keyed(want)


def test_mirror_maintenance_good_twin_is_clean():
    """finally-cleanup, handler-cleanup, and the None-guarded update
    (credited at the guard) all discharge the mirror obligation."""
    assert _both(GOOD, ["mirror-maintenance"]) == ([], [])


def test_mirror_maintenance_credits_the_merged_set_node_test(tmp_path):
    """The port's ``SchedulerCache.set_node`` returns when nothing
    changed and updates the columns before any bump. The split form it
    had (``if changed:`` update, then ``if not changed: return``) reads
    as a bump with no update on a normal path."""
    body = ("class Cache:\n"
            "    def __init__(self):\n"
            "        self.columns = object()\n"
            "    def set_node(self, cached, changed):\n"
            "{test}"
            "        self._invalidate_locked(cached)\n")
    merged = ("        if not changed:\n"
              "            return\n"
              "        self.columns.set_node(cached)\n")
    split = ("        if changed:\n"
             "            self.columns.set_node(cached)\n"
             "        if not changed:\n"
             "            return\n")
    src = tmp_path / "cache.py"
    src.write_text(body.format(test=merged))
    assert run_analysis([str(src)], select=["mirror-maintenance"]) == []
    src.write_text(body.format(test=split))
    hits = run_analysis([str(src)], select=["mirror-maintenance"])
    assert len(hits) == 1 and "a normal path" in hits[0].message


def test_reason_parity_flags_drifted_literals():
    hits, want = _both(BAD, ["reason-parity"])
    msgs = " ".join(f.message for f in hits)
    assert "reason constant" in msgs               # drifted _REASON* const
    assert "Insufficient" in msgs                  # drifted f-string
    assert len(hits) == 2
    assert _keyed(hits) == _keyed(want)


def test_reason_parity_good_twin_is_clean():
    assert _both(GOOD, ["reason-parity"]) == ([], [])


def test_port_declares_every_reference_twin_in_the_port():
    """The port's vectorized.py declares each scalar original the JAX
    package's declares, by its own qualname, and none of the reference's."""
    import re

    def decls(path):
        with open(path, encoding="utf-8") as fh:
            return re.findall(r"#\s*twin-of:\s*([\w.]+)", fh.read())

    jax = decls(os.path.join(REPO, "kubegpu_tpu", "scheduler",
                             "vectorized.py"))
    port = decls(os.path.join(PKG, "scheduler", "vectorized.py"))
    assert port == [q.replace("kubegpu_tpu.", "kubegpu_tpu_torch.", 1)
                    for q in jax]
    assert all(q.startswith("kubegpu_tpu_torch.scheduler.") for q in port)


# ---- the interprocedural rules ---------------------------------------------

def test_charge_pairing_flags_both_leak_shapes():
    hits = findings_for(BAD, "charge-pairing")
    msgs = " ".join(f.message for f in hits)
    assert "not paired" in msgs          # the early-return leak
    assert "exception edge" in msgs      # the swallowing handler
    assert len(hits) == 2


def test_charge_pairing_follows_handoff_through_call_graph():
    """The good twin resolves one charge two helper hops away — the
    rule must treat the hand-off as resolution, not a leak."""
    assert findings_for(GOOD, "charge-pairing") == []


def test_transitive_locks_details():
    hits = findings_for(BAD, "transitive-locks")
    msgs = " ".join(f.message for f in hits)
    assert "_restock_locked" in msgs     # _locked contract violation
    assert "time.sleep" in msgs          # blocking one hop under a lock
    assert len(hits) == 2


def test_transitive_locks_accepts_locked_callers_of_locked_helpers(tmp_path):
    """A helper reached only from locked contexts may call `_locked`
    methods with an empty local held set — that is the exact blind spot
    the call-graph propagation exists to tolerate."""
    src = tmp_path / "mod.py"
    src.write_text(
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def outer(self):\n"
        "        with self._lock:\n"
        "            self._helper()\n"
        "    def _helper(self):\n"
        "        self._touch_locked()\n"
        "    def _touch_locked(self):\n"
        "        pass\n")
    assert run_analysis([str(src)], select=["transitive-locks"]) == []


# ---- the typestate rules on the dataflow engine ----------------------------

def test_lifecycle_flags_all_four_path_shapes():
    hits = findings_for(BAD, "resource-lifecycle")
    msgs = " ".join(f.message for f in hits)
    assert "socket is never closed" in msgs            # branch shape
    assert "file handle is never closed" in msgs       # handler shape
    assert "exception edge leaks the file" in msgs
    assert "never joined" in msgs                      # thread shape
    assert "never severed" in msgs                     # subscriber/loop shape
    assert len(hits) == 5


def test_lifecycle_good_twin_is_clean():
    """Daemon threads, hand-offs, with-blocks, finally cleanup, and the
    None-guarded remove all discharge the obligation."""
    assert findings_for(GOOD, "resource-lifecycle") == []


def test_wire_contract_flags_each_one_sided_surface():
    hits = findings_for(BAD, "wire-contract")
    msgs = " ".join(f.message for f in hits)
    assert "no reader dispatches" in msgs              # frame type BYE
    assert "no decoder handles it" in msgs             # _T_BYTES tag
    assert "serves no /frobs route" in msgs            # missing route
    assert "missing from dispatch site _serve_stream()" in msgs  # one-wire
    assert "no client caller" in msgs                  # unconsumed route
    # flow control: TooManyRequests -> 429 mapped on one wire only
    assert "TooManyRequests -> 429 is missing" in msgs
    # error-detail key the server writes but no client reads (the
    # retry-after bug class)
    assert "'retry_after_s' is written by _error_body()" in msgs
    # the proxy hop: /pods lands in neither forward table, and
    # _forward() drops the flow-control re-raise
    assert "a hole in the hop" in msgs
    assert "never re-raises TooManyRequests from 429" in msgs
    assert len(hits) == 9


def test_wire_contract_good_twin_is_clean():
    assert findings_for(GOOD, "wire-contract") == []




# ---- the dataflow engine itself ---------------------------------------------

def _cfg_of(code):
    import ast

    from kubegpu_tpu_torch.analysis import dataflow

    fn = ast.parse(code).body[0]
    return dataflow.build_cfg(fn), dataflow


def test_cfg_if_has_branch_and_merge():
    cfg, df = _cfg_of(
        "def f(a):\n"
        "    if a:\n"
        "        x = 1\n"
        "    y = 2\n")
    if_node = [n for n in cfg.nodes if n.kind == "stmt"
               and getattr(n.stmt, "lineno", 0) == 2][0]
    succs = cfg.successors(if_node)
    lines = sorted(getattr(n.stmt, "lineno", 0) for n in succs)
    assert lines == [3, 4]  # then-branch and fall-through (merge at y)
    y_node = [n for n in cfg.nodes if n.kind == "stmt"
              and getattr(n.stmt, "lineno", 0) == 4][0]
    assert len(cfg.preds[y_node.idx]) == 2  # the merge point


def test_cfg_loop_has_back_and_skip_edges():
    cfg, df = _cfg_of(
        "def f(items):\n"
        "    for i in items:\n"
        "        use(i)\n"
        "    done()\n")
    header = [n for n in cfg.nodes if n.kind == "stmt"
              and getattr(n.stmt, "lineno", 0) == 2][0]
    kinds = {e.kind for e in cfg.succs[header.idx]}
    assert df.SKIP in kinds          # zero-iteration edge
    assert any(e.kind == df.BACK for e in cfg.preds[header.idx])


def test_cfg_while_true_has_no_skip_edge():
    cfg, df = _cfg_of(
        "def f(q):\n"
        "    while True:\n"
        "        q.pop()\n")
    header = [n for n in cfg.nodes if n.kind == "stmt"
              and getattr(n.stmt, "lineno", 0) == 2][0]
    assert not any(e.kind == df.SKIP for e in cfg.succs[header.idx])


def test_cfg_try_statements_point_at_dispatch():
    cfg, df = _cfg_of(
        "def f(x):\n"
        "    try:\n"
        "        work(x)\n"
        "    except ValueError:\n"
        "        handle(x)\n")
    work = [n for n in cfg.nodes if n.kind == "stmt"
            and getattr(n.stmt, "lineno", 0) == 3][0]
    except_edges = [e for e in cfg.succs[work.idx] if e.kind == df.EXCEPT]
    assert len(except_edges) == 1
    dispatch = cfg.nodes[except_edges[0].dst]
    assert dispatch.kind == "dispatch"
    handlers = [n for n in cfg.successors(dispatch) if n.kind == "handler"]
    assert len(handlers) == 1


def _leak(code, resolving=("release",), acquire="acquire"):
    import ast

    from kubegpu_tpu_torch.analysis import dataflow as df

    fn = ast.parse(code).body[0]
    cfg = df.build_cfg(fn)

    def releases(node):
        calls = set()
        for sub in node.effect_asts():
            calls |= df.call_names(sub)
        return bool(calls & set(resolving))

    sites = df.stmt_sites(
        cfg, lambda n: any(acquire in df.call_names(a)
                           for a in n.effect_asts()))
    assert len(sites) == 1
    return df.may_leak(cfg, sites[0], releases)


def test_mayleak_joins_at_merge_points():
    """One branch releases, the other does not: the join must keep the
    leaking state alive (set-union lattice, not intersection)."""
    rep = _leak(
        "def f(a):\n"
        "    x = acquire()\n"
        "    if a:\n"
        "        release(x)\n"
        "    done()\n")
    assert rep.normal and not rep.handlers
    rep = _leak(
        "def f(a):\n"
        "    x = acquire()\n"
        "    if a:\n"
        "        release(x)\n"
        "    else:\n"
        "        release(x)\n"
        "    done()\n")
    assert rep.clean()  # both arms release: the join is clean


def test_mayleak_attributes_handler_edges():
    rep = _leak(
        "def f():\n"
        "    try:\n"
        "        x = acquire()\n"
        "        use(x)\n"
        "        release(x)\n"
        "    except Exception:\n"
        "        log()\n")
    assert not rep.normal
    assert [h.lineno for h in rep.handlers] == [6]


def test_mayleak_canonical_loop_cleanup_is_clean():
    rep = _leak(
        "def f(assumed):\n"
        "    acquire()\n"
        "    for p in assumed:\n"
        "        release(p)\n")
    assert rep.clean()


def test_mayleak_releasing_finally_covers_every_path():
    rep = _leak(
        "def f(a):\n"
        "    x = acquire()\n"
        "    try:\n"
        "        if a:\n"
        "            return\n"
        "        use(x)\n"
        "    finally:\n"
        "        release(x)\n")
    assert rep.clean()


def test_mayleak_else_block_is_not_covered_by_its_own_handlers():
    """Python's try/else runs only after the body completed without
    raising, and its exceptions are NOT caught by this try's handlers —
    a resource acquired and released entirely inside the else block
    must not be charged to those handlers."""
    rep = _leak(
        "def f(p):\n"
        "    try:\n"
        "        check()\n"
        "    except ValueError:\n"
        "        log()\n"
        "        return\n"
        "    else:\n"
        "        x = acquire()\n"
        "        use(x)\n"
        "        release(x)\n")
    assert rep.clean()


def test_charge_same_statement_resolve_still_owes_its_handlers(tmp_path):
    """`resolve_it(cache.assume_pod(p))` resolves on the normal path,
    but if the resolver raises AFTER the assume landed, a swallowing
    handler still leaks the charge — the contract the port must keep."""
    src = tmp_path / "mod.py"
    src.write_text(
        "class C:\n"
        "    def f(self, cache, p):\n"
        "        try:\n"
        "            self.resolve_it(cache.assume_pod(p))\n"
        "        except Exception:\n"
        "            self.log()\n"
        "    def resolve_it(self, x):\n"
        "        self.cache.confirm_pod(x)\n")
    hits = run_analysis([str(src)], select=["charge-pairing"])
    assert len(hits) == 1 and "exception edge" in hits[0].message


def test_callgraph_closure_follows_helpers():
    import ast

    from kubegpu_tpu_torch.analysis import dataflow as df

    tree = ast.parse(
        "def leaf():\n"
        "    release()\n"
        "def mid():\n"
        "    leaf()\n"
        "def top():\n"
        "    mid()\n"
        "def unrelated():\n"
        "    other()\n")
    closure = df.CallGraph([tree]).closure({"release"})
    assert {"release", "leaf", "mid", "top"} <= closure
    assert "unrelated" not in closure


# ---- the suppression audit --------------------------------------------------

def test_stale_suppression_is_a_finding_when_its_rule_runs():
    hits = run_analysis([BAD], select=["monotonic-time",
                                       "unused-suppression"],
                        tests_dir=TESTS_DIR)
    stale = [f for f in hits if f.rule == "unused-suppression"]
    msgs = " ".join(f.message for f in stale)
    assert "no longer suppresses anything" in msgs
    assert "unknown rule" in msgs  # the typo'd waiver


def test_suppression_for_unselected_rule_is_not_audited():
    """`--select` without the waived rule collects no evidence — the
    audit must stay silent rather than cry stale."""
    hits = run_analysis([BAD], select=["unused-suppression"],
                        tests_dir=TESTS_DIR)
    assert all("unknown rule" in f.message for f in hits)


def test_used_suppression_survives_the_audit():
    hits = run_analysis([GOOD], select=["monotonic-time",
                                        "unused-suppression"],
                        tests_dir=TESTS_DIR)
    assert hits == []


# ---- output formats ---------------------------------------------------------

def test_sarif_output_is_well_formed():
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--format", "sarif",
         os.path.join("tests", "fixtures", "analysis", "bad")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert set(RULES) <= rule_ids  # every registered rule
    result = run["results"][0]
    assert result["ruleId"] in rule_ids
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith(".py")
    assert loc["region"]["startLine"] >= 1


def test_format_json_lists_findings():
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--format", "json",
         os.path.join("tests", "fixtures", "analysis", "bad")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    findings = json.loads(proc.stdout)
    assert findings and {"rule", "path", "line", "message"} <= \
        set(findings[0])


def test_sarif_driver_advertises_every_rule_even_when_clean(evidence):
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--format", "sarif",
         "--tests-dir", evidence,
         os.path.join("tests", "fixtures", "analysis", "good")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    doc = json.loads(proc.stdout)
    rule_ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert set(RULES) <= rule_ids  # metadata survives a clean run


def test_rule_flag_selects_like_select():
    argv = [sys.executable, "-m", "kubegpu_tpu_torch.analysis",
            os.path.join("tests", "fixtures", "analysis", "bad")]
    a = subprocess.run(argv + ["--rule", "wire-contract",
                               "--rule", "resource-lifecycle"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    b = subprocess.run(argv + ["--select",
                               "wire-contract,resource-lifecycle"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert a.stdout == b.stdout
    assert a.returncode == b.returncode == 1


def test_stats_report_and_budget_gate(evidence):
    argv = [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--stats",
            "--tests-dir", evidence,
            os.path.join("tests", "fixtures", "analysis", "good")]
    ok = subprocess.run(argv + ["--budget-s", "300"], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "analysis stats:" in ok.stderr
    assert "resource-lifecycle" in ok.stderr  # per-rule timings listed
    blown = subprocess.run(argv + ["--budget-s", "0.000001"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
    assert blown.returncode == 3
    assert "over the" in blown.stderr


# ---- the lockset model (tests/test_locksets.py) -----------------------------


HEADER = """
import threading

class C:
    def __init__(self):
        self._lock = threading.{factory}()
        self.n = 0

    def start(self):
        threading.Thread(target=self._a, daemon=True).start()
        threading.Thread(target=self._b, daemon=True).start()

    def _b(self):
        with self._lock:
            self.n += 1
"""


def _racer(tmp_path, body, factory="Lock"):
    mod = tmp_path / "mod.py"
    mod.write_text(HEADER.format(factory=factory) + body)
    return run_analysis([str(mod)], select=["racer"])


# ---- lockset joins ----------------------------------------------------------


def test_reentrant_rlock_nesting_keeps_the_lock_held(tmp_path):
    hits = _racer(tmp_path, """
    def _a(self):
        with self._lock:
            self._inner()

    def _inner(self):
        with self._lock:
            self.n += 1
""", factory="RLock")
    assert hits == []


def test_nested_reentrant_with_does_not_release_the_outer_hold(tmp_path):
    # the inner `with self._lock` exits before the writes below it —
    # but the OUTER with still holds the lock, so nothing races
    hits = _racer(tmp_path, """
    def _a(self):
        with self._lock:
            with self._lock:
                self.n += 1
            self.n += 1
""", factory="RLock")
    assert hits == []


def test_conditional_acquire_does_not_survive_the_branch_join(tmp_path):
    hits = _racer(tmp_path, """
    def _a(self, fast=False):
        if fast:
            self._lock.acquire()
        self.n += 1
        if fast:
            self._lock.release()
""")
    assert len(hits) == 1 and "C.n" in hits[0].message
    # the finding anchors at the bare write and names the partial guard
    assert "self._lock" in hits[0].message


def test_unconditional_acquire_release_counts_as_held(tmp_path):
    hits = _racer(tmp_path, """
    def _a(self):
        self._lock.acquire()
        self.n += 1
        self._lock.release()
""")
    assert hits == []


def test_lock_handed_through_a_helper_guards_the_helper(tmp_path):
    hits = _racer(tmp_path, """
    def _a(self):
        with self._lock:
            self._bump()

    def _bump(self):
        self.n += 1
""")
    assert hits == []


def test_helper_with_one_unlocked_caller_loses_the_entry_lockset(tmp_path):
    hits = _racer(tmp_path, """
    def _a(self):
        with self._lock:
            self._bump()

    def _b(self):
        self._bump()

    def _bump(self):
        self.n += 1
""")
    # entry lockset = meet over call sites = {} -> the write races
    assert len(hits) == 1 and "C.n" in hits[0].message


def test_locked_suffix_contract_supplies_the_entry_lockset(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def start(self):
        threading.Thread(target=self._a, daemon=True).start()
        threading.Thread(target=self._b, daemon=True).start()

    def _a(self):
        with self._lock:
            self._bump_locked()

    def _b(self):
        with self._lock:
            self._bump_locked()

    def _bump_locked(self):
        self.n += 1
""")
    assert run_analysis([str(mod)], select=["racer"]) == []


def test_pool_spawn_is_self_racing(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class P:
    def __init__(self):
        self.c = 0

    def start(self):
        for _ in range(3):
            threading.Thread(target=self._w, daemon=True).start()

    def _w(self):
        self.c += 1
""")
    hits = run_analysis([str(mod)], select=["racer"])
    assert len(hits) == 1 and "(xN)" in hits[0].message


def test_single_spawn_of_one_target_is_not_a_race(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class P:
    def __init__(self):
        self.c = 0

    def start(self):
        threading.Thread(target=self._w, daemon=True).start()

    def _w(self):
        self.c += 1
""")
    assert run_analysis([str(mod)], select=["racer"]) == []


def test_module_global_written_from_two_roots_flags(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

total = 0

def start():
    threading.Thread(target=_a, daemon=True).start()
    threading.Thread(target=_b, daemon=True).start()

def _a():
    global total
    total += 1

def _b():
    global total
    total += 1
""")
    hits = run_analysis([str(mod)], select=["racer"])
    assert len(hits) == 1 and "total" in hits[0].message


def test_module_lock_guards_module_global(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

total = 0
_mu = threading.Lock()

def start():
    threading.Thread(target=_a, daemon=True).start()
    threading.Thread(target=_b, daemon=True).start()

def _a():
    global total
    with _mu:
        total += 1

def _b():
    global total
    with _mu:
        total += 1
""")
    assert run_analysis([str(mod)], select=["racer"]) == []


# ---- guard conventions ------------------------------------------------------


def test_single_writer_note_suppresses_and_binds_to_its_field_only(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class C:
    def __init__(self):
        # racer: single-writer -- handoff protocol
        self.a = 0
        self.b = 0

    def start(self):
        threading.Thread(target=self._x, daemon=True).start()
        threading.Thread(target=self._y, daemon=True).start()

    def _x(self):
        self.a += 1
        self.b += 1

    def _y(self):
        self.a += 1
        self.b += 1
""")
    hits = run_analysis([str(mod)], select=["racer"])
    assert len(hits) == 1 and "C.b" in hits[0].message


def test_guarded_by_unknown_lock_is_itself_a_finding(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class C:
    def __init__(self):
        # guarded-by: self._nope -- no such lock
        self.a = 0
""")
    hits = run_analysis([str(mod)], select=["racer"])
    assert len(hits) == 1 and "does not define" in hits[0].message


def test_guarded_by_monitor_class_form_is_validated(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class Monitor:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def push(self, x):
        with self._lock:
            self._items.append(x)

class Owner:
    def __init__(self):
        # guarded-by: Monitor._lock -- internally locked member
        self.q = Monitor()

    def start(self):
        threading.Thread(target=self._a, daemon=True).start()
        threading.Thread(target=self._b, daemon=True).start()

    def _a(self):
        self.q.pop()

    def _b(self):
        self.q.pop()
""")
    assert run_analysis([str(mod)], select=["racer"]) == []


# ---- thread-root discovery over the port's package -------------------------


@pytest.fixture(scope="module")
def package_model():
    return build_model(load_sources([PKG]))


def test_cmd_entry_points_are_roots(package_model):
    entry = {r.target for r in package_model.roots if r.kind == "entry"}
    for binary in ("scheduler_main", "apiserver_main", "proxy_main",
                   "node_agent", "simulate", "cri_hook"):
        assert any(binary in t for t in entry), \
            f"cmd/{binary}.py main not discovered as a root: {entry}"


def test_thread_and_pool_roots_are_discovered(package_model):
    targets = {r.target for r in package_model.roots}
    assert "BindWorkerPool._worker" in targets     # spawned in a loop
    assert "NodeLifecycle.start.loop" in targets   # nested thread body
    assert "Scheduler.run_forever" in targets      # Thread(target=self.…)
    assert package_model.root_multiplicity("BindWorkerPool._worker") == 2


def test_fit_pool_fanout_is_a_self_racing_root(package_model):
    # _parallel_map hands its lambda to the fit pool: the called function
    # must be a multiplicity-2 root
    targets = {r.target: r for r in package_model.roots}
    assert "GenericScheduler._fits_on_node" in targets
    assert targets["GenericScheduler._fits_on_node"].multiplicity == 2


def test_entry_locksets_carry_the_cache_lock(package_model):
    # SchedulerCache._charge_locked is only ever called with the cache
    # lock held
    entry = package_model.entry_locks.get("SchedulerCache._charge_locked")
    assert entry == frozenset({"self._lock"})


# ---- hot-path purity budget -------------------------------------------------


def test_hot_path_report_ranks_the_device_lock_first():
    reports: dict = {}
    findings = run_analysis([PKG], select=["hot-path"], reports=reports)
    assert findings == []  # no contracted function violates its purity
    report = reports["hot-path"]
    assert report["roots"] == ["find_nodes_that_fit", "prioritize_nodes",
                               "allocate_devices"]
    assert report["closure_size"] > 50
    assert report["blockers"], "the closure has known blockers today"
    top = report["blockers"][0]
    # ROADMAP item 1's diagnosis, reproduced statically: the device-
    # verdict lock inside _run_predicates is the #1 vectorization blocker
    assert "_run_predicates" in top["function"]
    assert any("_device_lock" in entry for entry in top["locks"])


def test_hot_path_contract_findings(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def find_nodes_that_fit(self):
        return self._score()

    # hot-path: pure
    def _score(self):
        with self._lock:
            return 1
""")
    hits = run_analysis([str(mod)], select=["hot-path"])
    assert len(hits) == 1 and "acquires self._lock" in hits[0].message


def test_hot_path_alloc_budget_override(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("""
def find_nodes_that_fit():
    return _score()

# hot-path: pure alloc=1
def _score():
    a = [1]
    b = {2}
    return a, b
""")
    hits = run_analysis([str(mod)], select=["hot-path"])
    assert len(hits) == 1 and "allocation budget of 1" in hits[0].message
    assert "2 allocation sites" in hits[0].message


def test_cli_report_flag_prints_the_ranked_inventory():
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--rule", "hot-path",
         "--report", PKG],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "hot-path report:" in proc.stdout
    assert "_run_predicates" in proc.stdout
