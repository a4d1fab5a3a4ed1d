"""CLI: ``python -m kubegpu_tpu_torch.analysis [paths...]``.

Runs the port's static rules over PATHS, by default the
``kubegpu_tpu_torch`` package: the control plane's (lock-discipline,
no-blocking-under-lock, transitive-locks, monotonic-time, codec-pairing,
no-swallowed-exceptions, metric-registration, charge-pairing,
resource-lifecycle, wire-contract, racer, hot-path), the device
boundary's host-sync, the scheduler's twin rules (twin-coverage,
mirror-maintenance, reason-parity), and the unused-suppression audit of
every waiver.

Exit codes: 0 clean, 1 findings, 2 usage/parse error, 3 wall-clock
budget exceeded (``--budget-s``).

``--format`` selects the output: ``text`` (default, human), ``json``
(machine-readable list), or ``sarif`` (SARIF 2.1.0, whose driver
metadata carries every registered rule, not just the ones that fired).
``--select A,B`` and ``--rule NAME`` (repeatable) select rules,
``--tests-dir`` names the tests codec-pairing and twin-coverage read
(default: the repo's ``tests/``), ``--stats`` prints the per-rule timing
report, ``--budget-s`` turns the total into a gate, and ``--report``
renders the hot-path and host-sync inventories after the findings.

``--mutate`` switches to the dynamic half (``analysis/mutate.py``): the
AST mutation sweep over the vector/scalar twin closure, exit 1 on
unwaived survivors. ``--mutate-smoke`` runs the pinned subset,
``--mutate-ids`` an explicit one, ``--list-mutants`` enumerates the
deterministic mutant ids, and ``--budget-s`` here stops the sweep
cleanly (remaining mutants reported ``skipped``, exit unaffected).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kubegpu_tpu_torch.analysis.engine import (AnalysisError, all_rules,
                                               run_analysis)

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: list) -> dict:
    """Findings as one SARIF 2.1.0 run. Paths are emitted as-is
    (repo-relative when invoked from the repo root, which is what the
    upload action expects). The driver advertises EVERY registered
    rule's metadata — a clean run still documents what was checked."""
    descriptions = {r.name: r.description for r in all_rules()}
    rules = sorted(set(descriptions) | {f.rule for f in findings})
    by_rule = {name: i for i, name in enumerate(rules)}
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "kubegpu-tpu-torch-analysis",
                "informationUri":
                    "https://example.invalid/kubegpu-tpu#analysis",
                "rules": [{
                    "id": name,
                    "shortDescription":
                        {"text": descriptions.get(name, name)},
                } for name in rules],
            }},
            "results": [{
                "ruleId": f.rule,
                "ruleIndex": by_rule[f.rule],
                "level": "error",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace(os.sep, "/"),
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": f.line},
                    },
                }],
            } for f in findings],
        }],
    }


def render_stats(stats: dict) -> str:
    """The ``--stats`` timing report (stderr: never mixes into parseable
    stdout output)."""
    lines = [f"analysis stats: {stats.get('files', 0)} file(s), "
             f"parse {stats.get('parse_s', 0.0) * 1e3:.0f} ms, "
             f"total {stats.get('total_s', 0.0) * 1e3:.0f} ms"]
    rules = stats.get("rules", {})
    for name, seconds in sorted(rules.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:26s} {seconds * 1e3:8.1f} ms")
    return "\n".join(lines)


def render(findings: list, fmt: str) -> str:
    if fmt == "json":
        return json.dumps([f.to_json() for f in findings], indent=2)
    if fmt == "sarif":
        return json.dumps(to_sarif(findings), indent=2)
    lines = [f.render() for f in findings]
    if findings:
        by_rule: dict = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        summary = ", ".join(f"{n} {r}" for r, n in sorted(by_rule.items()))
        lines.append(f"\n{len(findings)} finding(s): {summary}")
    else:
        lines.append("clean: no findings")
    return "\n".join(lines)


def _mutation_main(args: "argparse.Namespace") -> int:
    """The ``--mutate`` / ``--list-mutants`` half of the CLI: the
    dynamic twin of the static rules. Exit 0 when every run mutant is
    killed or carries a justified waiver; 1 on unwaived survivors."""
    from kubegpu_tpu_torch.analysis import mutate

    fmt = args.fmt
    try:
        if args.list_mutants:
            refs = mutate.enumerate_mutants()
            if fmt == "json":
                report = json.dumps([r.describe() for r in refs], indent=2)
            else:
                report = mutate.render_mutant_list(refs)
            if args.output:
                with open(args.output, "w", encoding="utf-8") as fh:
                    fh.write(report + "\n")
            else:
                print(report)
            return 0
        ids = None
        if args.mutate_ids:
            ids = [i.strip() for i in args.mutate_ids.split(",")
                   if i.strip()]
        elif args.mutate_smoke:
            ids = list(mutate.PINNED_SMOKE)
        report_dict = mutate.run_sweep(
            ids=ids, budget_s=args.budget_s,
            log=lambda line: print(line, file=sys.stderr))
    except mutate.MutationError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = json.dumps(report_dict, indent=2) if fmt == "json" \
        else mutate.render_report(report_dict)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(report + "\n")
        print(mutate.render_report(report_dict).splitlines()[0])
    else:
        print(report)
    return 1 if report_dict["survived"] else 0


def main(argv: list | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubegpu_tpu_torch.analysis",
        description="The port's static analysis.")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or package roots to analyze "
                             "(default: the kubegpu_tpu_torch package)")
    parser.add_argument("--select", default=None, metavar="RULE[,RULE...]",
                        help="run only these rules")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="RULE", dest="rules",
                        help="run only this rule (repeatable; combines "
                             "with --select)")
    parser.add_argument("--stats", action="store_true",
                        help="print the per-rule timing report")
    parser.add_argument("--report", action="store_true",
                        help="print rule side-reports (the hot-path "
                             "rule's ranked vectorization-blockers "
                             "inventory) after the findings")
    parser.add_argument("--budget-s", type=float, default=None,
                        metavar="SECONDS",
                        help="exit 3 when the full analysis exceeds this "
                             "wall-clock budget (the CI perf gate)")
    parser.add_argument("--tests-dir", default=None,
                        help="tests directory for round-trip-test checks "
                             "(default: the repo's tests/ when it exists)")
    parser.add_argument("--format", default="text", dest="fmt",
                        choices=("text", "json", "sarif"),
                        help="output format (sarif for CI annotation "
                             "uploads)")
    parser.add_argument("--output", default=None, metavar="FILE",
                        help="write the report to FILE instead of stdout")
    parser.add_argument("--list-rules", action="store_true",
                        help="list rules and exit")
    parser.add_argument("--mutate", action="store_true",
                        help="run the mutation sweep over the targeted "
                             "vector/scalar closure instead of the "
                             "static rules (exit 1 on unwaived "
                             "survivors)")
    parser.add_argument("--mutate-ids", default=None, metavar="ID[,ID...]",
                        help="restrict --mutate to these mutant ids")
    parser.add_argument("--mutate-smoke", action="store_true",
                        help="run --mutate on the pinned subset "
                             "(analysis.mutate.PINNED_SMOKE)")
    parser.add_argument("--list-mutants", action="store_true",
                        help="enumerate the mutation sweep's mutants "
                             "(deterministic content-addressed ids) and "
                             "exit without executing anything")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name:26s} {rule.description}")
        return 0

    if args.mutate or args.mutate_smoke or args.list_mutants or \
            args.mutate_ids:
        return _mutation_main(args)

    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = args.paths or [package]
    tests_dir = args.tests_dir
    if tests_dir is None:
        repo_tests = os.path.join(os.path.dirname(package), "tests")
        if os.path.isdir(repo_tests):
            tests_dir = repo_tests
    select = [r.strip() for r in args.select.split(",")] \
        if args.select else []
    if args.rules:
        select.extend(r.strip() for r in args.rules)

    stats: dict = {}
    reports: dict = {}
    try:
        findings = run_analysis(paths, select=select or None,
                                tests_dir=tests_dir, stats=stats,
                                reports=reports)
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    report = render(findings, args.fmt)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(report + "\n")
    else:
        print(report)
    if args.report:
        from kubegpu_tpu_torch.analysis.rules import hostsync, racer

        rendered = False
        if "hot-path" in reports:
            print(racer.render_report(reports["hot-path"]))
            rendered = True
        if "host-sync" in reports:
            print(hostsync.render_report(reports["host-sync"]))
            rendered = True
        if not rendered:
            print("no side-reports (run with --rule hot-path or "
                  "--rule host-sync)", file=sys.stderr)
    if args.stats:
        print(render_stats(stats), file=sys.stderr)
    if args.budget_s is not None and stats["total_s"] > args.budget_s:
        print(f"error: analysis took {stats['total_s']:.2f}s, over the "
              f"{args.budget_s:.2f}s budget", file=sys.stderr)
        return 3
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
