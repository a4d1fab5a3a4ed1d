"""CLI: ``python -m kubegpu_tpu_torch.analysis [--rule NAME] [--report]
[PATHS]``.

Runs the port's static rules (``host-sync``, and the
``unused-suppression`` audit of its waivers) over PATHS, by default the
``kubegpu_tpu_torch`` package. ``--rule`` (repeatable) selects rules,
``--report`` prints the host-sync rule's ranked inventory after the
findings, ``--format json`` prints the findings as a JSON list. Exit
codes: 0 clean, 1 findings, 2 usage or parse error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kubegpu_tpu_torch.analysis.engine import (AnalysisError, all_rules,
                                               run_analysis)


def render(findings: list, fmt: str) -> str:
    if fmt == "json":
        return json.dumps([f.to_json() for f in findings], indent=2)
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


def main(argv: list | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubegpu_tpu_torch.analysis",
        description="The port's device-boundary static analysis.")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or package roots to analyse (default: "
                             "the kubegpu_tpu_torch package)")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="RULE", dest="rules",
                        help="run only this rule (repeatable)")
    parser.add_argument("--report", action="store_true",
                        help="print the host-sync rule's ranked inventory "
                             "after the findings")
    parser.add_argument("--format", default="text", dest="fmt",
                        choices=("text", "json"))
    parser.add_argument("--list-rules", action="store_true",
                        help="list the rules and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name:20s} {rule.description}")
        return 0
    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    reports: dict = {}
    try:
        findings = run_analysis(paths, select=args.rules, reports=reports)
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(render(findings, args.fmt))
    if args.report:
        from kubegpu_tpu_torch.analysis.rules import hostsync

        if "host-sync" in reports:
            print(hostsync.render_report(reports["host-sync"]))
        else:
            print("no side-reports (run with --rule host-sync)",
                  file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
