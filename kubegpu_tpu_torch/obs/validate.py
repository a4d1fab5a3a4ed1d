"""Trace-file well-formedness checker (CI gate for ``--trace-out``).

``python -m kubegpu_tpu_torch.obs.validate trace.json`` exits non-zero when the
file is not a loadable Chrome trace, contains no spans, has orphan span
ids (a parent_id that resolves to no span in the file), or violates
start-ordering (a child starting measurably before its parent — spans
may END after their parent, that is how async binds work, but they can
never begin first)."""

from __future__ import annotations

import json
import sys
from typing import List

# Wall-clock slack between processes on one machine (scheduling jitter
# between taking the timestamp and doing the work).
START_SLACK_S = 0.050


def validate_chrome_trace(doc: dict) -> List[str]:
    """Problems found in a Chrome trace document; empty means valid."""
    problems: list = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["no traceEvents array"]
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return ["trace contains no spans"]
    by_id: dict = {}
    for e in spans:
        args = e.get("args") or {}
        span_id = args.get("span_id")
        if not span_id:
            problems.append(f"span {e.get('name')!r} has no span_id")
            continue
        if span_id in by_id:
            problems.append(f"duplicate span_id {span_id}")
        by_id[span_id] = e
    for e in spans:
        args = e.get("args") or {}
        parent_id = args.get("parent_id")
        if not parent_id:
            continue
        parent = by_id.get(parent_id)
        if parent is None:
            problems.append(
                f"orphan span {args.get('span_id')} "
                f"({e.get('name')!r}, pod {args.get('pod')!r}): parent "
                f"{parent_id} not in file")
            continue
        if e.get("ts", 0.0) < parent.get("ts", 0.0) - START_SLACK_S * 1e6:
            problems.append(
                f"span {args.get('span_id')} ({e.get('name')!r}) starts "
                f"before its parent {parent_id} "
                f"({parent.get('name')!r})")
    return problems


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m kubegpu_tpu_torch.obs.validate <trace.json>")
        return 2
    try:
        with open(argv[0]) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"{argv[0]}: unreadable trace: {e}")
        return 1
    problems = validate_chrome_trace(doc)
    spans = sum(1 for e in doc.get("traceEvents", [])
                if isinstance(e, dict) and e.get("ph") == "X")
    if problems:
        for p in problems[:50]:
            print(f"{argv[0]}: {p}")
        print(f"{argv[0]}: INVALID ({len(problems)} problem(s), "
              f"{spans} spans)")
        return 1
    procs = {e["args"]["name"] for e in doc.get("traceEvents", [])
             if isinstance(e, dict) and e.get("ph") == "M"
             and e.get("name") == "process_name"}
    print(f"{argv[0]}: ok ({spans} spans across "
          f"{len(procs)} process(es): {sorted(procs)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
