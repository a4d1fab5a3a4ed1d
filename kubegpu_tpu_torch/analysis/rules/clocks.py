"""monotonic-time: wall clocks don't age liveness state.

Heartbeat aging, backoff deadlines, TTLs, and lease expiry must use
``time.monotonic()`` (or ``time.perf_counter()`` for latencies): a
wall-clock step — NTP correction, manual reset, VM resume — would age
every node's heartbeat at once and mass-evict a healthy cluster, or
collapse every backoff in the system to zero.

Wall clocks are only legitimate when the timestamp crosses a process
boundary (the advertiser's heartbeat *stamp* is the protocol's wall-clock
half — the consumer side deliberately ages its own local observations
instead of comparing clocks) or is shown to humans. Those uses carry a
``# analysis: disable=monotonic-time`` suppression with a justification.

Scope: the control-plane tree. ``workload/`` (training/serving code) is
exempt — step timing there is cosmetic.

The port's copy of ``kubegpu_tpu/analysis/rules/clocks.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from kubegpu_tpu_torch.analysis.engine import Context, Finding, dotted_name

# (dotted suffix, replacement hint)
_WALL_CLOCKS = (
    ("time.time", "time.monotonic()"),
    ("datetime.now", "time.monotonic()"),
    ("datetime.utcnow", "time.monotonic()"),
    ("datetime.today", "time.monotonic()"),
    ("date.today", "time.monotonic()"),
)

_EXEMPT_TOP_DIRS = frozenset({"workload"})


class MonotonicTime:
    name = "monotonic-time"
    description = ("liveness/lifecycle/backoff logic must use monotonic "
                   "clocks, not time.time()/datetime.now()")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            if src.relparts and src.relparts[0] in _EXEMPT_TOP_DIRS:
                continue
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                dotted = dotted_name(node)
                if dotted is None:
                    continue
                for suffix, hint in _WALL_CLOCKS:
                    if dotted == suffix or dotted.endswith("." + suffix):
                        yield Finding(
                            self.name, src.path, node.lineno,
                            f"wall clock `{dotted}` in control-plane code; "
                            f"use {hint} — or suppress with a justification "
                            f"if this timestamp crosses a process boundary "
                            f"or is purely human-facing")
                        break
