"""Rule registry. Each rule object exposes ``name``, ``description`` and
``run(sources, ctx) -> Iterable[Finding]``."""

from __future__ import annotations

from kubegpu_tpu_torch.analysis.rules.hostsync import HostSync
from kubegpu_tpu_torch.analysis.rules.suppressions import UnusedSuppression

# the engine runs the audit last, whatever the order here
ALL_RULES = [HostSync(), UnusedSuppression()]

__all__ = ["ALL_RULES"]
