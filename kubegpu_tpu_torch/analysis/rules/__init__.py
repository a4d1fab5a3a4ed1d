"""Rule registry. Each rule object exposes ``name``, ``description`` and
``run(sources, ctx) -> Iterable[Finding]``."""

from __future__ import annotations

from kubegpu_tpu_torch.analysis.rules.charges import ChargePairing
from kubegpu_tpu_torch.analysis.rules.clocks import MonotonicTime
from kubegpu_tpu_torch.analysis.rules.codecs import CodecPairing
from kubegpu_tpu_torch.analysis.rules.exceptions import NoSwallowedExceptions
from kubegpu_tpu_torch.analysis.rules.hostsync import HostSync
from kubegpu_tpu_torch.analysis.rules.lifecycle import ResourceLifecycle
from kubegpu_tpu_torch.analysis.rules.locks import (LockDiscipline,
                                                    NoBlockingUnderLock,
                                                    TransitiveLockDiscipline)
from kubegpu_tpu_torch.analysis.rules.metricsrule import MetricRegistration
from kubegpu_tpu_torch.analysis.rules.racer import HotPathPurity, Racer
from kubegpu_tpu_torch.analysis.rules.suppressions import UnusedSuppression
from kubegpu_tpu_torch.analysis.rules.twins import (MirrorMaintenance,
                                                    ReasonParity, TwinCoverage)
from kubegpu_tpu_torch.analysis.rules.wire import WireContract

ALL_RULES = [
    LockDiscipline(),
    NoBlockingUnderLock(),
    TransitiveLockDiscipline(),
    MonotonicTime(),
    CodecPairing(),
    NoSwallowedExceptions(),
    MetricRegistration(),
    ChargePairing(),
    ResourceLifecycle(),
    WireContract(),
    Racer(),
    HotPathPurity(),
    HostSync(),
    TwinCoverage(),
    MirrorMaintenance(),
    ReasonParity(),
    # always ordered last by the engine: it audits what the others used
    UnusedSuppression(),
]

__all__ = ["ALL_RULES"]
