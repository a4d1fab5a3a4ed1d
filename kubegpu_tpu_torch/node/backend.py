"""The GPU discovery backend seam.

The reference reaches its device layer through a tiny interface
(`NvidiaPlugin`, `nvidia_plugin.go:7-10`) so a fake can stand in for the
hardware in tests (`nvidia_fake_plugin.go:29-39`). Here a backend enumerates
the host's NVIDIA cards and the P2P link code of every pair; the
production implementation reads NVML (`node.nvml.NVMLBackend`), tests use
`node.fake.FakeGPUBackend`. The counterpart of
``kubegpu_tpu/node/backend.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GPUInfo:
    """One NVIDIA card as discovered on the host.

    Three numberings meet here: ``index`` is NVML's (PCI bus order),
    ``minor`` names the device node ``/dev/nvidia<minor>``, and the CUDA
    ordinal (not kept) follows fastest-first unless
    ``CUDA_DEVICE_ORDER=PCI_BUS_ID``. Only ``uuid`` means the same card
    everywhere, so it is the wire id and what ``CUDA_VISIBLE_DEVICES``
    names.
    """

    index: int
    uuid: str                 # "GPU-xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx"
    minor: int
    memory_bytes: int
    pci_bus_id: str | None = None   # None where NVML does not report it
    device_paths: list = field(default_factory=list)

    def __post_init__(self):
        if not self.device_paths:
            self.device_paths = [f"/dev/nvidia{self.minor}"]


@dataclass
class GPUInventory:
    """A host's cards, and ``links[i][j]``: the reference's P2P link code
    (`node.nvml.link_code`) between ``gpus[i]`` and ``gpus[j]``."""

    gpus: list                          # list[GPUInfo]
    links: list = field(default_factory=list)   # list[list[int]]

    def gpu(self, uuid: str) -> GPUInfo | None:
        for g in self.gpus:
            if g.uuid == uuid:
                return g
        return None


# The card health state a backend reports for a usable card. Any other
# state ("degraded", "failed", ...) withholds the card from the advertised
# allocatable inventory.
CHIP_HEALTHY = "healthy"
CHIP_DEGRADED = "degraded"
CHIP_FAILED = "failed"


class GPUBackend:
    """Abstract discovery backend (the fake seam)."""

    def enumerate(self) -> GPUInventory:
        raise NotImplementedError

    def chip_health(self) -> dict:
        """Per-card health, ``{uuid: state}``. Cards absent from the map
        are healthy; a non-``healthy`` state shrinks the advertised
        inventory. Backends without health telemetry inherit this
        all-healthy default."""
        return {}

    def link_health(self) -> dict:
        """Per-card dead-link bitmasks, ``{uuid: mask}``; cards absent
        from the map have every link up. Backends without link telemetry
        inherit this all-links-up default."""
        return {}
