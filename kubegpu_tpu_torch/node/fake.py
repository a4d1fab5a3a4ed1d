"""Canned GPU inventories for tests and simulation.

The reference ships a fake backend returning captured inventories
(`nvidia_fake_plugin.go:15-39`); these are three NVIDIA H100 hosts:

- `hgx_h100_inventory`: an HGX H100 board, 8 SXM cards of 80 GiB, every
  pair joined by NVLink through the NVSwitches, cards 0-3 and 4-7 behind
  two CPU sockets;
- `pcie_h100_inventory`: 8 H100 PCIe cards with NVLink bridges on the
  pairs (0, 1), (2, 3), (4, 5), (6, 7), four cards a socket;
- `rig_inventory`: one H100 80GB HBM3 of 81559 MiB whose PCI bus id
  NVML withholds.

The link codes come from (NVML level, NVLink) pairs through
`node.nvml.link_code`, as the NVML backend builds them.
"""

from __future__ import annotations

import threading

from kubegpu_tpu_torch.node import nvml
from kubegpu_tpu_torch.node.backend import (CHIP_HEALTHY, GPUBackend,
                                            GPUInfo, GPUInventory)

H100_MEMORY = 80 * 2**30       # the SXM and the PCIe card alike
RIG_MEMORY = 81559 * 2**20

# PCI bus ids of an HGX H100 board's eight cards
_HGX_BUS = ("18", "2A", "3A", "5D", "9A", "AB", "BA", "DB")


def fake_uuid(host: int, index: int) -> str:
    """A well-formed, deterministic card UUID, unique per (host, index)."""
    return f"GPU-{host:08x}-{index:04x}-4000-8000-{host * 16 + index:012x}"


def _inventory(host: int, bus: list, level, nvlink) -> GPUInventory:
    """Eight cards of `H100_MEMORY`; ``level(i, j)`` and ``nvlink(i, j)``
    give each pair's NVML reads."""
    cards = [(i, fake_uuid(host, i), i, H100_MEMORY, bus[i]) for i in range(8)]
    pairs = {(i, j): (level(i, j), nvlink(i, j))
             for i in range(8) for j in range(i + 1, 8)}
    return nvml.inventory_from_reads(cards, pairs)


def _socket_level(i: int, j: int) -> int:
    """Cards 0-3 and 4-7 sit behind two sockets."""
    if i // 4 == j // 4:
        return nvml.NVML_TOPOLOGY_NODE
    return nvml.NVML_TOPOLOGY_SYSTEM


def hgx_h100_inventory(host: int = 0) -> GPUInventory:
    return _inventory(host, [f"00000000:{b}:00.0" for b in _HGX_BUS],
                      _socket_level, lambda i, j: True)


def pcie_h100_inventory(host: int = 0) -> GPUInventory:
    return _inventory(host,
                      [f"00000000:{0x17 + 0x10 * i:02X}:00.0" for i in range(8)],
                      _socket_level, lambda i, j: i // 2 == j // 2)


def rig_inventory(host: int = 0) -> GPUInventory:
    return GPUInventory(
        gpus=[GPUInfo(index=0, uuid=fake_uuid(host, 0), minor=0,
                      memory_bytes=RIG_MEMORY, pci_bus_id=None)],
        links=[[nvml.P2P_LINK_UNKNOWN]])


class FakeGPUBackend(GPUBackend):
    """Backend returning a canned inventory; can simulate discovery
    failure, per-card health degradation and flapping health probes."""

    def __init__(self, inventory: GPUInventory | None = None, fail: bool = False):
        self.inventory = inventory if inventory is not None else hgx_h100_inventory()
        self.fail = fail
        self.enumerate_calls = 0
        # Fault state is shared between the advertise loop (reads) and a
        # fault injector (writes): guard it so a mid-write read can't see
        # a half-applied fault.
        self._fault_lock = threading.Lock()
        # guarded-by: self._fault_lock
        self._health: dict = {}
        # guarded-by: self._fault_lock -- uuid -> (state, period); the
        # probe reports `state` on every `period`-th call, healthy otherwise
        self._flappers: dict = {}
        # guarded-by: self._fault_lock -- flapper phase counter
        self._probe_calls = 0

    def enumerate(self) -> GPUInventory:
        # racer: single-writer -- test-observability counter; the
        # advertise loop is the only live writer
        self.enumerate_calls += 1
        if self.fail:
            raise RuntimeError("fake NVML enumeration failure")
        return self.inventory

    def set_chip_health(self, uuid: str, state: str) -> None:
        """Inject a health state for one card (``healthy`` clears it)."""
        with self._fault_lock:
            if state == CHIP_HEALTHY:
                self._health.pop(uuid, None)
            else:
                self._health[uuid] = state

    def set_chip_flapper(self, uuid: str, state: str | None,
                         period: int = 2) -> None:
        """Make ``chip_health()`` report ``state`` for this card on every
        ``period``-th probe and healthy in between (the telemetry pattern
        the manager's debounce absorbs). ``state=None`` clears it."""
        with self._fault_lock:
            if state is None:
                self._flappers.pop(uuid, None)
            else:
                self._flappers[uuid] = (state, max(1, int(period)))

    def chip_health(self) -> dict:
        with self._fault_lock:
            out = dict(self._health)
            self._probe_calls += 1
            for uuid, (state, period) in self._flappers.items():
                if self._probe_calls % period == 0:
                    out[uuid] = state
                else:
                    out.pop(uuid, None)
            return out
