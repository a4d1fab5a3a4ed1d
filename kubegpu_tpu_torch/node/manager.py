"""GPUDeviceManager: the node-side device of NVIDIA cards.

The counterpart of ``kubegpu_tpu/node/manager.py``'s `TPUDeviceManager`
and of the reference's `NvidiaGPUManager` (`nvidia_gpu_manager.go:55-285`).
It discovers cards through a `GPUBackend`, advertises them as a
gpugrp1/gpugrp0/gpu hierarchy grouped by P2P link codes, and at
container-create time turns ``allocate_from`` into device nodes plus the
``CUDA_VISIBLE_DEVICES`` env. It works as a device of the JAX package's
``DevicesManager`` (``get_name``, ``start``, ``update_node_info``,
``chip_health``, ``allocate``), which loads it from
``plugins/device/gpu_device.py``, and of the port's own `DevicesManager`,
which the port's node agent builds.
"""

from __future__ import annotations

import logging
import os

from kubegpu_tpu_torch.core import grammar
from kubegpu_tpu_torch.core.types import add_group_resource
from kubegpu_tpu_torch.node import nvml
from kubegpu_tpu_torch.node.backend import CHIP_HEALTHY, GPUBackend, GPUInventory
from kubegpu_tpu_torch.utils import load_plugins

log = logging.getLogger(__name__)

# The factory a device plugin file exports (`devicemanager.go:46-77`).
DEVICE_PLUGIN_SYMBOL = "create_device_plugin"

# Device nodes every CUDA container needs beside its cards (the reference's
# Allocate adds them from nvidia-docker's volume/device list,
# `nvidia_gpu_manager.go:255-285`); the uvm-tools node only where the host
# has it.
CONTROL_DEVICES = ("/dev/nvidiactl", "/dev/nvidia-uvm")
OPTIONAL_CONTROL_DEVICES = ("/dev/nvidia-uvm-tools",)


class GPUDeviceManager:
    """Node-side `Device` implementation for NVIDIA cards.

    Grouping follows the reference's two passes over P2P link codes
    (`nvidia_gpu_manager.go:93-121`, `node.nvml.group_cards`): cards whose
    pairs are at codes 6, 5 or 4 (NVLink, one board, a PCIe switch tree)
    form a ``gpugrp0``; cards that reach each other at all form a
    ``gpugrp1``. Group indices follow the lowest PCI bus id, so they are
    stable across restarts.
    """

    def __init__(self, backend: GPUBackend, name: str = "nvidiagpu",
                 health_debounce: int = 1, device_exists=os.path.exists):
        self.backend = backend
        self.name = name
        self.inventory: GPUInventory | None = None
        self.groups: dict = {}  # uuid -> (gpugrp1, gpugrp0)
        self.health: dict = {}  # uuid -> state (absent = healthy)
        # A health TRANSITION lands only after the backend reports the same
        # new state `health_debounce` probes in a row (1 = at once).
        self.health_debounce = max(1, int(health_debounce))
        # racer: single-writer -- advertise-loop-owned debounce ledger:
        # uuid -> (candidate state, consecutive observations)
        self._health_streak: dict = {}
        self.device_exists = device_exists

    def get_name(self) -> str:
        return self.name

    def start(self) -> None:
        """Initial discovery; failure leaves zero cards advertised
        (`nvidia_gpu_manager.go:198-201, 205-210`)."""
        try:
            self._refresh()
        except Exception:
            self.inventory = None  # racer: single-writer -- see _refresh

    def _refresh(self) -> None:
        # discovery state is owned by the node agent's advertise loop
        inv = self.backend.enumerate()
        order = [nvml.card_order(g) for g in inv.gpus]
        self.groups = {g.uuid: grp for g, grp in zip(  # racer: single-writer
            inv.gpus, nvml.group_cards(inv.links, order))}
        self.inventory = inv     # racer: single-writer
        try:
            observed = dict(self.backend.chip_health() or {})
        except Exception:
            # health telemetry is advisory: a broken probe must not take
            # the whole inventory down with it
            observed = {}
        self.health = self._debounced_health(observed)  # racer: single-writer

    def _debounced_health(self, observed: dict) -> dict:
        """Fold one raw health observation into the landed health map:
        each card's transition, degrading or healing, needs
        ``health_debounce`` consecutive identical observations."""
        if self.health_debounce <= 1:
            self._health_streak = {}
            return observed
        landed = dict(self.health)
        for uuid in set(observed) | set(landed) | set(self._health_streak):
            candidate = observed.get(uuid, CHIP_HEALTHY)
            current = landed.get(uuid, CHIP_HEALTHY)
            if candidate == current:
                self._health_streak.pop(uuid, None)
                continue
            state, streak = self._health_streak.get(uuid, (None, 0))
            streak = streak + 1 if state == candidate else 1
            if streak >= self.health_debounce:
                self._health_streak.pop(uuid, None)
                if candidate == CHIP_HEALTHY:
                    landed.pop(uuid, None)
                else:
                    landed[uuid] = candidate
            else:
                self._health_streak[uuid] = (candidate, streak)
        return landed

    def chip_health(self) -> dict:
        """Last-known per-card health, for the advertiser's annotation."""
        return dict(self.health)

    def gpu_group_path(self, gpu) -> str:
        """``gpugrp1/<i>/gpugrp0/<j>/gpu/<uuid>`` for one card."""
        g1, g0 = self.groups[gpu.uuid]
        return (f"{grammar.GPU_GRP1}/{g1}/{grammar.GPU_GRP0}/{g0}/"
                f"{grammar.GPU_LEAF}/{gpu.uuid}")

    def update_node_info(self, node_info) -> None:
        """Advertise the cards into a NodeInfo (`nvidia_gpu_manager.go:204-223`).
        Discovery failure advertises zero cards rather than stale state. A
        card the backend reports non-healthy stays in ``capacity`` but is
        withheld from ``allocatable``: the node shrinks, it does not
        vanish."""
        try:
            self._refresh()
        except Exception:
            node_info.capacity[grammar.RESOURCE_NUM_GPU] = 0
            node_info.allocatable[grammar.RESOURCE_NUM_GPU] = 0
            return
        gpus = self.inventory.gpus
        healthy = {g.uuid for g in gpus
                   if self.health.get(g.uuid, CHIP_HEALTHY) == CHIP_HEALTHY}
        node_info.capacity[grammar.RESOURCE_NUM_GPU] = len(gpus)
        node_info.allocatable[grammar.RESOURCE_NUM_GPU] = len(healthy)
        for gpu in gpus:
            base = self.gpu_group_path(gpu)
            res_lists = (node_info.capacity, node_info.allocatable) \
                if gpu.uuid in healthy else (node_info.capacity,)
            for res_list in res_lists:
                add_group_resource(res_list, f"{base}/{grammar.CARDS_SUFFIX}", 1)
                add_group_resource(res_list, f"{base}/{grammar.MEMORY_SUFFIX}",
                                   gpu.memory_bytes)

    def allocate(self, pod, container) -> tuple[list, list, dict]:
        """Turn ``allocate_from`` into (volumes, device paths, env)
        (`nvidia_gpu_manager.go:226-285`):

        - devices: ``/dev/nvidia<minor>`` of each card in NVML index order,
          then the control nodes (`CONTROL_DEVICES`, and
          `OPTIONAL_CONTROL_DEVICES` where present);
        - ``CUDA_VISIBLE_DEVICES`` and ``NVIDIA_VISIBLE_DEVICES``: the
          cards' UUIDs in the same order. UUIDs, because the CUDA ordinal,
          NVML's index and the minor number are three different numberings.

        No volumes: the container runtime's NVIDIA hook mounts NVIDIA's
        user-space libraries. Paths that are not card paths are skipped; a UUID that
        is not on this host raises.
        """
        if not container.allocate_from:
            return [], [], {}
        if self.inventory is None:
            raise RuntimeError("GPU inventory not discovered")
        gpus = []
        for path in container.allocate_from.values():
            uuid = grammar.gpu_id_from_path(path)
            if uuid is None:
                continue
            gpu = self.inventory.gpu(uuid)
            if gpu is None:
                raise RuntimeError(
                    f"pod {pod.name}: allocated GPU {uuid} not on this host")
            gpus.append(gpu)
        if not gpus:
            return [], [], {}
        gpus.sort(key=lambda g: g.index)
        devices = [p for g in gpus for p in g.device_paths]
        devices += list(CONTROL_DEVICES)
        devices += [p for p in OPTIONAL_CONTROL_DEVICES if self.device_exists(p)]
        visible = ",".join(g.uuid for g in gpus)
        env = {"CUDA_VISIBLE_DEVICES": visible, "NVIDIA_VISIBLE_DEVICES": visible}
        return [], devices, env


class DevicesManager:
    """Registry that fans out to the node's devices
    (`crishim/pkg/device/devicemanager.go:13-122`; the port's copy of
    ``kubegpu_tpu/node/manager.py``'s). A device that fails to start is
    marked non-operational and skipped: the node keeps advertising what
    still works."""

    def __init__(self):
        self.devices: list = []
        self.operational: dict = {}

    def add_device(self, device) -> None:
        name = device.get_name()  # probe before mutating
        self.devices.append(device)  # racer: single-writer
        self.operational[name] = False  # racer: single-writer

    def add_devices_from_plugins(self, directory: str) -> int:
        """Register the devices of a plugin directory (the agent's
        ``--device-plugins-dir``); returns how many registered."""
        n = 0
        for plugin in load_plugins(directory, DEVICE_PLUGIN_SYMBOL):
            try:
                self.add_device(plugin)
                n += 1
            except Exception:
                log.exception("device plugin %r failed to register, "
                              "skipping", plugin)
        return n

    def start(self) -> None:
        for dev in self.devices:
            try:
                dev.start()
                self.operational[dev.get_name()] = True
            except Exception:
                log.exception("device %s failed to start", dev.get_name())
                self.operational[dev.get_name()] = False

    def _live(self) -> list:
        return [d for d in self.devices if self.operational.get(d.get_name())]

    def update_node_info(self, node_info) -> None:
        for dev in self._live():
            dev.update_node_info(node_info)

    def _merged(self, probe_name: str) -> dict:
        """One probe merged over the operational devices; a device whose
        probe fails reports nothing (healthy, every link up)."""
        out: dict = {}
        for dev in self._live():
            probe = getattr(dev, probe_name, None)
            if probe is None:
                continue
            try:
                out.update(probe() or {})
            except Exception:
                log.warning("%s probe failed for device %s", probe_name,
                            dev.get_name(), exc_info=True)
        return out

    def chip_health(self) -> dict:
        """Per-device health merged across operational devices (card
        UUIDs are unique)."""
        return self._merged("chip_health")

    def link_health(self) -> dict:
        """Per-device dead-link masks merged across operational devices."""
        return self._merged("link_health")

    def allocate_devices(self, pod, container) -> tuple[list, list, dict]:
        """Every operational device's (volumes, device paths, env) for one
        container, concatenated (`devicemanager.go:104-122`)."""
        volumes: list = []
        devices: list = []
        env: dict = {}
        for dev in self._live():
            v, d, e = dev.allocate(pod, container)
            volumes.extend(v)
            devices.extend(d)
            env.update(e)
        return volumes, devices, env
