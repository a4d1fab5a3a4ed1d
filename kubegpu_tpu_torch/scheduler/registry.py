"""The device-scheduler registry (the port's copy of
``kubegpu_tpu/scheduler/registry.py``).

Holds an ordered list of device scheduler plugins and fans scheduling
operations out to them. Exactly one plugin — the *last* group-capable one —
triggers the shared group-allocator pass, so multiple device families can
coexist without double-running the allocator
(`device-scheduler/device/devicescheduler.go:23-36`).

The engine's compiled-in device is `GPUScheduler`
(`build_device_scheduler`); a directory of plugin files adds more
(`add_devices_from_plugins`, the reference's ``/schedulerplugins`` seam),
loaded by the port's own loader (`utils.load_plugins`).

No plugin here serves TPU chips. A pod whose requests name an
``alpha.tpu/`` knob other than the gang keys fits no node, with a reason
naming the knob, instead of fitting every node with nothing allocated.
"""

from __future__ import annotations

import logging

from kubegpu_tpu_torch.core import grammar
from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler
from kubegpu_tpu_torch.utils import load_plugins

log = logging.getLogger(__name__)

SCHEDULER_PLUGIN_SYMBOL = "create_device_scheduler_plugin"


def unserved_requests(pod_info) -> list:
    """The pod's ``alpha.tpu/`` device knobs, pod-level and per container
    (the gang keys excepted): requests no plugin of this registry
    translates."""
    keys = set(pod_info.requests)
    for _, cont, _ in pod_info.all_containers():
        keys.update(cont.requests)
    return sorted(k for k in keys
                  if k.startswith(grammar.TPU_REQUEST_PREFIX)
                  and k not in (grammar.RESOURCE_GANG,
                                grammar.RESOURCE_GANG_SIZE))


class DevicesScheduler:
    def __init__(self):
        self.devices: list = []
        self.run_group_scheduler: list = []

    def add_device(self, device) -> None:
        """Register a plugin; the last group-capable plugin owns the shared
        group-allocation pass (`devicescheduler.go:23-36`)."""
        # probe the interface BEFORE mutating: a malformed plugin must not
        # leave itself half-registered when the probe raises
        group_capable = bool(device.uses_group_scheduler())
        # plugin registration happens during single-threaded startup
        self.devices.append(device)  # racer: single-writer
        if group_capable:
            # racer: single-writer -- ditto
            self.run_group_scheduler = [False] * len(self.run_group_scheduler)
            self.run_group_scheduler.append(True)
        else:
            self.run_group_scheduler.append(False)

    def add_devices_from_plugins(self, directory: str) -> int:
        """Load scheduler plugins from a directory
        (`devicescheduler.go:38-64`). Returns how many were registered."""
        n = 0
        for plugin in load_plugins(directory, SCHEDULER_PLUGIN_SYMBOL):
            try:
                self.add_device(plugin)
                n += 1
            except Exception:
                # a factory returning a malformed object must not take the
                # scheduler down — same contract as a broken plugin file
                log.exception("scheduler plugin %r failed to register, "
                              "skipping", plugin)
        return n

    def add_node(self, node_name: str, node_info) -> None:
        for d in self.devices:
            d.add_node(node_name, node_info)

    def remove_node(self, node_name: str) -> None:
        for d in self.devices:
            d.remove_node(node_name)

    def pod_fits_resources(self, pod_info, node_info, fill_allocate_from):
        """Aggregate fit/score/reasons across plugins
        (`devicescheduler.go:88-100`)."""
        unserved = unserved_requests(pod_info)
        if unserved:
            return False, [f"no device plugin serves {k}"
                           for k in unserved], 0.0
        total_score = 0.0
        total_fit = True
        reasons: list = []
        for run_grp, d in zip(self.run_group_scheduler, self.devices):
            fit, rs, score = d.pod_fits_device(
                node_info, pod_info, fill_allocate_from, run_grp)
            total_score += score
            total_fit = total_fit and fit
            if rs:
                reasons.extend(rs)
        return total_fit, reasons, total_score

    def pod_allocate(self, pod_info, node_info) -> None:
        """Fill allocate_from on the chosen node; raises on failure
        (`devicescheduler.go:103-111`)."""
        unserved = unserved_requests(pod_info)
        if unserved:
            raise RuntimeError(f"no device plugin serves {unserved}")
        for run_grp, d in zip(self.run_group_scheduler, self.devices):
            d.pod_allocate(node_info, pod_info, run_grp)

    def take_pod_resources(self, pod_info, node_info) -> None:
        for run_grp, d in zip(self.run_group_scheduler, self.devices):
            d.take_pod_resources(node_info, pod_info, run_grp)

    def return_pod_resources(self, pod_info, node_info) -> None:
        for run_grp, d in zip(self.run_group_scheduler, self.devices):
            d.return_pod_resources(node_info, pod_info, run_grp)


def build_device_scheduler() -> DevicesScheduler:
    """The engine's registry with its compiled-in `GPUScheduler` (the
    counterpart of the JAX binary's compiled-in `TPUScheduler`); a plugin
    directory adds more through `add_devices_from_plugins`."""
    ds = DevicesScheduler()
    ds.add_device(GPUScheduler())
    return ds
