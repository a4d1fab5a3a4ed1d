"""Scheduler side: the GPU device-scheduler plugin, the device-scheduler
registry, and the scheduling engine (queue, cache, fit/score/bind, gangs).

The port's counterpart of ``kubegpu_tpu/scheduler/`` (reference layers
L3b/L4b/L5b: `plugins/gpuschedulerplugin`, `device-scheduler/device`,
`kube-scheduler/pkg`).
"""

from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler  # noqa: F401
from kubegpu_tpu_torch.scheduler.registry import DevicesScheduler  # noqa: F401
