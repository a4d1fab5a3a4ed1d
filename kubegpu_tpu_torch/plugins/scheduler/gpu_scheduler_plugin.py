"""Scheduler plugin file: the GPU device scheduler.

Give this directory to the JAX package's scheduler
(``kgtpu-scheduler --scheduler-plugins-dir kubegpu_tpu_torch/plugins/scheduler``);
its loader imports the file by path and calls
`create_device_scheduler_plugin`.
"""

from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler


def create_device_scheduler_plugin() -> GPUScheduler:
    return GPUScheduler()
