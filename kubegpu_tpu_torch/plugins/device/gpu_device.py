"""Device plugin file: NVIDIA cards for the node agent.

Give this directory to the JAX package's node agent
(``kgtpu-node-agent --device-plugins-dir kubegpu_tpu_torch/plugins/device``);
its loader imports the file by path and calls `create_device_plugin`.
"""

from kubegpu_tpu_torch.node.manager import GPUDeviceManager
from kubegpu_tpu_torch.node.nvml import NVMLBackend


def create_device_plugin() -> GPUDeviceManager:
    return GPUDeviceManager(NVMLBackend())
