"""Hand-written CUDA kernels for the workload layer's hot ops; each beside
its plain PyTorch version. Sources live in ``kubegpu_tpu_torch/csrc/``."""

from kubegpu_tpu_torch.workload.kernels.flash import flash_attention

__all__ = ["flash_attention"]
