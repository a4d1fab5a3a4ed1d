"""PyTorch and CUDA port of the kubegpu_tpu workload layer, for NVIDIA Hopper.

The JAX package ``kubegpu_tpu`` stays the reference; this package mirrors
its paths (``workload/model.py``, ``workload/decode.py``,
``workload/speculative.py``, ``workload/serve.py``, ``workload/train.py``,
``workload/data.py``, ``workload/spmd.py``, ``workload/ring.py``,
``workload/ulysses.py``, ``workload/pipeline.py``,
``workload/kernels/flash.py``,
``cmd/serve_demo.py``, ``cmd/train_demo.py``) so each module has an
obvious counterpart. It
imports torch and numpy, never JAX and nothing of ``kubegpu_tpu``: what it
needs from there it keeps as its own copy (``metrics.py``,
``workload/presets.py``, ``workload/data.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no CPU request they raise (``_device.resolve_device``).
The TPU's Pallas kernels become CUDA C++ kernels under ``csrc/``, built
with nvcc at first use (``workload/kernels/_build.py``); the native token
loader is built from ``native/dataloader.cpp`` with g++ at first use
(``native.py``). Sampling draws from the port's own counter-based keys
(``workload/keys.py``).
"""
