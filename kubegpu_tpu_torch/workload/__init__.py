"""The workload layer of the port: the flagship transformer's forward and
backward passes and training step, on one device or over a dp x sp x tp
mesh, KV-cache decoding (greedy, sampled, speculative) and the
continuous-batching server, in PyTorch, with the attention as
hand-written CUDA kernels."""
