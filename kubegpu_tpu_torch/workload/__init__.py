"""The workload layer of the port: the flagship transformer's forward
pass, KV-cache decoding and the continuous-batching server, in PyTorch,
with the attention forward as a hand-written CUDA kernel."""
