"""The benchmark harness of ``kubegpu_tpu_torch``: the yardstick.

Everything here is the benchmark's own and imports nothing of the JAX
package. The program under test (``kubegpu_tpu_torch``) is imported only
inside the cell runners (`train_cell`, `serve_cell`), never by
`reference`, `flops`, `traffic`, `weights` or `trace`.
"""
