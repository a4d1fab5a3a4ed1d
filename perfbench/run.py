#!/usr/bin/env python3
"""Run one cell of the benchmark of ``kubegpu_tpu_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json`` (see
``perfbench/README.md``). The run needs as many CUDA cards as the cell
asks for and exits with code 2, printing no result, without them. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profile of the window.
The last line of standard output is the result object; the numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under the result's last key, ``check``.

``--control 1`` also reads the lower-precision control and the planted
faults that the limits are set against (``readings``); the benchmark's
own runs leave it off.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench")
# every compiler cache of the run at a fixed place inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "kubegpu_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: ``kubegpu_tpu_torch`` is not
    ``kubegpu_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import runner, spec

    cell = spec.load_cell(spec.load_bench(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"devices, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START, control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
