"""One run of one cell: drive it, read its metrics, judge it, and build
the result line."""

from __future__ import annotations

from pathlib import Path

from . import compare, flops, serve_cell, train_cell
from .spec import PERFBENCH, Cell, load_reader

CELL_KINDS = {"train": train_cell.run, "open_loop": serve_cell.run,
           "backlog": serve_cell.run}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False,
        base: Path = PERFBENCH) -> dict:
    """The contract's result object (and, with ``control``, the
    readings that limits are set from under ``readings``)."""
    import torch

    from .common import device_info

    drive = CELL_KINDS[cell.mix["kind"]]
    obs = drive(cell, seed, seconds, trace, device, t_start, control)
    ctx = {"cell": cell, "model": cell.model, "mix": cell.mix, "obs": obs,
           "trace": obs["trace"], "flops": flops}
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for entry in wanted:
        value = load_reader(entry["name"], base)(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    correct, check = compare.judge(obs["numbers"], cell.limits)
    device = torch.device(device)
    info = device_info(device, cell.chips)
    info["memory_peak_bytes"] = obs["memory_peak_bytes"]
    if trace and obs["trace"] is not None:
        info["busy_s"] = obs["trace"]["busy_s"]
        info["window_s"] = obs["trace"]["window_s"]
    result = {"correct": bool(correct and obs["failed"] == 0),
              "attempted": obs["attempted"], "failed": obs["failed"],
              "metrics": metrics, "device": info}
    if trace and obs["trace"] is not None:
        from .trace import breakdown
        result["breakdown"] = breakdown(obs["trace"])
    if obs.get("trace_seconds"):
        import sys
        print(f"perfbench: trace {obs['trace_seconds']}", file=sys.stderr)
    if control:
        # the control and each planted fault, judged by the cell's limits
        # as the program is: each has to come out as not correct
        readings = dict(obs["readings"])
        for side in ("control_numbers", "fault_half_batch"):
            if side in readings:
                ok, chk = compare.judge(readings[side], cell.limits)
                readings[side + "_judged"] = {"correct": ok, "check": chk}
        result["readings"] = readings
    result["check"] = check
    return result
