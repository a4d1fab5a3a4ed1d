"""On the card: each cell's control (the reference in fp8, a step below the
bf16 the configurations state) and its planted faults come out as not
correct by the harness's own judgement (``compare.judge``) under the
cell's committed limits, and the program passes them, at the cell's own
size with a short window (3 s)."""

import pytest

from perfbench.harness import runner, spec

CELLS = [w["name"] for w in spec.load_bench()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(card, workload):
    cell = spec.load_cell(spec.load_bench(), workload)
    r = runner.run(cell, 2**31 + 9, 3.0, False, card, 0.0, control=True)
    assert r["correct"], r["check"]
    got = r["readings"]
    sides = ["control_numbers"]
    if cell.mix["kind"] == "train":
        sides.append("fault_half_batch")
    for side in sides:
        judged = got[side + "_judged"]
        assert not judged["correct"], (side, judged["check"])
