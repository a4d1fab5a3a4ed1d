"""The trace reduction on a hand-made trace."""

import pytest

from perfbench.harness.trace import Ev, breakdown, reduce_events

MS = 1_000_000


def test_busy_idle_and_casts():
    ev = [
        Ev("perfbench.window", False, 0, 100 * MS, thread=1),
        Ev("perfbench.serve_step", False, 5 * MS, 60 * MS, thread=1),
        Ev("aten::_to_copy", False, 10 * MS, 12 * MS, thread=1),
        Ev("cudaLaunchKernel", False, 11 * MS, 11 * MS + 10, thread=1,
           corr=7),
        Ev("aten::mm", False, 20 * MS, 22 * MS, thread=1),
        Ev("cudaLaunchKernel", False, 21 * MS, 21 * MS + 10, thread=1,
           corr=8),
        Ev("aten::item", False, 61 * MS, 95 * MS, thread=1),
        # device: a cast kernel 20-40 ms, a gemm 30-50 (overlapping),
        # one before the window
        Ev("direct_copy_kernel", True, 20 * MS, 40 * MS, corr=7),
        Ev("gemm", True, 30 * MS, 50 * MS, corr=8),
        Ev("early", True, -10 * MS, -5 * MS),
    ]
    s = reduce_events(ev)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.03)
    assert s["device_total_s"] == pytest.approx(0.04)
    assert s["cast_s"] == pytest.approx(0.02)
    assert s["device_calls"] == {"direct_copy_kernel": 1, "gemm": 1}
    # gaps 0-20 (middle 10: the cast op under the step), 50-100 (middle
    # 75: item, outside any step span)
    assert s["idle"] == pytest.approx({
        "perfbench.serve_step: aten::_to_copy": 0.02,
        "outside spans: aten::item": 0.05})
    b = breakdown(s)
    assert b["device_ops"][0] == ["direct_copy_kernel", pytest.approx(0.02)]
    assert b["idle_gaps"][0][0] == "outside spans: aten::item"


def test_no_window_or_no_device_gives_nothing():
    assert reduce_events([Ev("x", True, 0, 5)]) is None
    assert reduce_events([Ev("perfbench.window", False, 0, 5)]) is None
