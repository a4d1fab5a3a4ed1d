"""The port's ``dryrun_multichip`` (kubegpu_tpu_torch/entry.py): the
training legs of ``__graft_entry__.py:57-103, :145-169`` (dense dp x sp x
tp with the ring, the same under remat "dots", Ulysses, expert-parallel
MoE, a 2-stage pipeline) over 8 spawned gloo ranks, and the spawner's
refusals and fail-fast. The world here is the one ``dryrun_multichip``
spawns itself."""

import time

import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu_torch.entry import dryrun_multichip  # noqa: E402
from kubegpu_tpu_torch.workload import spmd  # noqa: E402
from tests.torch_worlds import run_world, single_rank_mesh  # noqa: E402


def test_dryrun_multichip_on_eight_gloo_ranks():
    dryrun_multichip(8, device="cpu")


def test_dryrun_refuses_what_it_cannot_run():
    """Too few GPUs raise (no GPU here: CUDA itself is refused); inside a
    process group of another size it raises instead of running."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError):
        dryrun_multichip(n, device="cuda")
    with single_rank_mesh():
        with pytest.raises(ValueError, match="process group of 1"):
            dryrun_multichip(2, device="cpu")
        dryrun_multichip(1, device="cpu")       # in this process


def test_a_dying_rank_fails_the_world_fast(tmp_path):
    """Rank 1 raises while rank 0 waits for it in a barrier: the spawner
    raises (whichever rank's error it sees first) and terminates the
    rest instead of hanging."""
    from torch.multiprocessing import ProcessRaisedException

    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException):
        run_world("tests.torch_worlds.job_rank1_dies", 2, str(tmp_path),
                  str(tmp_path / "out"))
    assert time.monotonic() - t0 < 60
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 GPUs"):
            spmd.spawn(print, 2, device="cuda")
