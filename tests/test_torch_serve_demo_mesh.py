"""``serve_demo`` as a gang workload (kubegpu_tpu_torch/cmd/serve_demo.py):
under ``torchrun --nproc-per-node 2 --device cpu`` every rank joins one
gloo group and serves over a (1, 1, 2) mesh, and rank 0 prints the
single-process run's first output and token count, greedy, with the
speculative server, and from a checkpoint train_demo wrote (every rank
restoring its shards). float32, so the sharded sums give the same
tokens."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu_torch.cmd import serve_demo, train_demo  # noqa: E402
from tests.torch_worlds import WORLD_TIMEOUT_S  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = ["--vocab", "64", "--d-model", "32", "--n-layers", "2",
        "--seq", "64"]
ARGS = ["--device", "cpu", "--requests", "4", "--slots", "2",
        "--max-new", "6", "--dtype", "float32", *DIMS]


def _torchrun(argv: list) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "kubegpu_tpu_torch.cmd.serve_demo",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout          # rank 0 prints, once
    return json.loads(lines[0])


def _one_process(argv: list, capsys) -> dict:
    assert serve_demo.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["serve", "spec-server", "checkpoint"])
def test_serve_demo_under_torchrun_equals_one_process(capsys, tmp_path,
                                                      mode):
    argv = list(ARGS)
    if mode == "spec-server":
        argv += ["--spec-server", "--lookahead", "3"]
    if mode == "checkpoint":
        # a full fine-tune's checkpoint of the same dimensions, float32
        assert train_demo.main(
            ["--device", "cpu", "--steps", "2", "--batch", "2",
             "--n-heads", "4", "--dtype", "float32", *DIMS,
             "--checkpoint-dir", str(tmp_path),
             "--checkpoint-every", "2"]) == 0
        capsys.readouterr()
        argv += ["--checkpoint-dir", str(tmp_path)]
    gang = _torchrun(argv)
    one = _one_process(argv, capsys)
    assert gang["processes"] == 2 and "processes" not in one
    assert gang["mode"] == one["mode"]
    assert gang["tokens"] == one["tokens"] == 4 * 6
    assert gang["first_output"] == one["first_output"]
    if mode == "checkpoint":
        assert gang["restored_step"] == one["restored_step"] == 2
