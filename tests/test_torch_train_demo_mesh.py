"""``train_demo`` over a mesh (kubegpu_tpu_torch/cmd/train_demo.py):
under ``torchrun --nproc-per-node 4 --dp 2 --sp 2 --tp 1 --device cpu``
(the world of this file), every rank reads the same loader stream and
keeps its rows, and rank 0's losses equal the single-process run's within
1e-4 relative (float32: the ring's float32 probabilities and the
single-device attention's bf16-rounded ones would differ by more in
bf16). Over (2, 1, 2), --checkpoint-dir saves and resumes sharded (4
steps equal 2 plus a resumed 2) and --generate decodes the global prompt
rows as the single-process run does. Also the mesh flags' refusals."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu_torch.cmd import train_demo  # noqa: E402
from tests.torch_worlds import WORLD_TIMEOUT_S, single_rank_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
        "--vocab", "64", "--d-model", "32", "--n-layers", "2",
        "--dtype", "float32"]


def _torchrun(argv: list) -> dict:
    """rank 0's JSON line of train_demo under torchrun on 4 ranks."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "kubegpu_tpu_torch.cmd.train_demo",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout          # rank 0 prints, once
    return json.loads(lines[0])


def test_train_demo_under_torchrun_equals_one_process(capsys):
    mesh_run = _torchrun([*ARGS, "--dp", "2", "--sp", "2", "--tp", "1"])
    assert train_demo.main(ARGS) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mesh_run["devices"] == 4 and one["devices"] == 1
    assert len(mesh_run["losses_full"]) == 3
    for a, b in zip(mesh_run["losses_full"], one["losses_full"]):
        assert abs(a - b) <= 1e-4 * abs(b), (mesh_run, one)


def test_train_demo_checkpoint_and_generate_under_torchrun(capsys,
                                                          tmp_path):
    """Over (2, 1, 2): 4 steps saving every 2 equal 2 steps resumed from
    the sharded step_2 (the file holds the global state, each rank takes
    its shards), and --generate prints the single-process run's row."""
    mesh = ["--dp", "2", "--sp", "1", "--tp", "2"]
    ckpt = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    whole = _torchrun([*ARGS, *mesh, *ckpt, "--steps", "4",
                       "--generate", "4"])
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_4"]
    for name in os.listdir(tmp_path / "step_4"):
        os.remove(tmp_path / "step_4" / name)
    os.rmdir(tmp_path / "step_4")
    resumed = _torchrun([*ARGS, *mesh, *ckpt, "--steps", "2"])
    assert resumed["resumed_from_step"] == 2
    assert resumed["losses_full"] == whole["losses_full"][2:]
    assert train_demo.main([*ARGS, "--steps", "4", "--generate", "4"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(whole["generated"]) == 4
    assert whole["generated"] == one["generated"]
    for a, b in zip(whole["losses_full"], one["losses_full"]):
        assert abs(a - b) <= 1e-4 * abs(b), (whole, one)


@pytest.mark.parametrize("flags,message", [
    (["--dp", "2"], "must be given together"),
    (["--dp", "2", "--sp", "1", "--tp", "1"], "run under torchrun"),
    (["--dp", "1", "--sp", "1", "--tp", "1", "--generate", "200"],
     "exceeds the model's max_seq")], ids=["partial", "no-group", "generate"])
def test_train_demo_mesh_flags_refused(capsys, flags, message):
    """Refusals of the mesh flags; --generate over a mesh now decodes, and
    refuses only what one device refuses (a horizon past max_seq), before
    any process group forms."""
    with pytest.raises(SystemExit):
        train_demo.main(["--device", "cpu", *flags])
    assert message in capsys.readouterr().err


def test_train_demo_mesh_size_must_be_the_world(capsys):
    with single_rank_mesh():
        with pytest.raises(SystemExit):
            train_demo.main(["--device", "cpu", "--dp", "2", "--sp", "1",
                             "--tp", "1"])
    assert "the process group has 1 ranks" in capsys.readouterr().err
