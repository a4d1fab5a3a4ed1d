"""GPU gangs in the port's engine (kubegpu_tpu_torch/scheduler/gang.py and
``Scheduler._handle_gang_pod``): a pod-set of ``alpha.tpu/gang`` /
``alpha.tpu/gang-size`` members waits for all of them, is placed host by
host all-or-nothing through the GPU plugin's own fit (largest member
first, the host left with the fewest free cards), respects room held for
nominated preemptors, and gets the process contract written by the
engine.

The JAX engine with the port's plugin never binds such a gang: its
planner counts ``alpha.tpu/numchips`` alone (``kubegpu_tpu/scheduler/
gang.py:195-233``), so every GPU member demands nothing and the gang stays
buffered.

The loop, closed (the counterpart of tests/test_gang_launch_e2e.py): the
engine schedules a 2-member gang of 1-card pods on two hosts, each host's
`GPURuntimeHook` gives its pod torchrun's env, and the port's
`WorkloadSupervisor` launches ``train_demo --device cpu --dp 2`` as two
processes that form one gloo group. Rank 0's losses equal a
single-process port run within 1e-6 relative and the JAX train step's on
the same params and batches within 1e-5 (the loss tolerance of
tests/test_torch_train.py)."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import checkpoint as jckpt  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu_torch.core import grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.runtime.launcher import WorkloadSupervisor  # noqa: E402
from kubegpu_tpu_torch.scheduler import gang  # noqa: E402
from tests.torch_sched import (cluster, contract, free_gang_id,  # noqa: E402
                               placement, pod)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cards(alloc: dict) -> list:
    return sorted(p for p in alloc["main"].values()
                  if grammar.gpu_id_from_path(p) is not None)


def test_gang_waits_for_all_its_members(monkeypatch):
    api, hosts, sched = cluster("port", fake.rig_inventory(0),
                                fake.rig_inventory(1), fake.rig_inventory(2),
                                monkeypatch=monkeypatch)
    for r in range(2):
        api.create_pod(pod(f"m{r}", 1, gang_id=5, gang_size=3))
    sched.run_until_idle()
    assert [placement(api, f"m{r}")[0] for r in range(2)] == [None, None]
    assert sched.gang_buffer.pending() == 2
    api.create_pod(pod("m2", 1, gang_id=5, gang_size=3))
    sched.run_until_idle()
    nodes = [placement(api, f"m{r}")[0] for r in range(3)]
    assert sorted(nodes) == ["host0", "host1", "host2"]
    assert sched.gang_buffer.pending() == 0
    contracts = [contract(api, f"m{r}") for r in range(3)]
    assert [c["rank"] for c in contracts] == [0, 1, 2]
    assert {c["count"] for c in contracts} == {3}
    assert {c["coordinator_node"] for c in contracts} == {nodes[0]}
    assert {c["coordinator_port"] for c in contracts} == \
        {gang.gang_coordinator_port(5)}


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_gang_binds_all_or_nothing(engine, monkeypatch):
    """One 1-card host cannot hold a gang of two 1-card pods: neither
    binds and no card stays charged. Over two hosts the port's engine
    binds both, one card each; the JAX engine binds neither (the fault)."""
    api, hosts, sched = cluster(engine, fake.rig_inventory(0),
                                monkeypatch=monkeypatch)
    for r in range(2):
        api.create_pod(pod(f"g{r}", 1, gang_id=7, gang_size=2))
    sched.run_until_idle()
    assert [placement(api, f"g{r}")[0] for r in range(2)] == [None, None]
    assert sched.gang_buffer.pending() == 2
    api.create_pod(pod("solo", 1))
    sched.run_until_idle()
    assert placement(api, "solo")[0] == "host0"       # nothing leaked

    api, hosts, sched = cluster(engine, fake.rig_inventory(0),
                                fake.rig_inventory(1),
                                monkeypatch=monkeypatch)
    for r in range(2):
        api.create_pod(pod(f"g{r}", 1, gang_id=7, gang_size=2))
    sched.run_until_idle()
    got = [placement(api, f"g{r}") for r in range(2)]
    if engine == "jax":
        assert [p[0] for p in got] == [None, None]
        assert sched.gang_buffer.pending() == 2
        return
    assert sorted(p[0] for p in got) == ["host0", "host1"]
    for node, alloc in got:
        card = _cards(alloc)
        assert len(card) == 1
        assert alloc["main"][card[0]] == card[0]         # identity pin
        cfg = hosts[node].hook.create_container(
            f"g{got.index((node, alloc))}", "main", {})
        env = {e["key"]: e["value"] for e in cfg["envs"]}
        assert env["CUDA_VISIBLE_DEVICES"] == \
            hosts[node].inventory.gpus[0].uuid
        assert env["WORLD_SIZE"] == "2"


def test_gang_leaves_room_reserved_for_a_nominated_preemptor(monkeypatch):
    api, hosts, sched = cluster("port", fake.hgx_h100_inventory(),
                                monkeypatch=monkeypatch)
    preemptor = pod("pre", 1, priority=50)
    api.create_pod(preemptor)
    sched.generic.nominate(api.get_pod("pre"), "host0")
    # "pre" is queued; hold it back so only the reservation acts
    sched.queue.forget("pre")
    assert sched.generic._nominated_chip_reservation(
        exclude=set(), min_priority=0) == {"host0": 1}
    members = [pod(f"r{r}", 4, gang_id=9, gang_size=2) for r in range(2)]
    assert sched.gang_planner.plan(members, {"host0": 1}) is None
    plan = sched.gang_planner.plan(members, {})
    assert {node for node, _ in plan.values()} == {"host0"}
    for m in members:
        api.create_pod(m)
    sched.run_until_idle()
    assert [placement(api, f"r{r}")[0] for r in range(2)] == [None, None]
    assert sched.gang_buffer.pending() == 2
    # a lower-priority nomination does not hold room against the gang
    assert sched.generic._nominated_chip_reservation(
        exclude=set(), min_priority=51) == {}


def test_mixed_size_gang_is_split_best_fit(monkeypatch):
    """Members of 4, 2, 2 and 1 cards over two HGX boards, one with 5
    cards taken: largest first, each on the host left with the fewest
    free cards, every card charged once."""
    api, hosts, sched = cluster("port", fake.hgx_h100_inventory(host=0),
                                fake.hgx_h100_inventory(host=1),
                                monkeypatch=monkeypatch)
    api.create_pod(pod("filler", 5, spec={"nodeSelector": {}}))
    sched.run_until_idle()
    filler_node = placement(api, "filler")[0]
    other = "host1" if filler_node == "host0" else "host0"
    sizes = {"a": 4, "b": 2, "c": 2, "d": 1}
    for name, n in sizes.items():
        api.create_pod(pod(name, n, gang_id=11, gang_size=4))
    sched.run_until_idle()
    got = {name: placement(api, name) for name in sizes}
    assert {n: p[0] for n, p in got.items()} == {
        "a": other, "b": filler_node, "c": other, "d": filler_node}
    cards = [c for name in sizes for c in _cards(got[name][1])]
    assert [len(_cards(got[n][1])) for n in sizes] == list(sizes.values())
    assert len(set(cards)) == len(cards) == 9
    filler_cards = set(_cards(placement(api, "filler")[1]))
    assert filler_cards.isdisjoint(cards)
    ranks = {n: contract(api, n)["rank"] for n in sizes}
    assert ranks == {"a": 0, "b": 1, "c": 2, "d": 3}


def test_gang_member_asking_for_no_cards_has_no_plan(monkeypatch):
    api, hosts, sched = cluster("port", fake.hgx_h100_inventory(),
                                monkeypatch=monkeypatch)
    members = [pod("x", 2, gang_id=3, gang_size=2),
               pod("y", 0, gang_id=3, gang_size=2)]
    assert sched.gang_planner.plan(members) is None


# ---- the loop ---------------------------------------------------------------

ARGS = ["--steps", "3", "--batch", "4", "--seq", "32", "--vocab", "64",
        "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
        "--dtype", "float32", "--device", "cpu", "--checkpoint-every", "100"]
JAX_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=128,
               max_seq=32, dtype="float32", attn_impl="xla")


def _jax_state_and_losses(ckpt_dir, data):
    """JAX's initial train state saved as step 0 in the reference's numpy
    format, and JAX's losses over the loader's first three batches."""
    from kubegpu_tpu_torch.workload.data import make_loader

    cfg = jmodel.TransformerConfig(**JAX_CFG)
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    opt = jtrain.default_optimizer()
    state = opt.init(params)
    jckpt._save_numpy(ckpt_dir, {"params": params, "opt_state": state},
                      step=0)
    step = jtrain.make_train_step(cfg, None, opt)
    loader = make_loader(data, 4, 32, seed=0)
    losses = []
    try:
        for _ in range(3):
            params, state, loss = step(params, state,
                                       jnp.asarray(next(loader)))
            losses.append(float(loss))
    finally:
        loader.close()
    return losses


def test_engine_scheduled_gang_launches_and_trains_as_one_group(
        tmp_path, monkeypatch, capsys):
    from kubegpu_tpu_torch.cmd import train_demo
    from kubegpu_tpu_torch.workload.data import write_token_shard

    monkeypatch.chdir(REPO)
    rng = np.random.default_rng(0)
    data = [write_token_shard(str(tmp_path / f"shard{i}.kgtd"),
                              rng.integers(0, 64, size=4096,
                                           dtype=np.uint32))
            for i in range(2)]
    ckpt = str(tmp_path / "ckpt")
    jax_losses = _jax_state_and_losses(ckpt, data)
    argv = [*ARGS, "--data", *data, "--checkpoint-dir", ckpt]

    gid = free_gang_id()
    api, hosts, sched = cluster("port", fake.rig_inventory(0),
                                fake.rig_inventory(1),
                                monkeypatch=monkeypatch)
    for r in range(2):
        api.create_pod(pod(f"w{r}", 1, gang_id=gid, gang_size=2))
    sched.run_until_idle()
    contracts = {n: contract(api, n) for n in ("w0", "w1")}
    assert all(placement(api, n)[0] for n in contracts), "gang did not bind"
    assert {c["rank"] for c in contracts.values()} == {0, 1}

    sup = WorkloadSupervisor(api=api, log_dir=str(tmp_path / "logs"))
    cids = {}
    try:
        for name in ("w0", "w1"):
            node = placement(api, name)[0]
            cfg = hosts[node].hook.create_container(
                name, "main", {"envs": [{"key": "OMP_NUM_THREADS",
                                         "value": "1"}]})
            env = {e["key"]: e["value"] for e in cfg["envs"]}
            assert env["WORLD_SIZE"] == "2"
            assert env["MASTER_PORT"] == \
                str(gang.gang_coordinator_port(gid))
            cids[name] = sup.launch(name, "main", cfg, [
                sys.executable, "-m", "kubegpu_tpu_torch.cmd.train_demo",
                *argv, "--dp", "2", "--sp", "1", "--tp", "1"]).cid
        statuses = {n: sup.wait(c, timeout=300) for n, c in cids.items()}
    finally:
        sup.shutdown()
    for name, st in statuses.items():
        log = open(st["log_path"]).read()
        assert st["exit_code"] == 0, f"{name} failed:\n{log[-3000:]}"
    rank0 = next(n for n, c in contracts.items() if c["rank"] == 0)
    lines = [ln for ln in open(statuses[rank0]["log_path"])
             if ln.startswith("{")]
    out = json.loads(lines[-1])
    other = next(n for n in contracts if n != rank0)
    assert not [ln for ln in open(statuses[other]["log_path"])
                if ln.startswith("{")]
    assert out["devices"] == 2 and out["resumed_from_step"] == 0

    assert train_demo.main(argv) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["devices"] == 1 and len(one["losses_full"]) == 3
    for a, b, j in zip(out["losses_full"], one["losses_full"], jax_losses):
        assert abs(a - b) <= 1e-6 * abs(b), (out, one)
        assert abs(a - j) <= 1e-5, (out, jax_losses)
