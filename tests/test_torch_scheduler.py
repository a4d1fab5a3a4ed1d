"""The port's scheduling engine (kubegpu_tpu_torch/scheduler/core.py and
the modules under it) held against the JAX engine carrying the port's
plugin file (tests/torch_sched.py).

- Engine against engine: the same seeded pod streams over
  `fake.*_inventory` hosts give every pod an equal ``nodeName``, equal
  ``allocate_from`` and an equal event stream (pending reasons, the
  preempted victims) in both engines.
- The JAX engine's fault with auto-topology pods, shown there and
  repaired in the port: the per-node caches exempt such pods by the TPU
  key alone (``kubegpu_tpu/scheduler/core.py:382-402``), so a long-running
  engine refuses a pod from a verdict cached while another host had room.
- A pod asking for TPU chips is refused with a reason, never bound with
  nothing allocated; the engine's spans and metrics record what it did;
  the port's copies of the engine's pure modules answer as the JAX ones.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu.core import grammar as jax_grammar  # noqa: E402
from kubegpu_tpu.core.types import ContainerInfo, PodInfo  # noqa: E402
from kubegpu_tpu.scheduler import equivalence as jax_equivalence  # noqa: E402
from kubegpu_tpu.scheduler import factory as jax_factory  # noqa: E402
from kubegpu_tpu.scheduler import predicates as jax_predicates  # noqa: E402
from kubegpu_tpu_torch import metrics, obs  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler import (equivalence, factory,  # noqa: E402
                                         predicates)
from kubegpu_tpu_torch.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.registry import (  # noqa: E402
    build_device_scheduler, unserved_requests)
from tests.torch_sched import (PortAPI, cluster, edit_node,  # noqa: E402
                               placement, pod)

SIZES = (1, 2, 4, 8)


def _contention(api, hosts, run, rng):
    names = []
    for i in range(14):
        names.append(f"c{i}")
        api.create_pod(pod(f"c{i}", int(rng.choice(SIZES))))
    run()
    for name in rng.choice(names, size=4, replace=False):
        api.delete_pod(str(name))
    run()
    for i in range(4):
        names.append(f"d{i}")
        api.create_pod(pod(f"d{i}", int(rng.choice(SIZES))))
    run()
    return names


def _memory(api, hosts, run, rng):
    floors = (0, fake.H100_MEMORY // 2, fake.H100_MEMORY,
              fake.H100_MEMORY + 1)
    names = []
    for i in range(10):
        names.append(f"m{i}")
        api.create_pod(pod(f"m{i}", int(rng.choice((1, 2, 4))),
                           memory=int(rng.choice(floors))))
    run()
    return names


def _unhealthy(api, hosts, run, rng):
    host = hosts["host0"]
    host.backend.set_chip_health(host.inventory.gpus[3].uuid, "failed")
    host.advertiser.advertise_once()
    names = [f"u{i}" for i in range(9)]
    for name in names:
        api.create_pod(pod(name, int(rng.choice((1, 1, 2)))))
    run()
    return names


def _taints(api, hosts, run, rng):
    tolerate = [{"key": "dedicated", "operator": "Equal", "value": "train",
                 "effect": "NoSchedule"}]
    names = []
    for i in range(10):
        names.append(f"t{i}")
        spec = {"tolerations": tolerate} if rng.random() < 0.5 else {}
        api.create_pod(pod(f"t{i}", int(rng.choice((1, 2, 4))), spec=spec))
    run()
    return names


def _taint_host0(api, hosts):
    edit_node(api, "host0", taints=[{"key": "dedicated", "value": "train",
                                     "effect": "NoSchedule"}])


def _selectors(api, hosts, run, rng):
    names = []
    for i in range(10):
        names.append(f"s{i}")
        zone = str(rng.choice(("a", "b", "c")))
        api.create_pod(pod(f"s{i}", int(rng.choice((1, 2, 4))),
                           spec={"nodeSelector": {"zone": zone}}))
    run()
    return names


def _zones(api, hosts):
    for i, name in enumerate(sorted(hosts)):
        edit_node(api, name, labels={"zone": "ab"[i % 2],
                                     "kubernetes.io/hostname": name})


def _affinity(api, hosts, run, rng):
    anti = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": {"app": "web"}},
         "topologyKey": "kubernetes.io/hostname"}]}}
    near = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": {"app": "db"}},
         "topologyKey": "zone"}]}}
    names = []
    api.create_pod(pod("db", 1, labels={"app": "db"}))
    names.append("db")
    run()
    for i in range(5):
        names.append(f"w{i}")
        api.create_pod(pod(f"w{i}", int(rng.choice((1, 2))),
                           labels={"app": "web"}, spec={"affinity": anti}))
        names.append(f"n{i}")
        api.create_pod(pod(f"n{i}", 1, spec={"affinity": near}))
    run()
    return names


def _preemption(api, hosts, run, rng):
    api.create_pdb({"metadata": {"name": "batch"},
                    "spec": {"selector": {"matchLabels": {"app": "batch"}},
                             "minAvailable": 3}})
    names = []
    for i in range(6):
        names.append(f"low{i}")
        labels = {"app": "batch"} if i % 2 == 0 else {"app": "scratch"}
        api.create_pod(pod(f"low{i}", int(rng.choice((2, 4))),
                           priority=int(rng.integers(0, 3)), labels=labels))
    run()
    for i in range(2):
        names.append(f"high{i}")
        api.create_pod(pod(f"high{i}", 4, priority=100))
        run()
    return names


def _volume(api, hosts, run, rng):
    api.create_pvc({"metadata": {"name": "claim"},
                    "spec": {"resources": {"requests": {"storage": "1Gi"}},
                             "storageClassName": ""}})
    api.create_pv({"metadata": {"name": "vol"},
                   "spec": {"capacity": {"storage": "1Gi"},
                            "storageClassName": ""}})
    names = []
    for i in range(3):
        names.append(f"v{i}")
        spec = {"volumes": [{"name": "data", "persistentVolumeClaim": {
            "claimName": "claim"}}]} if i == 1 else {}
        api.create_pod(pod(f"v{i}", int(rng.choice((2, 4))), spec=spec))
    run()
    return names


STREAMS = {
    "contention": (_contention, (fake.pcie_h100_inventory,
                                 lambda: fake.hgx_h100_inventory(host=1)),
                   None),
    "memory": (_memory, (fake.pcie_h100_inventory,), None),
    "unhealthy": (_unhealthy, (lambda: fake.hgx_h100_inventory(host=0),),
                  None),
    "taints": (_taints, (fake.pcie_h100_inventory,
                         lambda: fake.pcie_h100_inventory(host=1)),
               _taint_host0),
    "selectors": (_selectors, (fake.pcie_h100_inventory,
                               lambda: fake.pcie_h100_inventory(host=1)),
                  _zones),
    "affinity": (_affinity, (fake.pcie_h100_inventory,
                             lambda: fake.pcie_h100_inventory(host=1),
                             lambda: fake.pcie_h100_inventory(host=2)),
                 _zones),
    "preemption": (_preemption, (lambda: fake.hgx_h100_inventory(host=0),),
                   None),
    "volume": (_volume, (fake.pcie_h100_inventory,
                         lambda: fake.pcie_h100_inventory(host=1)), None),
}


def _outcome(engine, stream, seed, monkeypatch):
    body, inventories, tweak = STREAMS[stream]
    api, hosts, sched = cluster(engine, *(inv() for inv in inventories),
                                tweak=tweak, monkeypatch=monkeypatch)
    names = body(api, hosts, sched.run_until_idle,
                 np.random.default_rng(seed))
    return {name: (placement(api, name),
                   sorted((e["reason"], e["message"])
                          for e in api.list_events(name)))
            for name in names}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_engines_place_every_pod_alike(stream, monkeypatch):
    seed = sorted(STREAMS).index(stream)
    want = _outcome("jax", stream, seed, monkeypatch)
    got = _outcome("port", stream, seed, monkeypatch)
    assert got == want
    placed = [n for n, (p, _) in got.items() if p and p[0]]
    pending = [n for n, (p, _) in got.items() if p and not p[0]]
    assert placed, stream
    if stream in ("contention", "memory", "taints", "selectors",
                  "preemption"):
        assert pending, stream
    for name in pending:
        assert any(r == "FailedScheduling" for r, _ in got[name][1]), name
    if stream == "preemption":
        assert any(p is None for p, _ in got.values())     # victims
        assert all(got[f"high{i}"][0][0] for i in range(2))


def _auto_topology_stream(engine, monkeypatch):
    """The stream of the fault: 4-card auto-topology pods ``a`` and ``b``
    fill host1's NVLink board; ``c`` then asks for four more."""
    api, hosts, sched = cluster(engine, fake.pcie_h100_inventory(),
                                fake.hgx_h100_inventory(host=1),
                                monkeypatch=monkeypatch)
    for name in ("a", "b", "c"):
        api.create_pod(pod(name, 4, auto=True))
        sched.run_until_idle()
    return api, sched


def test_auto_topology_pod_is_refused_from_a_stale_verdict_in_the_jax_engine(
        monkeypatch):
    api, _ = _auto_topology_stream("jax", monkeypatch)
    assert [api.get_pod(n)["spec"].get("nodeName") for n in "abc"] == \
        ["host1", "host1", None]
    # a fresh engine over the same cluster binds it: the refusal was the
    # long-running engine's cached verdict, not the cluster
    fresh = Scheduler(PortAPI(api), build_device_scheduler())
    fresh.run_until_idle()
    assert api.get_pod("c")["spec"]["nodeName"] == "host0"


def test_auto_topology_pod_bypasses_the_per_node_caches_in_the_port(
        monkeypatch):
    api, sched = _auto_topology_stream("port", monkeypatch)
    assert [api.get_pod(n)["spec"].get("nodeName") for n in "abc"] == \
        ["host1", "host1", "host0"]
    c = api.get_pod("c")
    assert sched.generic._requests_auto_topology(c)
    assert sched.generic._device_class(c) is None
    # the JAX engine's test reads only the TPU key
    from kubegpu_tpu.scheduler.core import GenericScheduler
    assert not GenericScheduler._requests_auto_topology(c)


def _tpu_pod(name):
    pi = PodInfo(name=name)
    pi.running_containers["main"] = ContainerInfo(
        requests={jax_grammar.RESOURCE_NUM_CHIPS: 4})
    meta = {"name": name}
    jax_codec.pod_info_to_annotation(meta, pi)
    return {"metadata": meta, "spec": {"containers": [
        {"name": "main", "resources": {"requests": {"cpu": "1"}}}]}}


def test_tpu_pod_is_refused_with_a_reason_never_bound_vacuously(monkeypatch):
    api, _, sched = cluster("port", fake.hgx_h100_inventory(),
                            monkeypatch=monkeypatch)
    api.create_pod(_tpu_pod("tpu"))
    api.create_pod(pod("gpu", 2))
    sched.run_until_idle()
    assert api.get_pod("tpu")["spec"].get("nodeName") is None
    assert api.get_pod("gpu")["spec"]["nodeName"] == "host0"
    msgs = " ".join(e["message"] for e in api.list_events("tpu"))
    assert "no device plugin serves alpha.tpu/numchips" in msgs, msgs
    info = jax_codec.kube_pod_to_pod_info(_tpu_pod("x"), False)
    assert unserved_requests(info) == ["alpha.tpu/numchips"]
    gang_info = jax_codec.kube_pod_to_pod_info(
        pod("g", 1, gang_id=3, gang_size=2), False)
    assert unserved_requests(gang_info) == []


def test_engine_records_spans_and_metrics(monkeypatch):
    metrics.reset_all()
    obs.RECORDER.clear()
    api, _, sched = cluster("port", fake.pcie_h100_inventory(),
                            monkeypatch=monkeypatch)
    for name, n in (("a", 4), ("b", 4), ("c", 4)):
        api.create_pod(pod(name, n))
    sched.run_until_idle()
    assert metrics.SCHEDULE_ATTEMPTS.value >= 3
    assert metrics.SCHEDULE_FAILURES.value >= 1
    assert metrics.E2E_SCHEDULING_LATENCY.n == 2
    assert metrics.SCHED_PHASE_MS.labels("filter").n >= 3
    names = {s.name for s in obs.RECORDER.pod_spans("a")}
    assert {"schedule_cycle", "schedule", "filter", "allocate",
            "bind_commit"} <= names
    text = metrics.prometheus_text()
    assert "scheduler_schedule_attempts_total" in text
    assert 'sched_phase_ms_count{phase="filter"}' in text


def test_bind_worker_pool_binds_every_pod(monkeypatch):
    api, _, _ = cluster("port", fake.hgx_h100_inventory(),
                        monkeypatch=monkeypatch)
    sched = Scheduler(PortAPI(api), build_device_scheduler(),
                      bind_async=True, bind_workers=2)
    try:
        for i in range(8):
            api.create_pod(pod(f"p{i}", 1))
        sched.run_until_idle()
    finally:
        sched.stop()
    cards = [placement(api, f"p{i}") for i in range(8)]
    assert all(c[0] == "host0" for c in cards)
    paths = {p for _, alloc in cards for p in alloc["main"].values()}
    assert len(paths) == 8


def test_registry_loads_plugin_files_with_its_own_loader(tmp_path):
    """``build_device_scheduler`` compiles in `GPUScheduler`; a plugin
    directory adds the plugins its files' factories make (the last
    group-capable one runs the allocator), skipping files that fail to
    import, lack the factory or start with ``_``."""
    from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler
    from tests.test_torch_gpu_e2e import SCHEDULER_PLUGINS

    ds = build_device_scheduler()
    assert [type(d) for d in ds.devices] == [GPUScheduler]
    assert ds.run_group_scheduler == [True]
    assert ds.add_devices_from_plugins(SCHEDULER_PLUGINS) == 1
    assert [type(d) for d in ds.devices] == [GPUScheduler, GPUScheduler]
    assert ds.run_group_scheduler == [False, True]
    (tmp_path / "a_broken.py").write_text("raise RuntimeError('no')\n")
    (tmp_path / "b_empty.py").write_text("x = 1\n")
    (tmp_path / "_hidden.py").write_text(
        "def create_device_scheduler_plugin():\n    raise AssertionError\n")
    (tmp_path / "c_plain.py").write_text(
        "class P:\n"
        "    def uses_group_scheduler(self):\n        return False\n"
        "def create_device_scheduler_plugin():\n    return P()\n")
    assert ds.add_devices_from_plugins(str(tmp_path)) == 1
    assert ds.run_group_scheduler == [False, True, False]
    assert ds.add_devices_from_plugins(str(tmp_path / "absent")) == 0


POD = {"metadata": {"name": "p", "labels": {"app": "x"}, "annotations": {
           "pod.alpha/DeviceInformation": '{"requests": {}}'}},
       "spec": {"containers": [
           {"name": "main", "image": "img",
            "resources": {"requests": {"cpu": "500m", "memory": "1Gi"}},
            "ports": [{"hostPort": 80}]}],
           "initContainers": [{"name": "init", "resources": {
               "requests": {"cpu": "2"}}}],
           "nodeSelector": {"zone": "a"}}}


def test_pure_modules_answer_as_the_jax_ones():
    """The copies of predicates, equivalence and factory give the JAX
    modules' answers on the same pod."""
    assert predicates.pod_core_requests(POD) == \
        jax_predicates.pod_core_requests(POD)
    assert predicates.pod_host_ports(POD) == jax_predicates.pod_host_ports(POD)
    assert equivalence.equivalence_class(POD) == \
        jax_equivalence.equivalence_class(POD)
    assert [n for n, _ in factory.default_algorithm().predicates] == \
        [n for n, _ in jax_factory.default_algorithm().predicates]
    assert [(n, w) for n, w, _ in factory.default_algorithm().priorities] == \
        [(n, w) for n, w, _ in jax_factory.default_algorithm().priorities]
