"""The port's masked filter/score pass (`kubegpu_tpu_torch/scheduler/
vectorized.py`, the cache's columnar fleet mirror) against the port's own
scalar chain (``KGTPU_VECTORIZE=0``), as tests/test_vectorized.py holds
the JAX one against the JAX scalar chain.

- Differential: seeded streams over HGX, PCIe and rig hosts (a tainted,
  an unschedulable, a NotReady and a memory-pressured host, a failed
  card, per-card memory floors, volumes, a gang, churn and a forced
  preemption) place every pod alike and leave the same events; the same
  cluster gives the same feasible sets, reasons and scores per probe; the
  preemption choice and ``FastPreemptFit`` agree with the scalar chain.
- The GPU canonical shape: two HGX hosts with different UUIDs share one
  ``alloc_id`` and one allocator search per pod class; a PCIe host and an
  HGX host, or cards of different memory, never share one; the JAX
  package's columns see no card on a GPU node and give every node a shape
  of its own.
- The mask memo's warm passes, the pinned variant kept out of the shape
  memo, a verdict naming a card kept out of it, the kill switch, and the
  masked reasons and score kernels against the scalar functions.
"""

import random

import numpy as np
import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.scheduler import cache as jax_cache  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.node.backend import GPUInfo, GPUInventory  # noqa: E402
from kubegpu_tpu_torch.scheduler import (cache as port_cache,  # noqa: E402
                                         factory, predicates, priorities,
                                         vectorized)
from kubegpu_tpu_torch.scheduler.cache import SchedulerCache  # noqa: E402
from kubegpu_tpu_torch.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.equivalence import (  # noqa: E402
    EquivalenceCache, equivalence_class)
from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.registry import (  # noqa: E402
    build_device_scheduler)
from tests.test_torch_gpu_e2e import GPUHost  # noqa: E402
from tests.torch_sched import PortAPI, placement, pod  # noqa: E402


def _set_node(api, name, *, taints=None, unschedulable=False,
              conditions=None, cpu=None):
    node = api.get_node(name)
    spec = node.setdefault("spec", {})
    if taints:
        spec["taints"] = taints
    if unschedulable:
        spec["unschedulable"] = True
    if conditions:
        node.setdefault("status", {})["conditions"] = conditions
    if cpu:
        node["status"]["allocatable"]["cpu"] = cpu
    api.restore_object("node", "modified", node)


def build_cluster(rng, api=None):
    """A mixed GPU fleet: HGX hosts (one tainted, one NotReady, one
    memory-pressured), PCIe hosts (one unschedulable), a rig host, a
    failed card on one host at random, and three PV/PVC pairs."""
    api = api if api is not None else InMemoryAPIServer()
    invs = [fake.hgx_h100_inventory(0), fake.hgx_h100_inventory(1),
            fake.hgx_h100_inventory(2), fake.pcie_h100_inventory(3),
            fake.pcie_h100_inventory(4), fake.hgx_h100_inventory(5),
            fake.hgx_h100_inventory(6), fake.rig_inventory(7)]
    hosts = {f"host{i}": GPUHost(api, f"host{i}", inv)
             for i, inv in enumerate(invs)}
    sick = hosts[f"host{rng.randrange(3)}"]
    sick.backend.set_chip_health(
        sick.inventory.gpus[rng.randrange(8)].uuid, "failed")
    sick.advertiser.advertise_once()
    _set_node(api, "host2", taints=[{"key": "k", "value": "v",
                                     "effect": "NoSchedule"}])
    _set_node(api, "host4", unschedulable=True)
    _set_node(api, "host5", conditions=[{"type": "Ready",
                                         "status": "False"}])
    _set_node(api, "host6", conditions=[{"type": "MemoryPressure",
                                         "status": "True"}])
    for i in range(3):
        api.create_pv({"metadata": {"name": f"pv{i}"},
                       "spec": {"capacity": {"storage": "10Gi"},
                                "storageClassName": ""}})
        api.create_pvc({"metadata": {"name": f"pvc{i}"},
                        "spec": {"resources":
                                 {"requests": {"storage": "10Gi"}},
                                 "storageClassName": ""}})
    return api, hosts


FLOORS = (0, 0, fake.H100_MEMORY // 2, fake.RIG_MEMORY, fake.H100_MEMORY)


def volume_pod(name, numgpu, claim):
    p = pod(name, numgpu)
    p["spec"]["volumes"] = [
        {"name": "data", "persistentVolumeClaim": {"claimName": claim}}]
    return p


def engine(api, monkeypatch, vectorize, batch="0"):
    monkeypatch.setenv("KGTPU_VECTORIZE", "1" if vectorize else "0")
    monkeypatch.setenv("KGTPU_BATCH", batch)
    sched = Scheduler(PortAPI(api), build_device_scheduler())
    assert (sched.generic.vector is not None) == vectorize
    return sched


def drive_stream(api, sched, rng):
    """Churn, volumes, per-card memory floors, a gang, priorities and one
    forced preemption; returns each pod's placement and events."""
    out = {}
    created = []
    # placement() answers None for a pod that is gone (a preemption victim)
    for i in range(14):
        if i % 5 == 3:
            p = volume_pod(f"v{i}", 1, f"pvc{i % 3}")
        else:
            p = pod(f"p{i}", rng.choice([1, 1, 2, 4, 8]),
                    memory=rng.choice(FLOORS),
                    priority=rng.choice([0, 0, 10]),
                    spec={"tolerations": [{"key": "k", "operator": "Exists",
                                           "effect": "NoSchedule"}]}
                    if rng.random() < 0.3 else None)
        api.create_pod(p)
        created.append(p["metadata"]["name"])
        sched.run_until_idle()
        if i % 6 == 5:
            victim = created.pop(rng.randrange(len(created)))
            api.delete_pod(victim)
            sched.run_until_idle()
    for j in range(2):
        api.create_pod(pod(f"g-{j}", 4, gang_id=901, gang_size=2))
        created.append(f"g-{j}")
    sched.run_until_idle()
    for k in range(60):
        api.create_pod(pod(f"fill{k}", 1))
        created.append(f"fill{k}")
        sched.run_until_idle()
        if not api.get_pod(f"fill{k}")["spec"].get("nodeName"):
            break
    api.create_pod(pod("preemptor", 4, priority=100))
    created.append("preemptor")
    sched.run_until_idle()
    for name in created:
        out[name] = (placement(api, name), sorted(
            (e["reason"], e["message"]) for e in api.list_events(name)))
    return out


def run_differential(seed, monkeypatch, vectorize):
    rng = random.Random(seed)
    api, _ = build_cluster(rng)
    sched = engine(api, monkeypatch, vectorize)
    try:
        return drive_stream(api, sched, rng)
    finally:
        sched.stop()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_placements_identical(seed, monkeypatch):
    metrics.reset_all()
    vec = run_differential(seed, monkeypatch, True)
    served = metrics.FIT_VECTOR_NODES_PER_PASS.total
    scalar = run_differential(seed, monkeypatch, False)
    assert vec == scalar
    assert served > 0
    assert any(v[0] is None for v in vec.values())         # victims
    assert vec["preemptor"][0][0]


def _engines_over(api, monkeypatch):
    return engine(api, monkeypatch, True), engine(api, monkeypatch, False)


PROBES = (pod("probe-1", 1), pod("probe-4", 4), pod("probe-8", 8),
          pod("probe-9", 9), pod("probe-mem", 2,
                                 memory=fake.H100_MEMORY + 1),
          pod("probe-half", 2, memory=fake.H100_MEMORY // 2),
          pod("probe-tol", 2, spec={"tolerations": [
              {"key": "k", "operator": "Exists", "effect": "NoSchedule"}]}),
          volume_pod("probe-vol", 1, "pvc0"))


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_verdicts_and_scores_identical(seed, monkeypatch):
    rng = random.Random(seed)
    api, _ = build_cluster(rng)
    vec_sched, scalar_sched = _engines_over(api, monkeypatch)
    try:
        for i in range(5):
            api.create_pod(pod(f"seed{i}", rng.choice([1, 2, 4])))
            vec_sched.run_until_idle()
        for probe in PROBES:
            name = probe["metadata"]["name"]
            for _ in range(2):     # cold, then from the warm mask memo
                vf, vfail, vsnaps, vmeta = \
                    vec_sched.generic.find_nodes_that_fit(probe)
                sf, sfail, ssnaps, smeta = \
                    scalar_sched.generic.find_nodes_that_fit(probe)
                assert vf == sf, name
                assert vfail == sfail, name
            if vf:
                assert vec_sched.generic.prioritize_nodes(
                    probe, vf, vsnaps, vmeta) == \
                    scalar_sched.generic.prioritize_nodes(
                        probe, sf, ssnaps, smeta), name
    finally:
        vec_sched.stop()
        scalar_sched.stop()


def _fill(api, sched, prefix="low"):
    i = 0
    while True:
        api.create_pod(pod(f"{prefix}{i}", 1, priority=i % 3))
        sched.run_until_idle()
        if not api.get_pod(f"{prefix}{i}")["spec"].get("nodeName"):
            api.delete_pod(f"{prefix}{i}")
            sched.run_until_idle()
            return
        i += 1
        assert i < 80


def test_preemption_choice_identical(monkeypatch):
    rng = random.Random(7)
    api, _ = build_cluster(rng)
    vec_sched, scalar_sched = _engines_over(api, monkeypatch)
    try:
        _fill(api, vec_sched)
        for numgpu in (1, 2, 4, 8):
            hi = pod(f"pre{numgpu}", numgpu, priority=100)
            got, want = vec_sched.generic.preempt(hi), \
                scalar_sched.generic.preempt(hi)
            assert (got is None) == (want is None)
            if got is not None:
                assert got[0] == want[0]
                assert [v["metadata"]["name"] for v in got[1]] == \
                    [v["metadata"]["name"] for v in want[1]]
    finally:
        vec_sched.stop()
        scalar_sched.stop()


def test_fast_preempt_fits_matches_scalar_chain(monkeypatch):
    rng = random.Random(5)
    api, _ = build_cluster(rng)
    vec_sched, scalar_sched = _engines_over(api, monkeypatch)
    try:
        for i in range(6):
            api.create_pod(pod(f"s{i}", rng.choice([1, 2, 4])))
            vec_sched.run_until_idle()
        checked = 0
        for numgpu in (2, 8):
            pre = pod(f"pre{numgpu}", numgpu, priority=100)
            gen, sgen = vec_sched.generic, scalar_sched.generic
            names, _, _, cols = gen.cache.cycle_snapshot(with_columns=True)
            fast = vectorized.FastPreemptFit(
                gen.vector, pre, gen._pod_info_provider(pre), cols)
            assert fast.chips_needed == numgpu
            pig, dc = sgen._pod_info_provider(pre), sgen._device_class(pre)
            for name in names:
                verdict = fast.fits(gen.cache.snapshot_node(name))
                if verdict is None:
                    continue   # off the columns: the scalar chain runs
                assert verdict == sgen._fits_after_evictions(
                    pre, sgen.cache.snapshot_node(name), None, set(), pig,
                    None, dc), (numgpu, name)
                checked += 1
        assert checked >= 10
    finally:
        vec_sched.stop()
        scalar_sched.stop()


def test_preemption_prune_counts_cards(monkeypatch):
    """``might_fit_after_full_eviction``: free cards plus the cards of
    lower-priority pods against ``alpha.gpu/numgpu``, exactly."""
    api = InMemoryAPIServer()
    GPUHost(api, "host0", fake.hgx_h100_inventory(0))
    sched = engine(api, monkeypatch, True)
    try:
        for name, n, prio in (("a", 4, 0), ("b", 2, 5), ("c", 1, 50)):
            api.create_pod(pod(name, n, priority=prio))
        sched.run_until_idle()
        gen = sched.generic
        names, snaps, _, cols = gen.cache.cycle_snapshot(with_columns=True)
        assert int(cols.free_chips[0]) == 1
        assert gen.cache.get_node("host0").pod_chips == \
            {"a": 4, "b": 2, "c": 1}
        pods = {p["metadata"]["name"]: p for p in api.list_pods()}
        for numgpu, prio, want in ((7, 6, True), (8, 6, False),
                                   (5, 5, True), (6, 5, False),
                                   (8, 51, True)):
            pre = pod("pre", numgpu, priority=prio)
            fast = vectorized.FastPreemptFit(
                gen.vector, pre, gen._pod_info_provider(pre), cols)
            assert fast.might_fit_after_full_eviction(
                "host0", prio, pods, snaps["host0"]) is want, (numgpu, prio)
    finally:
        sched.stop()


def _count_searches(monkeypatch):
    calls = []
    real = GPUScheduler.pod_fits_device

    def counted(self, node_info, pod_info, fill, run_grp):
        calls.append(node_info.name)
        return real(self, node_info, pod_info, fill, run_grp)
    monkeypatch.setattr(GPUScheduler, "pod_fits_device", counted)
    return calls


@pytest.mark.parametrize("vectorize,searches", [(True, 1), (False, 6)])
def test_identical_hgx_hosts_share_one_allocator_search(monkeypatch,
                                                        vectorize,
                                                        searches):
    """Six HGX hosts, every card's UUID different: one canonical shape,
    so one search per pod class on the masked pass, six on the scalar
    chain."""
    api = InMemoryAPIServer()
    for i in range(6):
        GPUHost(api, f"host{i}", fake.hgx_h100_inventory(i))
    sched = engine(api, monkeypatch, vectorize)
    try:
        _, _, _, cols = sched.cache.cycle_snapshot(with_columns=True)
        assert len({fp[0] for fp in cols.dev_fps}) == 1
        assert [int(c) for c in cols.free_chips] == [8] * 6
        calls = _count_searches(monkeypatch)
        feasible, _, _, _ = sched.generic.find_nodes_that_fit(pod("a", 2))
        assert len(feasible) == 6
        assert len(calls) == searches
    finally:
        sched.stop()


def _inventory_with_memory(host, memory):
    inv = fake.hgx_h100_inventory(host)
    gpus = [GPUInfo(index=g.index, uuid=g.uuid, minor=g.minor,
                    memory_bytes=memory(g.index), pci_bus_id=g.pci_bus_id)
            for g in inv.gpus]
    return GPUInventory(gpus=gpus, links=inv.links)


def test_shapes_differ_by_topology_and_card_memory():
    """A PCIe host and an HGX host never share a shape, nor do hosts whose
    cards differ in memory; a host's own ranks keep its UUIDs' order."""
    api = InMemoryAPIServer()
    invs = {"hgx": fake.hgx_h100_inventory(0),
            "hgx2": fake.hgx_h100_inventory(1),
            "pcie": fake.pcie_h100_inventory(2),
            "small": _inventory_with_memory(
                3, lambda i: fake.H100_MEMORY // 2),
            "mixed": _inventory_with_memory(
                4, lambda i: fake.H100_MEMORY - (i == 5) * 2**30),
            "rig": fake.rig_inventory(5)}
    for name, inv in invs.items():
        GPUHost(api, name, inv)
    cache = SchedulerCache(build_device_scheduler())
    for node in api.list_nodes():
        cache.set_node(node)
    _, _, _, cols = cache.cycle_snapshot(with_columns=True)
    ids = {n: cols.dev_fps[cols.idx[n]][0] for n in invs}
    assert ids["hgx"] == ids["hgx2"]
    assert len({ids[n] for n in ("hgx", "pcie", "small", "mixed",
                                 "rig")}) == 5
    canon = cols.canon_maps[cols.idx["hgx"]]
    uuids = sorted(g.uuid for g in invs["hgx"].gpus)
    for path, rel in canon.items():
        uuid = grammar.gpu_id_from_path(path.replace("/memory", "/cards"))
        assert rel == path.replace(uuid, str(uuids.index(uuid)))
    assert port_cache.card_ids(canon) == frozenset(uuids)


def test_the_jax_columns_see_no_card_on_a_gpu_node():
    """The JAX package's mirror matches chips only
    (``kubegpu_tpu/scheduler/cache.py:170-196, 311-314``): a GPU node has
    no canonical shape (every node its own ``alloc_id``) and 0 free cards,
    where the port's mirror counts them and shares the shape."""
    from kubegpu_tpu.scheduler.registry import DevicesScheduler
    from kubegpu_tpu.scheduler.tpu_scheduler import TPUScheduler
    from tests.test_torch_gpu_e2e import SCHEDULER_PLUGINS

    api = InMemoryAPIServer()
    for i in range(3):
        GPUHost(api, f"host{i}", fake.hgx_h100_inventory(i))
    ds = DevicesScheduler()
    ds.add_device(TPUScheduler())
    ds.add_devices_from_plugins(SCHEDULER_PLUGINS)
    jc = jax_cache.SchedulerCache(ds)
    pc = SchedulerCache(build_device_scheduler())
    for node in api.list_nodes():
        jc.set_node(node)
        pc.set_node(node)
    *_, jcols = jc.cycle_snapshot(with_columns=True)
    *_, pcols = pc.cycle_snapshot(with_columns=True)
    assert len({fp[0] for fp in jcols.dev_fps}) == 3
    assert [int(c) for c in jcols.free_chips] == [0, 0, 0]
    assert len({fp[0] for fp in pcols.dev_fps}) == 1
    assert [int(c) for c in pcols.free_chips] == [8, 8, 8]


def test_columns_track_mutations():
    cache = SchedulerCache(build_device_scheduler())
    api = InMemoryAPIServer()
    for i in range(2):
        GPUHost(api, f"n{i}", fake.hgx_h100_inventory(i))
    for node in api.list_nodes():
        cache.set_node(node)
    _, _, _, cols = cache.cycle_snapshot(with_columns=True)
    assert cols.names == ["n0", "n1"]
    p = pod("p", 3, priority=7)
    info = cache.pod_info_for_node(p, "n0")
    cache.device_scheduler.pod_allocate(info, cache.nodes["n0"].node_ex)
    info.node_name = "n0"
    codec.pod_info_to_annotation(p["metadata"], info)
    cache.assume_pod(p, "n0")
    *_, cols2 = cache.cycle_snapshot(with_columns=True)
    i0, i1 = cols2.idx["n0"], cols2.idx["n1"]
    assert (int(cols2.free_chips[i0]), int(cols2.free_chips[i1])) == (5, 8)
    assert int(cols2.min_pod_priority[i0]) == 7
    assert int(cols2.gen[i0]) == cache.node_generation("n0")
    assert cols2.dev_fps[i0] != cols2.dev_fps[i1]
    assert cols2.dev_fps[i0][0] == cols2.dev_fps[i1][0]
    assert cache.get_node("n0").pod_chips == {"p": 3}
    cache.forget_pod(p)
    *_, cols3 = cache.cycle_snapshot(with_columns=True)
    assert int(cols3.free_chips[cols3.idx["n0"]]) == 8
    assert cols3.dev_fps[0] == cols3.dev_fps[1]
    cache.remove_node("n1")
    *_, cols4 = cache.cycle_snapshot(with_columns=True)
    assert cols4.names == ["n0"]


def test_warm_passes_reuse_the_mask_memo(monkeypatch):
    metrics.reset_all()
    api = InMemoryAPIServer()
    for i in range(4):
        GPUHost(api, f"host{i}", fake.pcie_h100_inventory(i))
    sched = engine(api, monkeypatch, True)
    try:
        api.create_pod(pod("a", 1))
        sched.run_until_idle()
        assert metrics.FIT_VECTOR_PASS_MS.n >= 1
        assert metrics.FIT_VECTOR_NODES_PER_PASS.total >= 4
        assert metrics.FIT_SCALAR_FALLBACK.value == 0
        hits0 = metrics.FIT_CACHE_HITS.value
        api.create_pod(pod("b", 1))
        sched.run_until_idle()
        # the three nodes ``a`` did not touch come from the mask memo
        assert metrics.FIT_CACHE_HITS.value >= hits0 + 3
        eq = equivalence_class(pod("c", 1))
        moved = placement(api, "b")[0]
        for n in set(sched.cache.node_names()) - {moved}:
            hit = sched.cache.equivalence.lookup(
                n, eq, sched.cache.node_generation(n), record=False)
            assert hit is not None and hit[0], n
    finally:
        sched.stop()


def test_pinned_variant_never_enters_the_shape_memo(monkeypatch):
    """A pod annotated for host ``a`` evaluates its pinned cards there (a
    verdict of that node alone) and the intent elsewhere: only the
    broadcast variant is memoized, and the scalar device cache stays
    untouched."""
    api = InMemoryAPIServer()
    GPUHost(api, "a", fake.hgx_h100_inventory(0))
    GPUHost(api, "b", fake.hgx_h100_inventory(1))
    sched = engine(api, monkeypatch, True)
    try:
        p = pod("pinned", 1)
        info = sched.cache.pod_info_for_node(p, "a")
        sched.device_scheduler.pod_allocate(
            info, sched.cache.snapshot_node("a").node_ex)
        info.node_name = "a"
        codec.pod_info_to_annotation(p["metadata"], info)
        feasible, _, _, _ = sched.generic.find_nodes_that_fit(p)
        assert set(feasible) == {"a", "b"}
        assert len(sched.generic.vector._shape_verdicts) == 1
        assert not sched.generic._device_verdicts
        names, snaps, _, cols = sched.cache.cycle_snapshot(
            with_columns=True)
        fast = vectorized.FastPreemptFit(
            sched.generic.vector, p, sched.generic._pod_info_provider(p),
            cols)
        assert fast.sim_key(snaps["a"], [], [], lambda q: None) is None
        assert fast.sim_key(snaps["b"], [], [], lambda q: None) is not None
    finally:
        sched.stop()


def test_a_verdict_naming_a_card_is_not_broadcast(monkeypatch):
    """A device verdict whose reason names one of the representative's
    card UUIDs belongs to that node: every node of the shape then pays its
    own search, and nothing is memoized for the shape."""
    api = InMemoryAPIServer()
    hosts = [GPUHost(api, f"host{i}", fake.hgx_h100_inventory(i))
             for i in range(3)]
    sched = engine(api, monkeypatch, True)
    try:
        calls = []

        def fits(self, node_info, pod_info, fill, run_grp):
            calls.append(node_info.name)
            uuid = next(g.uuid for h in hosts if h.advertiser.node_name ==
                        node_info.name for g in h.inventory.gpus)
            return False, [f"Insufficient {uuid}/cards"], 0.0
        monkeypatch.setattr(GPUScheduler, "pod_fits_device", fits)
        _, failures, _, _ = sched.generic.find_nodes_that_fit(pod("a", 1))
        assert sorted(calls) == ["host0", "host0", "host1", "host2"]
        for i, h in enumerate(hosts):
            assert h.inventory.gpus[0].uuid in failures[f"host{i}"][0]
        assert not sched.generic.vector._shape_verdicts
    finally:
        sched.stop()


def test_auto_topology_and_absolute_paths_take_the_scalar_chain():
    vec = vectorized.VectorizedFitPass(None, None)
    plain = pod("p", 2)
    auto = pod("auto", 2, auto=True)
    inv = codec.kube_pod_to_pod_info(plain, invalidate_existing=True)
    assert vec.pod_eligible(plain, inv)
    assert not vec.pod_eligible(
        auto, codec.kube_pod_to_pod_info(auto, invalidate_existing=True))
    path = "alpha/grpresource/gpugrp1/0/gpugrp0/0/gpu/GPU-x/cards"
    inv.running_containers["main"].requests[path] = 1
    assert not vec.pod_eligible(plain, inv)
    assert vectorized._chips_demand(inv) == 2


def test_kill_switch_disables_vectorization(monkeypatch):
    metrics.reset_all()
    api = InMemoryAPIServer()
    GPUHost(api, "host0", fake.hgx_h100_inventory())
    sched = engine(api, monkeypatch, False)
    try:
        api.create_pod(pod("a", 1))
        sched.run_until_idle()
        assert api.get_pod("a")["spec"].get("nodeName")
        assert metrics.FIT_VECTOR_PASS_MS.n == 0
        assert not vectorized.available()
    finally:
        sched.stop()


def test_masked_reason_strings_match_scalar_predicates(monkeypatch):
    api = InMemoryAPIServer()
    for i, name in enumerate(("ok", "unsched", "notready", "mem", "disk",
                              "tiny")):
        GPUHost(api, name, fake.hgx_h100_inventory(i))
    _set_node(api, "unsched", unschedulable=True)
    _set_node(api, "notready", conditions=[{"type": "Ready",
                                            "status": "False"}])
    _set_node(api, "mem", conditions=[{"type": "MemoryPressure",
                                       "status": "True"}])
    _set_node(api, "disk", conditions=[{"type": "DiskPressure",
                                        "status": "True"}])
    _set_node(api, "tiny", cpu="1")
    sched = engine(api, monkeypatch, True)
    try:
        p = pod("p", 1)
        p["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "4"
        _, failures, snaps, _ = sched.generic.find_nodes_that_fit(p)
        for name in ("unsched", "notready"):
            assert failures[name] == predicates.check_node_condition(
                p, snaps[name].kube_node)[1]
        assert failures["disk"] == factory._p_disk_pressure(None)(
            factory.PredicateContext(p, snaps["disk"]))[1]
        assert failures["tiny"] == predicates.pod_fits_resources(
            p, snaps["tiny"].core_allocatable,
            snaps["tiny"].requested_core)[1]
        be = {"metadata": {"name": "be"},
              "spec": {"containers": [{"name": "m"}]}}
        _, be_fail, be_snaps, _ = sched.generic.find_nodes_that_fit(be)
        assert be_fail["mem"] == factory._p_memory_pressure(None)(
            factory.PredicateContext(be, be_snaps["mem"]))[1]
    finally:
        sched.stop()


def test_run_filter_verdicts_equal_run_predicates(monkeypatch):
    """The masked pass node by node against its declared scalar twin:
    every node ``run_filter`` evaluates gets the verdict
    ``GenericScheduler._run_predicates`` gives on the same snapshot, and
    the node it hands back to the scalar path is the tainted one."""
    api, _hosts = build_cluster(random.Random(3))
    sched = engine(api, monkeypatch, True)
    try:
        gen = sched.generic
        for p in (pod("f1", 1), pod("f8", 8),
                  pod("fmem", 2, memory=fake.H100_MEMORY)):
            _names, snaps, _gens, cols = gen.cache.cycle_snapshot(
                with_columns=True)
            pod_info_get = gen._pod_info_provider(p)
            results, scalar_names = gen.vector.run_filter(
                p, equivalence_class(p), cols, snaps, {}, pod_info_get)
            assert scalar_names == ["host2"]
            assert sorted(results) == sorted(set(snaps) - {"host2"})
            device_class = gen._device_class(p)
            for name, (fits, reasons, score) in results.items():
                want = gen._run_predicates(p, snaps[name], None,
                                           pod_info_get, device_class, None)
                assert (fits, reasons, score) == (
                    want[0], [str(r) for r in want[1]], want[2]), name
    finally:
        sched.stop()


def test_score_kernels_match_scalar_priorities():
    api = InMemoryAPIServer()
    labels = ({"topology.kubernetes.io/zone": "z1"},
              {"topology.kubernetes.io/zone": "z2", "tier": "gold"}, {}, {})
    for i in range(4):
        GPUHost(api, f"n{i}", fake.hgx_h100_inventory(i))
        node = api.get_node(f"n{i}")
        node["metadata"].setdefault("labels", {}).update(labels[i])
        node["status"]["allocatable"].update(
            {"cpu": str(4 * (i + 1)), "memory": f"{8 * (i + 1)}Gi"})
        if i == 2:
            node["spec"] = {"taints": [{"key": "k", "value": "v",
                                        "effect": "PreferNoSchedule"}]}
        if i == 3:
            node["metadata"]["annotations"][
                "scheduler.alpha.kubernetes.io/preferAvoidPods"] = \
                '{"preferAvoidPods": []}'
        api.restore_object("node", "modified", node)
    cache = SchedulerCache(build_device_scheduler())
    for node in api.list_nodes():
        cache.set_node(node)
    for i, (node, lab) in enumerate([("n0", {"app": "web"}),
                                     ("n0", {"app": "web"}),
                                     ("n1", {"app": "db"})]):
        cache.add_pod({"metadata": {"name": f"b{i}", "labels": lab},
                       "spec": {"containers": [
                           {"name": "m",
                            "resources": {"requests": {"cpu": "1"}}}]}},
                      node)
    probe = pod("probe", 2, labels={"app": "web"})
    probe["metadata"]["ownerReferences"] = [
        {"uid": "u1", "kind": "ReplicaSet", "name": "rs"}]
    probe["spec"]["containers"][0]["resources"]["requests"].update(
        {"cpu": "2", "memory": "1Gi"})
    probe["spec"]["affinity"] = {"nodeAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 3, "preference": {"matchExpressions": [
                {"key": "tier", "operator": "In", "values": ["gold"]}]}}]}}
    names = sorted(cache.nodes)
    snaps = [cache.snapshot_node(n) for n in names]
    facts = {n: priorities.NodeFacts(s.kube_node, s.core_allocatable,
                                     s.requested_core, s.pod_labels)
             for n, s in zip(names, snaps)}
    req = predicates.pod_core_requests(probe)
    cols = vectorized._ScoreColumns(snaps, req)
    pairs = [
        (vectorized._kernel_least_requested,
         lambda n: priorities.least_requested(req, facts[n])),
        (vectorized._kernel_most_requested,
         lambda n: priorities.most_requested(req, facts[n])),
        (vectorized._kernel_balanced,
         lambda n: priorities.balanced_allocation(req, facts[n])),
        (vectorized._kernel_node_affinity,
         lambda n: priorities.node_affinity(probe, facts[n])),
        (vectorized._kernel_taints,
         lambda n: priorities.taint_toleration(probe, facts[n])),
        (vectorized._kernel_avoid,
         lambda n: priorities.node_prefer_avoid_pods(probe, facts[n])),
        (vectorized._kernel_equal,
         lambda n: priorities.equal_priority(probe, facts[n]))]
    for kernel, scalar in pairs:
        got = kernel(probe, req, cols, snaps, None)
        assert [float(v) for v in got] == [scalar(n) for n in names], \
            kernel.__name__
    for sels in (None, [{"app": "web"}], []):
        ctx = factory.PriorityContext(None, owner_selectors=sels)
        want = factory._pr_spreading(None)(probe, req, facts, ctx)
        got = vectorized._kernel_spreading(probe, req, cols, snaps, sels)
        assert {n: float(got[i]) for i, n in enumerate(names)} == want
    want_ip = factory._pr_interpod(None)(probe, req, facts,
                                         factory.PriorityContext(None))
    got_ip = vectorized._kernel_interpod(probe, req, cols, snaps, None)
    assert {n: float(got_ip[i]) for i, n in enumerate(names)} == want_ip
    assert np.all(np.isfinite(got_ip))


def test_equivalence_store_many_and_record():
    eq = EquivalenceCache()
    eq.store_many("c", {"n": ("a", [], 0.0)}, {"n": 5})
    eq.store_many("c", {"n": ("b", [], 0.0)}, {"n": 5})
    assert eq.lookup("n", "c", 5, record=False) == ("b", [], 0.0)
    eq.store_many("c", {"n": ("stale", [], 0.0)}, {"n": 4})
    assert eq.lookup("n", "c", 5, record=False) == ("b", [], 0.0)
    hits, misses = eq.hits, eq.misses
    eq.record(3, 2)
    assert (eq.hits, eq.misses) == (hits + 3, misses + 2)
