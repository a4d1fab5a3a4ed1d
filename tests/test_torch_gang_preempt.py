"""Gang preemption for GPU pod-sets in the port's engine
(``GangPlanner.plan_preemption`` in kubegpu_tpu_torch/scheduler/gang.py,
``Scheduler._try_gang_preempt`` in core.py).

The twins of tests/test_gang_preempt.py's eight scenarios on fake HGX hosts
(8 cards each): a gang that places nowhere evicts the cheapest set of
lower-priority pods (fewest PDB violations, lowest highest priority, lowest
priority sum, fewest victims, then names), widened to whole bound gangs,
and binds; a gang that fits on free cards evicts nobody; equal or higher
priority is never evicted, nor anything when no set helps.

Up to ``EXACT_UNITS`` eviction units the search is exact: on seeded fleets
of 2-4 hosts the engine evicts what a brute-force oracle picks (every set
of units ranked by cost, each planned with ``GangPlanner.plan`` on hosts
where the set's cards are released, the cheapest that places). Above it
the greedy search returns a valid, minimal set within ``MAX_VICTIM_SETS``
plans. The JAX engine with the port's plugin never preempts for a GPU
gang: its planner counts ``alpha.tpu/numchips`` alone."""

import random

import pytest

pytest.importorskip("torch")

from kubegpu_tpu_torch import obs  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler.gang import GangPlanner  # noqa: E402
from tests.torch_sched import (alive, bound_pod, cluster,  # noqa: E402
                               placement, pod)

UUID = fake.fake_uuid


def _hgx(n):
    return [fake.hgx_h100_inventory(host=i) for i in range(n)]


def _submit_gang(api, gang_id, size, numgpu=8, priority=10, prefix="hi"):
    names = [f"{prefix}-{i}" for i in range(size)]
    for n in names:
        api.create_pod(pod(n, numgpu, gang_id=gang_id, gang_size=size,
                           priority=priority))
    return names


def _cards(api, names):
    out = {}
    for n in names:
        got = placement(api, n)
        if got is None or got[0] is None:
            out[n] = None
        else:
            out[n] = (got[0], sorted(
                grammar.gpu_id_from_path(p) for p in got[1]["main"].values()
                if grammar.gpu_id_from_path(p)))
    return out


def _preempt_spans():
    return [sp.attrs for sp in obs.RECORDER.spans()
            if sp.name == "gang_preempt"]


@pytest.fixture
def port(monkeypatch):
    obs.RECORDER.clear()
    made = []

    def build(n_hosts, tweak=None):
        api, hosts, sched = cluster("port", *_hgx(n_hosts), tweak=tweak,
                                    monkeypatch=monkeypatch)
        made.append(sched)
        return api, hosts, sched
    yield build
    for sched in made:
        sched.stop()


def test_gang_preempts_fragmented_low_priority(port):
    api, _, sched = port(2)
    api.create_pod(pod("low-a", 2))
    api.create_pod(pod("low-b", 2))
    sched.run_until_idle()
    assert all(placement(api, n)[0] for n in ("low-a", "low-b"))
    names = _submit_gang(api, 41, 2)
    sched.run_until_idle()
    cards = _cards(api, names)
    assert all(cards.values()), cards
    assert len({u for _, us in cards.values() for u in us}) == 16
    assert not alive(api, "low-a") and not alive(api, "low-b")


def test_gang_preemption_no_eviction_when_free_hosts_exist(port):
    """No cheaper than necessary, base case: two free hosts hold the gang,
    so the blockers pinned on the third stay."""
    api, _, sched = port(3)
    for i in range(3):
        bound_pod(api, "host2", f"blk-{i}", [UUID(2, i)])
    names = _submit_gang(api, 42, 2)
    sched.run_until_idle()
    cards = _cards(api, names)
    assert {c[0] for c in cards.values()} == {"host0", "host1"}
    assert all(alive(api, f"blk-{i}") for i in range(3))
    assert _preempt_spans() == []


def test_gang_preemption_picks_cheapest_eviction_set(port):
    """One victim beats four: host0 is free, host1 holds one 1-card pod,
    host2 four."""
    api, _, sched = port(3)
    bound_pod(api, "host1", "one", [UUID(1, 0)])
    for i in range(4):
        bound_pod(api, "host2", f"many-{i}", [UUID(2, i)])
    names = _submit_gang(api, 43, 2)
    sched.run_until_idle()
    cards = _cards(api, names)
    assert {c[0] for c in cards.values()} == {"host0", "host1"}
    assert not alive(api, "one")
    assert all(alive(api, f"many-{i}") for i in range(4))
    assert [s["victims"] for s in _preempt_spans()] == [1]


def test_gang_preempt_never_evicts_equal_or_higher_priority(port):
    api, _, sched = port(2)
    api.create_pod(pod("peer-a", 2, priority=10))
    api.create_pod(pod("peer-b", 2, priority=10))
    sched.run_until_idle()
    names = _submit_gang(api, 44, 2, priority=10)
    sched.run_until_idle()
    assert all(placement(api, n)[0] is None for n in names)
    assert alive(api, "peer-a") and alive(api, "peer-b")


def test_gang_preempt_all_or_nothing_when_unfixable(port):
    """Higher-priority pods pin a card on every host, so no set of
    allowed evictions frees two whole hosts: nothing is evicted."""
    api, _, sched = port(2)
    bound_pod(api, "host0", "pin-a", [UUID(0, 0)], priority=100)
    bound_pod(api, "host1", "pin-b", [UUID(1, 0)], priority=100)
    bound_pod(api, "host0", "low-a", [UUID(0, 1)])
    bound_pod(api, "host1", "low-b", [UUID(1, 1)])
    names = _submit_gang(api, 45, 2)
    sched.run_until_idle()
    assert all(placement(api, n)[0] is None for n in names)
    assert alive(api, "low-a") and alive(api, "low-b")
    assert [s["plans"] for s in _preempt_spans()] == [0]


def test_gang_preemption_is_pdb_aware(port):
    """Same priority, same cost but for a PodDisruptionBudget: the
    unprotected pod pays."""
    api, _, sched = port(2)
    bound_pod(api, "host0", "guarded", [UUID(0, i) for i in range(8)],
              labels={"app": "db"})
    bound_pod(api, "host1", "fair", [UUID(1, i) for i in range(8)],
              labels={"app": "batch"})
    api.create_pdb({"metadata": {"name": "db-pdb"},
                    "spec": {"selector": {"matchLabels": {"app": "db"}},
                             "minAvailable": 1}})
    names = _submit_gang(api, 46, 2, numgpu=4)
    sched.run_until_idle()
    cards = _cards(api, names)
    assert {c[0] for c in cards.values()} == {"host1"}
    assert alive(api, "guarded") and not alive(api, "fair")


def test_gang_preemption_evicts_whole_victim_gang(port):
    """Evicting one member of a bound gang would strand its sibling: the
    eviction unit is the whole gang."""
    api, _, sched = port(2)
    low = _submit_gang(api, 50, 2, priority=0, prefix="low")
    sched.run_until_idle()
    assert all(placement(api, n)[0] for n in low)
    hi = _submit_gang(api, 51, 2, priority=10, prefix="big")
    sched.run_until_idle()
    assert all(_cards(api, hi).values())
    assert not alive(api, low[0]) and not alive(api, low[1])


def test_planner_respects_reserved_room(port):
    api, _, sched = port(2)
    members = [pod(f"r-{i}", 8, gang_id=47, gang_size=2) for i in range(2)]
    for m in members:
        api.create_pod(m)
    assert sched.gang_planner.plan(members) is not None
    assert sched.gang_planner.plan(
        members, reserved={"host0": 8, "host1": 8}) is None
    assert sched.gang_planner.plan(members, reserved={"host0": 0}) \
        is not None


def test_a_bound_gang_member_at_the_gangs_priority_forbids_its_siblings(
        port):
    """A bound gang with one member at the preemptor's priority is not
    evictable as a unit, though its other member is below it."""
    api, _, sched = port(2)
    bound_pod(api, "host0", "mix-0", [UUID(0, i) for i in range(8)],
              priority=0, gang_id=60, gang_size=2)
    bound_pod(api, "host1", "mix-1", [UUID(1, i) for i in range(8)],
              priority=10, gang_id=60, gang_size=2)
    names = _submit_gang(api, 61, 1, priority=10)
    sched.run_until_idle()
    assert placement(api, names[0])[0] is None
    assert alive(api, "mix-0") and alive(api, "mix-1")


def test_a_plan_on_free_cards_places_with_no_eviction(port):
    """The search's plan may place the gang on cards already free where
    ``plan`` gave up: then nothing is evicted and the gang binds at once
    (the ping-pong guard). Here ``plan`` is made to fail once."""
    api, _, sched = port(2)
    bound_pod(api, "host1", "low", [UUID(1, 0)])
    real = GangPlanner.plan
    calls = []

    def flaky(self, pods, reserved=None, hosts=None):
        calls.append(hosts is None)
        if len(calls) == 1:
            return None
        return real(self, pods, reserved, hosts)
    GangPlanner.plan = flaky
    try:
        names = _submit_gang(api, 62, 1, numgpu=4)
        sched.run_until_idle()
    finally:
        GangPlanner.plan = real
    assert placement(api, names[0])[0] == "host0"
    assert alive(api, "low")
    assert calls[:2] == [True, False]
    assert [s["victims"] for s in _preempt_spans()] == [0]


def test_the_count_check_follows_the_plans_best_fit(port):
    """Free counts 4 and 3 after the one eviction take members of 3, 2, 2
    only best fit (the 3 where it leaves nothing), as the plan places
    them; a first-fit count check would refuse the set."""
    api, _, sched = port(2)
    bound_pod(api, "host0", "v0", [UUID(0, i) for i in range(4)])
    bound_pod(api, "host0", "keep0", [UUID(0, i) for i in range(4, 8)],
              priority=10)
    bound_pod(api, "host1", "keep1", [UUID(1, i) for i in range(5)],
              priority=10)
    assert GangPlanner._counts_fit([3, 2, 2], {"host0": 4, "host1": 3})
    for i, size in enumerate([3, 2, 2]):
        api.create_pod(pod(f"g-{i}", size, gang_id=63, gang_size=3,
                           priority=5))
    sched.run_until_idle()
    assert not alive(api, "v0")
    assert [placement(api, f"g-{i}")[0] for i in range(3)] == \
        ["host1", "host0", "host0"]


# ---- the oracle -------------------------------------------------------------


def _seeded_fleet(seed):
    """2-4 HGX hosts with bound pods of 1, 2 and 4 cards at priorities 0,
    1, 3 and 10 (some of them two-host gangs, some under a PDB), and a
    gang of 2-3 members at priority 5 that places nowhere as they
    stand."""
    rng = random.Random(seed)
    n_hosts = rng.randint(2, 4)
    bound = []  # (node, name, uuids, priority, labels, gang)
    low = 0
    for h in range(n_hosts):
        free = list(range(8))
        rng.shuffle(free)
        k = 0
        while free and rng.random() < 0.85:
            size = min(rng.choice([1, 2, 4]), len(free))
            cards, free = free[:size], free[size:]
            prio = rng.choice([0, 0, 1, 3, 10]) if low < 8 else 10
            low += prio < 5
            labels = {"app": "db"} if rng.random() < 0.2 else None
            bound.append((f"host{h}", f"b{h}-{k}", sorted(cards), prio,
                          labels, None))
            k += 1
    # one two-host gang out of the first pods of host0 and host1
    gangs = [i for i, b in enumerate(bound) if b[1].endswith("-0")][:2]
    if len(gangs) == 2 and rng.random() < 0.6:
        for i in gangs:
            node, name, cards, _, labels, _ = bound[i]
            bound[i] = (node, name, cards, rng.choice([0, 1]), labels, 90)
    members = rng.choice([[8, 8], [8, 4], [4, 4, 2], [8, 2, 2], [4, 4],
                          [8, 8, 8]])
    pdb = rng.random() < 0.5
    return n_hosts, bound, members, pdb


def _build_seeded(seed, monkeypatch):
    n_hosts, bound, sizes, pdb = _seeded_fleet(seed)
    api, _, sched = cluster("port", *_hgx(n_hosts), monkeypatch=monkeypatch)
    for node, name, cards, prio, labels, gang in bound:
        n_gang = sum(1 for b in bound if b[5] == gang) if gang else None
        bound_pod(api, node, name, [UUID(int(node[4:]), c) for c in cards],
                  priority=prio, labels=labels, gang_id=gang,
                  gang_size=n_gang)
    if pdb:
        api.create_pdb({"metadata": {"name": "db"},
                        "spec": {"selector": {"matchLabels": {"app": "db"}},
                                 "minAvailable": 1}})
    members = [pod(f"g-{i}", s, gang_id=77, gang_size=len(sizes),
                   priority=5) for i, s in enumerate(sizes)]
    return api, sched, members, pdb


def _oracle(api, sched, members, pdb):
    """The victims brute force picks (``frozenset()`` for none, None
    when no set places the gang): every set of eviction units ranked by
    (PDB violations, highest priority, priority sum, count, names), each
    planned with ``GangPlanner.plan`` on hosts where its pods' cards are
    released; the cheapest that places, cut to the units its plan uses."""
    import itertools

    planner = sched.gang_planner
    devices = sched.cache.device_scheduler
    if planner.plan(members) is not None:
        return frozenset()
    bound = [p for p in api.list_pods() if p["spec"].get("nodeName")]
    by_name = {p["metadata"]["name"]: p for p in bound}
    prio = {n: int(p["spec"].get("priority") or 0) for n, p in by_name.items()}
    gang_of = {}
    for n, p in by_name.items():
        info = codec.kube_pod_to_pod_info(p, invalidate_existing=False)
        g = info.requests.get(grammar.RESOURCE_GANG)
        if g is not None:
            gang_of.setdefault(g, set()).add(n)
    units = set()
    for n in by_name:
        unit = next((frozenset(m) for m in gang_of.values() if n in m),
                    frozenset([n]))
        if all(prio[m] < 5 for m in unit):
            units.add(unit)
    units = sorted(units, key=sorted)
    guarded = [n for n, p in by_name.items()
               if (p["metadata"].get("labels") or {}).get("app") == "db"]
    allowance = len(guarded) - 1 if pdb else None

    def cost(victims):
        over = 0
        if allowance is not None:
            hit = sum(1 for v in victims if v in guarded)
            over = max(0, hit - max(allowance, 0))
        ps = [prio[v] for v in victims]
        return (over, max(ps), sum(ps), len(ps), tuple(sorted(victims)))

    ranked = sorted(
        (cost(frozenset().union(*s)), s)
        for r in range(1, len(units) + 1)
        for s in itertools.combinations(units, r))
    for _, chosen in ranked:
        hosts = planner.hosts()
        for unit in chosen:
            for n in unit:
                p = by_name[n]
                devices.return_pod_resources(
                    codec.kube_pod_to_pod_info(p, invalidate_existing=False),
                    hosts[p["spec"]["nodeName"]])
        assignment = planner.plan(members, hosts=hosts)
        if assignment is None:
            continue
        used = {(node, grammar.gpu_prefix_from_path(path))
                for node, cards in assignment.values()
                for paths in cards.values() for path in paths}
        owned = set()
        for unit in chosen:
            for n in unit:
                p = by_name[n]
                info = codec.kube_pod_to_pod_info(p,
                                                  invalidate_existing=False)
                if any((p["spec"]["nodeName"],
                        grammar.gpu_prefix_from_path(path)) in used
                       for path in info.running_containers[
                           "main"].allocate_from.values()):
                    owned |= unit
        return frozenset(owned)
    return None


@pytest.mark.parametrize("seed", range(20))
def test_the_search_equals_the_brute_force_oracle(seed, monkeypatch):
    api, sched, members, pdb = _build_seeded(seed, monkeypatch)
    try:
        want = _oracle(api, sched, members, pdb)
        before = {p["metadata"]["name"] for p in api.list_pods()}
        for m in members:
            api.create_pod(m)
        sched.run_until_idle()
        after = {p["metadata"]["name"] for p in api.list_pods()}
        gone = frozenset(before - after)
        placed = [placement(api, m["metadata"]["name"])[0] for m in members]
        if want is None:
            assert gone == frozenset() and not any(placed), (gone, placed)
        else:
            assert gone == want, (sorted(gone), sorted(want))
            assert all(placed), placed
    finally:
        sched.stop()


def test_the_seeded_fleets_exercise_the_search(monkeypatch):
    """The oracle's fleets are not all trivial: at most ten units each,
    most need an eviction, and in some no set helps."""
    outcomes = []
    for seed in range(20):
        api, sched, members, pdb = _build_seeded(seed, monkeypatch)
        try:
            outcomes.append(_oracle(api, sched, members, pdb))
        finally:
            sched.stop()
    evicting = sum(1 for o in outcomes if o)
    assert evicting >= 10, outcomes
    assert any(o is None for o in outcomes), outcomes


# ---- the greedy regime ------------------------------------------------------


def _greedy_fleet(api, n_low_hosts, high_hosts):
    """``n_low_hosts`` hosts of eight 1-card pods at priority 0 (host0
    first), then ``high_hosts`` hosts full at priority 10."""
    for h in range(n_low_hosts):
        for c in range(8):
            bound_pod(api, f"host{h}", f"low{h}-{c}", [UUID(h, c)])
    for h in range(n_low_hosts, n_low_hosts + high_hosts):
        bound_pod(api, f"host{h}", f"high{h}", [UUID(h, c) for c in range(8)],
                  priority=10)


def _released_plan(sched, members, api, victims):
    hosts = sched.gang_planner.hosts()
    for n in victims:
        p = api.get_pod(n)
        sched.cache.device_scheduler.return_pod_resources(
            codec.kube_pod_to_pod_info(p, invalidate_existing=False),
            hosts[p["spec"]["nodeName"]])
    return sched.gang_planner.plan(members, hosts=hosts)


@pytest.mark.parametrize("members,n_low", [([8, 8], 3), ([4, 4, 4], 3),
                                           ([8, 2, 2], 4)])
def test_the_greedy_search_returns_a_valid_minimal_set(port, members, n_low):
    """More than ten units: units are added cheapest first (by name at
    equal cost, so host0's pods first), then dropped dearest first. The
    set is valid, no victim can be spared, and it took at most
    MAX_VICTIM_SETS plans."""
    api, _, sched = port(n_low + 1)
    _greedy_fleet(api, n_low, 1)
    gang = [pod(f"g-{i}", s, gang_id=78, gang_size=len(members), priority=5)
            for i, s in enumerate(members)]
    planner = sched.gang_planner
    units = [[api.get_pod(f"low{h}-{c}")] for h in range(n_low)
             for c in range(8)]
    owners = {}
    for (p,) in units:
        info = codec.kube_pod_to_pod_info(p, invalidate_existing=False)
        for path in info.running_containers["main"].allocate_from.values():
            owners[(p["spec"]["nodeName"],
                    grammar.gpu_prefix_from_path(path))] = \
                p["metadata"]["name"]
    stats = {}
    found = planner.plan_preemption(
        gang, units, owners, lambda v: (0, 0, 0, len(v)), stats=stats)
    assert found is not None
    assignment, victims = found
    assert 0 < stats["plans"] <= GangPlanner.MAX_VICTIM_SETS
    assert _released_plan(sched, gang, api, victims) is not None
    for v in sorted(victims):
        assert _released_plan(sched, gang, api, victims - {v}) is None, v
    # and the engine evicts exactly that set
    before = {p["metadata"]["name"] for p in api.list_pods()}
    for m in gang:
        api.create_pod(m)
    sched.run_until_idle()
    gone = before - {p["metadata"]["name"] for p in api.list_pods()}
    assert gone == set(victims)
    assert all(placement(api, m["metadata"]["name"])[0] for m in gang)
    assert alive(api, f"high{n_low}")


def test_the_search_gives_up_past_its_plan_bound(port, monkeypatch):
    """Past MAX_VICTIM_SETS plans the search gives up and the gang stays
    buffered, nothing evicted."""
    api, _, sched = port(3)
    _greedy_fleet(api, 2, 1)
    monkeypatch.setattr(GangPlanner, "MAX_VICTIM_SETS", 0)
    names = _submit_gang(api, 79, 2, priority=5)
    sched.run_until_idle()
    assert all(placement(api, n)[0] is None for n in names)
    assert len(api.list_pods()) == 16 + 1 + 2
    assert sched.gang_buffer.pending() == 2


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_the_jax_engine_never_preempts_for_a_gpu_gang(engine, monkeypatch):
    """The same fleet under both engines: the JAX engine with the port's
    plugin leaves the gang buffered and every low pod alive (its planner
    sees no card in a GPU gang, Queue 3); the port's evicts and binds."""
    api, _, sched = cluster(engine, *_hgx(2), monkeypatch=monkeypatch)
    try:
        for h in range(2):
            bound_pod(api, f"host{h}", f"low{h}", [UUID(h, 0)])
        if engine == "jax":
            sched._sync_existing()
        names = _submit_gang(api, 80, 2)
        sched.run_until_idle()
        placed = [placement(api, n)[0] for n in names]
        lows = [alive(api, f"low{h}") for h in range(2)]
        if engine == "jax":
            assert placed == [None, None] and lows == [True, True]
        else:
            assert sorted(placed) == ["host0", "host1"]
            assert lows == [False, False]
    finally:
        sched.stop()
