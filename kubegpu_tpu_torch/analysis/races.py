"""The race twins: scenarios over the port's concurrent modules, each with
the mutant that puts a fixed race back, for the interleaving explorer
(`explore.py`, `schedules.py`).

A scenario is what :func:`schedules.explore` takes: a zero-argument
callable returning ``(bodies, invariant)``. Each race the port's code
holds down has a *mutant twin*, a minimal subclass with the fix mutated
back out; the explorer must rediscover it within a fixed budget of
schedules, and the fixed class must pass the identical scenario on every
schedule. :func:`catalog` lists them all and :func:`run_twin` runs one, which
is how the tests (``tests/test_torch_explore.py``,
``tests/test_torch_racer_fixes.py``, ``tests/test_torch_apf.py``) and
``chip_smoke.py``'s explorer phase share one set.

Card-level scenarios take the node's card paths (``.../gpu/<UUID>/cards``
leaves, as a node advertises them; :func:`card_paths`), so on a machine
with a card they key real UUIDs, and a ledger keyed by card,
``(node, grammar.gpu_prefix_from_path)``. Two cards are used: ``cards[0]``
is the one the racers contend for.

The races:

- the scheduler cache's card conservation: an assume on a pod already
  charged as bound, and a bound-pod watch event taken for our own bind
  (``AssumeOnChargedCache``, ``LostConflictCache``);
- a bound pod's allocation annotations rewritten, and a gang split at the
  arbiter (``UnguardedAPIServer``, ``MemberwiseBindAPIServer``);
- repair eviction re-creating a member still bound
  (``ForgetfulEvictRepair``);
- a sharded replica's bind written as two requests, which leaves a lost
  commit's allocation stamped on the pending pod
  (``TwoWriteBindScheduler``), and a bind-verb extender's refused bind
  that leaves its stamp there (``KeptStampScheduler``);
- lost updates of the client's retry counter and the elector's
  transition counter, and the node lifecycle's double drain
  (``UnguardedRetryClient``, ``UnguardedTransitionElector``,
  ``UnclaimedFlushLifecycle``);
- and, clean only, seq-exact watch delivery, the stream push across a
  reconnect, and the front door's reject during a drain.
"""

# analysis: disable-file=racer -- the twins run only under the explorer's cooperative scheduler, one virtual thread at a time, and each mutant is racy on purpose: the reference keeps its twins under tests/, outside the scanned package

from __future__ import annotations

import copy
import functools
import io
import json
import time
from typing import Callable, List, Optional

from kubegpu_tpu_torch.analysis import explore as ex
from kubegpu_tpu_torch.analysis import schedules as sch
from kubegpu_tpu_torch.cluster import apf, lease
from kubegpu_tpu_torch.cluster import stream as stream_mod
from kubegpu_tpu_torch.cluster.apiserver import InMemoryAPIServer
from kubegpu_tpu_torch.cluster.httpapi import (Conflict, HTTPAPIClient,
                                               _EventLog)
from kubegpu_tpu_torch.cmd.simulate import make_pod
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.core.types import ContainerInfo, NodeInfo, PodInfo
from kubegpu_tpu_torch.scheduler.cache import SchedulerCache
from kubegpu_tpu_torch.scheduler.core import Scheduler
from kubegpu_tpu_torch.scheduler.extender import ExtenderError
from kubegpu_tpu_torch.scheduler.lifecycle import (NodeLifecycle,
                                                   requeued_copy)
from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler

NODE = "host0"


def _same(obj):
    return obj


# ---- objects ----------------------------------------------------------------


def card_paths(backend) -> list:
    """The card-leaf paths a node over ``backend`` (NVML or a fake)
    advertises, sorted."""
    from kubegpu_tpu_torch.node.manager import GPUDeviceManager

    info = NodeInfo(name=NODE)
    GPUDeviceManager(backend).update_node_info(info)
    return sorted(k for k in info.allocatable if grammar.gpu_id_from_path(k))


def hgx_cards(host: int = 0) -> list:
    """The eight card paths of fake HGX host ``host``."""
    from kubegpu_tpu_torch.node import fake

    return card_paths(fake.FakeGPUBackend(fake.hgx_h100_inventory(host)))


def gpu_node(name: str, backend) -> dict:
    """A node object advertising ``backend``'s cards, as the node agent
    writes it."""
    from kubegpu_tpu_torch.node.manager import GPUDeviceManager

    info = NodeInfo(name=name)
    GPUDeviceManager(backend).update_node_info(info)
    meta = {"name": name, "annotations": {
        codec.NODE_ADDRESS_ANNOTATION: "127.0.0.1"}}
    codec.node_info_to_annotation(meta, info)
    return {"metadata": meta,
            "status": {"allocatable": {"cpu": "64", "pods": 110}}}


def pinned_pod(name: str, node: Optional[str], paths: list) -> dict:
    """A pod whose device annotation pins the cards ``paths`` of NODE: the
    wire shape a scheduler replica's bind carries. ``node`` binds it."""
    info = PodInfo(name=name, running_containers={"main": ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: len(paths)})})
    cont = info.running_containers["main"]
    for path in paths:
        cont.dev_requests[path] = 1
        cont.allocate_from[path] = path
    info.node_name = NODE
    meta = {"name": name}
    codec.pod_info_to_annotation(meta, info)
    pod = {"metadata": meta, "spec": {}}
    if node:
        pod["spec"]["nodeName"] = node
    return pod


def _ann(pod: dict) -> dict:
    return pod["metadata"]["annotations"]


class CardLedger:
    """A device-scheduler stand-in that keeps per-node card accounting,
    the conservation invariant's measurement point. ``key`` maps an
    allocation path to its physical card."""

    def __init__(self, key: Callable = grammar.gpu_prefix_from_path):
        self.key = key
        self.used: dict = {}  # node -> {card key -> count}

    def add_node(self, name, node_ex):
        self.used.setdefault(name, {})

    def remove_node(self, name):
        self.used.pop(name, None)

    def _cards(self, pod_info):
        out = []
        for cont in list(pod_info.init_containers.values()) + \
                list(pod_info.running_containers.values()):
            for path in cont.allocate_from.values():
                card = self.key(str(path))
                if card is not None:
                    out.append(card)
        return out

    def take_pod_resources(self, pod_info, node_ex):
        counts = self.used.setdefault(node_ex.name, {})
        for card in self._cards(pod_info):
            counts[card] = counts.get(card, 0) + 1

    def return_pod_resources(self, pod_info, node_ex):
        counts = self.used.setdefault(node_ex.name, {})
        for card in self._cards(pod_info):
            counts[card] = counts.get(card, 0) - 1

    def counts(self, node):
        return {c: n for c, n in self.used.get(node, {}).items() if n != 0}


def bound_cards(api) -> list:
    """``(node, card UUID)`` of every card a bound pod holds."""
    cards = []
    for pod in api.list_pods():
        node = (pod.get("spec") or {}).get("nodeName")
        if not node:
            continue
        info = codec.kube_pod_to_pod_info(pod, False)
        for cont in info.running_containers.values():
            cards += [(node, grammar.gpu_id_from_path(p))
                      for p in cont.allocate_from.values()]
    return cards


# ---- card conservation in the scheduler cache --------------------------------


class AssumeOnChargedCache(SchedulerCache):
    """The fix mutated out: ``assume_pod`` registers an assume on a pod
    already charged as bound (a competing replica's commit observed
    mid-cycle), so the eventual conflict-forget releases a charge the
    assume never made."""

    def assume_pod(self, kube_pod, node_name, now=None):
        with self._lock:
            name = kube_pod["metadata"]["name"]
            # missing: `if name in self._charged and name not in
            # self._assumed: return`
            self._charge_locked(kube_pod, node_name, take=True)
            node = self.nodes.get(node_name)
            if node is not None:
                node.pod_names.add(name)
            deadline = (now if now is not None else time.monotonic()) + 30.0
            self._assumed[name] = (node_name, deadline, kube_pod)


class LostConflictCache(SchedulerCache):
    """The fix mutated out: a bound-pod watch event for an assumed pod is
    always taken for our own bind confirming, though the winner's
    allocation may differ (the cache keeps phantom cards and takes the
    winner's for free)."""

    def add_pod(self, kube_pod, node_name):
        with self._lock:
            name = kube_pod["metadata"]["name"]
            if name in self._assumed:
                self._assumed.pop(name)
                if node_name in self.nodes:
                    self.nodes[node_name].pod_names.add(name)
                return  # missing: reconcile a DIFFERENT winning allocation
            self._charge_locked(kube_pod, node_name, take=True)
            if node_name in self.nodes:
                self.nodes[node_name].pod_names.add(name)


def conservation(cache_cls, cards: Optional[list] = None, spell=_same,
                 key: Callable = grammar.gpu_prefix_from_path):
    """Our replica assumes pod "p" on ``cards[1]``; the arbiter's winner
    bound "p" on ``cards[0]`` and its watch event races our cycle; the
    conflict reply makes us forget. Whatever the interleaving, the cache's
    accounting converges to the server's truth: one charge, for the
    winner's card. ``spell`` rewrites the pods (the tests give the JAX
    cache their TPU twins), ``key`` maps a path to its card."""
    cards = cards or hgx_cards()

    def scenario():
        ledger = CardLedger(key)
        cache = cache_cls(ledger)
        cache.set_node({"metadata": {"name": NODE}})
        winner = spell(pinned_pod("p", NODE, [cards[0]]))
        ours = spell(pinned_pod("p", None, [cards[1]]))
        winner_card = key(next(iter(codec.kube_pod_to_pod_info(
            winner, False).running_containers["main"].allocate_from)))

        def watch_event():
            cache.add_pod(winner, NODE)

        def our_cycle():
            cache.assume_pod(ours, NODE)
            cache.forget_pod(ours)  # the arbiter's Conflict reply

        def invariant():
            counts = ledger.counts(NODE)
            assert counts == {winner_card: 1}, (
                f"card accounting corrupted: {counts} (server truth: "
                f"exactly one charge for {winner_card})")

        return [watch_event, our_cycle], invariant

    scenario.__name__ = f"conservation_{cache_cls.__name__}"
    return scenario


# ---- the arbiter: immutable allocations, atomic gangs -------------------------


class UnguardedAPIServer(InMemoryAPIServer):
    """The fix mutated out: a bound pod's allocation annotations are
    rewritable, so a losing replica's stale stamp silently swaps the pod's
    cards under the whole control plane."""

    def _allocation_guard_locked(self, name, new_ann):
        return None


class MemberwiseBindAPIServer(InMemoryAPIServer):
    """Gang atomicity mutated out: ``bind_many`` commits member by member,
    releasing the arbiter lock between members, so a racing rival can
    split a gang."""

    def bind_many(self, bindings, annotations):
        for name in sorted(bindings):
            if name in annotations:
                self.update_pod_annotations(name, annotations[name])
            self.bind_pod(name, bindings[name])


def annotation_rewrite(server_cls, cards: Optional[list] = None,
                       spell=_same, conflict=Conflict):
    """Replica A binds "w" on ``cards[0]``; replica B's stale stamp
    rewrites w's annotations to ``cards[1]``; replica C binds rival "r"
    claiming ``cards[0]``. A bound pod's committed allocation is
    immutable, and committed allocations never overlap."""
    cards = cards or hgx_cards()

    def scenario():
        api = server_cls()
        api.create_node({"metadata": {"name": NODE}})
        w = spell(pinned_pod("w", None, [cards[0]]))
        stale = spell(pinned_pod("w", None, [cards[1]]))
        r = spell(pinned_pod("r", None, [cards[0]]))
        api.create_pod(w)
        api.create_pod(r)
        committed = {}

        def replica_a():
            try:
                api.bind_many({"w": NODE}, {"w": _ann(w)})
                committed["w"] = _ann(w)
            except conflict:
                pass  # the rival won the card first: a legitimate loss

        def replica_b():
            try:
                api.update_pod_annotations("w", _ann(stale))
            except conflict:
                pass  # the guard held: expected once w is bound

        def replica_c():
            try:
                api.bind_many({"r": NODE}, {"r": _ann(r)})
                committed["r"] = _ann(r)
            except conflict:
                pass  # card already claimed by w: expected

        def invariant():
            dev = codec.POD_ANNOTATION_KEY
            assert committed, "arbiter refused every bind"
            if "w" in committed:
                stored = api.get_pod("w")["metadata"]["annotations"]
                assert stored.get(dev) == committed["w"].get(dev), (
                    "bound pod's allocation annotations were rewritten")
            if "r" in committed and "w" in committed:
                assert committed["r"].get(dev) != committed["w"].get(dev), (
                    "card committed twice across replicas")

        return [replica_a, replica_b, replica_c], invariant

    scenario.__name__ = f"annotation_rewrite_{server_cls.__name__}"
    return scenario


def gang_atomicity(server_cls, cards: Optional[list] = None):
    """A gang of two (``cards[1]``, ``cards[0]``) commits while a rival
    claims ``cards[0]``: the gang binds whole or not at all."""
    cards = cards or hgx_cards()

    def scenario():
        api = server_cls()
        api.create_node({"metadata": {"name": NODE}})
        g0 = pinned_pod("g0", None, [cards[1]])
        g1 = pinned_pod("g1", None, [cards[0]])
        rival = pinned_pod("rv", None, [cards[0]])  # collides with g1
        for p in (g0, g1, rival):
            api.create_pod(p)

        def gang_bind():
            try:
                api.bind_many({"g0": NODE, "g1": NODE},
                              {"g0": _ann(g0), "g1": _ann(g1)})
            except Conflict:
                pass

        def rival_bind():
            try:
                api.bind_many({"rv": NODE}, {"rv": _ann(rival)})
            except Conflict:
                pass

        def invariant():
            bound = {n: bool((api.get_pod(n).get("spec") or {})
                             .get("nodeName")) for n in ("g0", "g1")}
            assert bound["g0"] == bound["g1"], (
                f"gang split across the arbiter: {bound}")

        return [gang_bind, rival_bind], invariant

    scenario.__name__ = f"gang_atomicity_{server_cls.__name__}"
    return scenario


# ---- the watch log and the stream push ---------------------------------------


def watch_log():
    """Two mutators race a resuming watch consumer through `_EventLog`: in
    every schedule the consumer sees strictly increasing sequence numbers
    and ends with every object delivered."""

    def watch_log_scenario():
        api = InMemoryAPIServer()
        log = _EventLog(api)
        seen: list = []

        def writer_a():
            api.create_pod({"metadata": {"name": "a"}, "spec": {}})
            api.create_pod({"metadata": {"name": "b"}, "spec": {}})

        def writer_b():
            api.create_pod({"metadata": {"name": "c"}, "spec": {}})

        def consumer():
            cursor = 0
            for _ in range(12):
                events, latest, _folded, relist = log.since(
                    cursor, timeout=0.1, batch_s=0.0)
                assert not relist
                for seq, _kind, _event, obj in events:
                    assert seq > cursor, (
                        f"seq {seq} at or below cursor {cursor}")
                    seen.append((seq, obj["metadata"]["name"]))
                assert latest >= cursor
                cursor = latest
                if cursor >= 3:
                    return

        def invariant():
            seqs = [s for s, _ in seen]
            assert seqs == sorted(set(seqs)), f"dup/regressed seq: {seqs}"
            assert {n for _, n in seen} == {"a", "b", "c"}, seen

        return [writer_a, writer_b, consumer], invariant

    return watch_log_scenario


def stream_reconnect():
    """The stream wire's fan-out under a reconnect racing live mutations:
    the subscriber's connection is severed mid-stream (frames offered to
    the dead incarnation vanish) and the client resubscribes at its
    cursor. In every schedule the delivered stream carries strictly
    increasing sequence numbers and ends with every object delivered. The
    seams in the fan-out (stream.pump, stream.offer, stream.subscribe,
    stream.read_frame) are the explorer's preemption sites."""

    def stream_reconnect_scenario():
        api = InMemoryAPIServer()
        log = _EventLog(api)
        state = {"cursor": 0, "delivered": [], "gen": 0, "sub": None}

        def make_deliver(gen):
            def deliver(data):
                if state["gen"] != gen:
                    return  # severed connection: the frame goes nowhere
                ftype, _rid, payload = stream_mod.read_frame(
                    io.BytesIO(data))
                if ftype != stream_mod.PUSH:
                    return
                batch = codec.decode_watch_batch(payload)
                for seq, _kind, _etype, obj in batch["events"]:
                    state["delivered"].append(
                        (seq, obj["metadata"]["name"]))
                state["cursor"] = max(state["cursor"], batch["seq"])
            return deliver

        state["sub"] = log.add_stream_subscriber(
            make_deliver(0), since=0, threaded=False)

        def writer():
            api.create_pod({"metadata": {"name": "a"}, "spec": {}})
            api.create_pod({"metadata": {"name": "b"}, "spec": {}})

        def pumper():
            for _ in range(20):
                if {n for _, n in state["delivered"]} == {"a", "b"}:
                    return
                log.pump_once(wait_s=0.05)

        def reconnector():
            state["gen"] += 1
            log.remove_stream_subscriber(state["sub"])
            state["sub"] = log.add_stream_subscriber(
                make_deliver(state["gen"]), since=state["cursor"],
                threaded=False)

        def invariant():
            seqs = [s for s, _ in state["delivered"]]
            assert seqs == sorted(set(seqs)), \
                f"doubled/regressed deltas: {state['delivered']}"
            assert {n for _, n in state["delivered"]} == {"a", "b"}, \
                f"dropped deltas: {state['delivered']}"

        return [writer, pumper, reconnector], invariant

    return stream_reconnect_scenario


# ---- repair eviction against a racing bind ----------------------------------


class CorrectRepairEvict:
    """The repair controller's eviction shape: delete the bound member,
    then re-create it PENDING via ``requeued_copy`` (allocation stripped),
    so a rival bind landing in the window is arbitrated."""

    def evict(self, api, pod):
        fresh = requeued_copy(pod)
        try:
            api.delete_pod(pod["metadata"]["name"])
        except KeyError:
            return  # externally gone: never resurrect
        ex.probe("repair.requeue")  # the controller's delete->create seam
        api.create_pod(fresh)


class ForgetfulEvictRepair(CorrectRepairEvict):
    """The fix mutated out: the replacement is re-created STILL BOUND with
    its card claims kept, so a rival bind that took the cards in the
    delete->create window ends up double-charged."""

    def evict(self, api, pod):
        try:
            api.delete_pod(pod["metadata"]["name"])
        except KeyError:
            return
        ex.probe("repair.requeue")
        api.create_pod(copy.deepcopy(pod))


def repair_vs_bind(evictor_cls, cards: Optional[list] = None):
    """Repair eviction of a bound 2-member gang racing a bind of a rival
    onto one of the gang's cards (``cards[0]``). On every schedule the
    bound pods' card claims stay pairwise disjoint and the gang stays
    atomic."""
    cards = cards or hgx_cards()

    def scenario():
        api = InMemoryAPIServer()
        api.create_node({"metadata": {"name": NODE}})
        g0 = pinned_pod("g0", None, [cards[1]])
        g1 = pinned_pod("g1", None, [cards[0]])
        rival = pinned_pod("rv", None, [cards[0]])  # wants g1's card
        for p in (g0, g1, rival):
            api.create_pod(p)
        api.bind_many({"g0": NODE, "g1": NODE},
                      {"g0": _ann(g0), "g1": _ann(g1)})
        bound = [api.get_pod("g0"), api.get_pod("g1")]
        evictor = evictor_cls()

        def repair():
            for pod in bound:
                evictor.evict(api, pod)

        def rival_bind():
            try:
                api.bind_many({"rv": NODE}, {"rv": _ann(rival)})
            except (Conflict, KeyError):
                pass  # gang still holds the card / mid-delete: a loss

        def invariant():
            claims: dict = {}
            bound_now = {}
            for name in ("g0", "g1", "rv"):
                pod = api.get_pod(name)
                node = (pod.get("spec") or {}).get("nodeName")
                bound_now[name] = bool(node)
                if not node:
                    continue
                pi = codec.kube_pod_to_pod_info(pod, False)
                for cont in pi.running_containers.values():
                    for path in cont.allocate_from.values():
                        key = (node, grammar.gpu_prefix_from_path(path))
                        claims.setdefault(key, []).append(name)
            for key, owners in claims.items():
                assert len(owners) == 1, (
                    f"card double-charged after repair: {key} claimed "
                    f"by {owners}")
            assert bound_now["g0"] == bound_now["g1"], (
                f"gang split by repair eviction: {bound_now}")

        return [repair, rival_bind], invariant

    scenario.__name__ = f"repair_vs_bind_{evictor_cls.__name__}"
    return scenario


# ---- the sharded-replica commit race -----------------------------------------


class TwoWriteBindScheduler(Scheduler):
    """The repair mutated out: one pod's bind written as two requests, the
    allocation stamp and then the binding, so a bind the arbiter refuses
    leaves the losing allocation stamped on the pending pod, and every
    replan on that host reads it back and fails on the taken card."""

    def _bind_write(self, name, kube_pod, host, attempts=1):
        self.api.update_pod_annotations(
            name, kube_pod["metadata"].get("annotations") or {})
        self.api.bind_pod(name, host)


class KeptStampScheduler(Scheduler):
    """The bind-verb extender's repair mutated out: the allocation stamped
    before the extender's bind stays on the pending pod when the extender
    refuses the bind."""

    def _withdraw_stamp(self, name, kube_pod):
        pass


class ArbiterBindExtender:
    """A bind-verb extender in process: it filters and scores nothing and
    binds through the API server's arbiter, reporting a refusal as an
    extender error, as an HTTP extender's error reply reaches the engine."""

    bind_verb = "bind"
    ignorable = False

    def __init__(self, api):
        self.api = api

    def filter(self, kube_pod, node_names):
        return node_names, {}

    def prioritize(self, kube_pod, node_names):
        return {}

    def bind(self, pod_name, node_name):
        try:
            self.api.bind_pod(pod_name, node_name)
        except Conflict as err:
            raise ExtenderError(f"extender bind: {err}") from err


# Replica 1 owns "victim", replica 0 owns "rival" (`lease.shard_of`).
SHARD_PODS = ("victim", "rival")
SHARD_CYCLES = 12


@functools.lru_cache(maxsize=None)
def _first_card_annotations() -> str:
    """The annotations the engine writes for a one-card pod on an empty
    fake HGX host: the card a competing replica's plan takes too."""
    from kubegpu_tpu_torch.node import fake

    api = InMemoryAPIServer()
    api.create_node(gpu_node(NODE, fake.FakeGPUBackend(
        fake.hgx_h100_inventory(0))))
    api.create_pod(make_pod("probe", 1))
    Scheduler(api, build_device_scheduler()).run_until_idle()
    pod = api.get_pod("probe")
    assert pod["spec"].get("nodeName") == NODE
    return json.dumps(_ann(pod))


def shard_commit_race(engine_cls, extender_bind: bool = False):
    """Two replicas over one API server, each holding its shard's lease
    (`ShardCoordinator`), on a fake HGX host: replica 1's engine schedules
    "victim" while replica 0 commits "rival" on the card replica 1's plan
    picks. Whatever the interleaving, "victim" binds within a dozen
    cycles and no card is claimed twice. ``extender_bind`` gives replica
    1's engine a bind-verb extender (`ArbiterBindExtender`)."""
    from kubegpu_tpu_torch.node import fake

    def scenario():
        api = InMemoryAPIServer()
        api.create_node(gpu_node(NODE, fake.FakeGPUBackend(
            fake.hgx_h100_inventory(0))))
        coords = [lease.ShardCoordinator(api, s, 2, f"sched-{s}",
                                         ttl_s=60.0) for s in range(2)]
        for c in coords + coords:
            c.tick()  # each holds its own lease and sees the other's
        assert coords[1].owned_shards() == frozenset({1})
        assert [lease.shard_of(n, 2) for n in SHARD_PODS] == [1, 0]
        engine = engine_cls(
            api, build_device_scheduler(), shard_owned=coords[1].owns,
            name="sched-1",
            extenders=[ArbiterBindExtender(api)] if extender_bind else None)
        for name in SHARD_PODS:
            api.create_pod(make_pod(name, 1))
        rival_ann = json.loads(_first_card_annotations())

        def replica_1():
            for _ in range(SHARD_CYCLES):
                if api.get_pod("victim")["spec"].get("nodeName"):
                    return
                engine.schedule_one(timeout=0.25)

        def replica_0():
            try:
                api.bind_many({"rival": NODE}, {"rival": rival_ann})
            except Conflict:
                pass  # replica 1 bound the card first: a legitimate loss

        def invariant():
            assert api.get_pod("victim")["spec"].get("nodeName"), (
                "victim never bound: "
                f"{api.get_pod('victim')['metadata']['annotations']}")
            cards = bound_cards(api)
            assert len(cards) == len(set(cards)), \
                f"card claimed twice: {cards}"

        return [replica_1, replica_0], invariant

    scenario.__name__ = f"shard_commit_race_{engine_cls.__name__}" + (
        "_extender_bind" if extender_bind else "")
    return scenario


# ---- the counters and the double drain ---------------------------------------


class UnguardedRetryClient(HTTPAPIClient):
    """The bump before the fix: read-modify-write with no lock. The probe
    marks the preemption window an unguarded ``+=`` leaves open."""

    def _count_retry(self):
        v = self.retry_count
        ex.probe("retry-gap")
        self.retry_count = v + 1


def retry_count(cls):
    def scenario():
        client = cls("http://127.0.0.1:9")  # never dialed

        def bump():
            client._count_retry()

        def invariant():
            assert client.retry_count == 2, \
                f"lost retry count: {client.retry_count}"

        return [bump, bump], invariant

    scenario.__name__ = f"retry_count_{cls.__name__}"
    return scenario


class UnguardedTransitionElector(lease.Elector):
    def _count_transition(self):
        v = self.transitions
        ex.probe("transition-gap")
        self.transitions = v + 1


def transitions(cls):
    def scenario():
        elector = cls(lambda name, holder, ttl: True, "lease", "me", 5.0)

        def bump():
            elector._count_transition()

        def invariant():
            assert elector.transitions == 2, \
                f"lost transition count: {elector.transitions}"

        return [bump, bump], invariant

    scenario.__name__ = f"transitions_{cls.__name__}"
    return scenario


class CountingAPI:
    """create_pod counts arrivals and refuses duplicates like the real API
    server; the probe is the sync point between a flusher's read of the
    pending map and its create landing."""

    def __init__(self):
        self.created = {}

    def create_pod(self, pod):
        name = pod["metadata"]["name"]
        ex.probe("api.create_pod")
        if name in self.created:
            raise Conflict(f"pod {name} already exists")
        self.created[name] = pod


class UnclaimedFlushLifecycle(NodeLifecycle):
    """The flush before the fix: iterate the shared map in place and count
    every landed create, a Conflict included (the retry helper takes it
    for "already landed"). Two concurrent flushers each create and
    count."""

    def _flush_pending_requeues(self):
        landed = []
        for name in sorted(self._pending_requeue):
            ex.probe("flush-gap")
            if self._create_requeued(name, self._pending_requeue[name]):
                landed.append(name)
                self.evicted_total += 1
        for name in landed:
            self._pending_requeue.pop(name, None)
        return landed


def double_drain(cls):
    def scenario():
        api = CountingAPI()
        controller = cls(api)
        controller._pending_requeue["pod-a"] = {
            "metadata": {"name": "pod-a"}, "spec": {}}

        def flush():
            controller._flush_pending_requeues()

        def invariant():
            assert controller.evicted_total == 1, \
                f"requeue counted {controller.evicted_total} times"
            assert len(api.created) == 1

        return [flush, flush], invariant

    scenario.__name__ = f"double_drain_{cls.__name__}"
    return scenario


# ---- the front door ------------------------------------------------------------


def apf_reject_during_drain():
    """One seat, one queue: a holder releasing races a waiter's queue-wait
    deadline. Every interleaving ends with no seat or waiter leaked and the
    waiter observing exactly one outcome (admitted or typed-rejected)."""
    d = apf.APFDispatcher(bands={apf.BAND_WORKLOAD: apf.BandConfig(
        seats=1, queues=1, queue_len=4, queue_wait_s=0.05, hand=1)})
    outcomes = []

    def holder():
        with d.admit("POST", ["pods"], {}, None, "holder"):
            pass

    def waiter():
        try:
            with d.admit("POST", ["pods"], {}, None, "waiter"):
                outcomes.append("admitted")
        except apf.TooManyRequests:
            outcomes.append("rejected")

    def invariant():
        assert len(outcomes) == 1, f"waiter outcomes: {outcomes}"
        in_use, queued = d.inflight(apf.BAND_WORKLOAD)
        assert (in_use, queued) == (0, 0), \
            f"seat/waiter leak after drain: {in_use} in use, " \
            f"{queued} queued"

    return [holder, waiter], invariant


# ---- the catalog ---------------------------------------------------------------


class Twin:
    """One catalog entry: ``scenario`` explored at ``bound`` preemptions
    with seed 0 for at most ``budget`` schedules. A mutant (``needle`` set)
    must fail with ``needle`` in its summary; a clean one must pass every
    schedule, and exhaust the space when ``exhaust``."""

    def __init__(self, name: str, scenario, budget: int, bound: int = 2,
                 needle: Optional[str] = None, exhaust: bool = False):
        self.name = name
        self.scenario = scenario
        self.budget = budget
        self.bound = bound
        self.needle = needle
        self.exhaust = exhaust


# the acceptance budgets: a card mutant within 200 schedules at preemption
# bound 2, a counter, lifecycle or front-door twin within 400
CARD_BUDGET, RACER_BUDGET = 200, 400


def catalog(cards: Optional[list] = None) -> List[Twin]:
    """Every twin, card scenarios over ``cards`` (two card paths of one
    node, ``cards[0]`` contended; a fake HGX host's by default)."""
    cards = cards or hgx_cards()
    mutant = functools.partial(Twin, budget=CARD_BUDGET, bound=2)
    clean = functools.partial(Twin, budget=1000, bound=2, exhaust=True)
    racer = functools.partial(Twin, budget=RACER_BUDGET, bound=2)
    return [
        mutant("conservation/assume_on_charged",
               conservation(AssumeOnChargedCache, cards),
               needle="card accounting corrupted"),
        mutant("conservation/lost_conflict",
               conservation(LostConflictCache, cards),
               needle="card accounting corrupted"),
        clean("conservation/clean", conservation(SchedulerCache, cards)),
        mutant("annotation_rewrite/unguarded",
               annotation_rewrite(UnguardedAPIServer, cards),
               needle="rewritten"),
        clean("annotation_rewrite/clean",
              annotation_rewrite(InMemoryAPIServer, cards)),
        mutant("gang_atomicity/memberwise",
               gang_atomicity(MemberwiseBindAPIServer, cards),
               needle="gang split"),
        clean("gang_atomicity/clean",
              gang_atomicity(InMemoryAPIServer, cards)),
        Twin("watch_log/clean", watch_log(), budget=1000, bound=1),
        Twin("stream_reconnect/clean", stream_reconnect(), budget=1000),
        mutant("repair_vs_bind/forgetful",
               repair_vs_bind(ForgetfulEvictRepair, cards),
               needle="double-charged"),
        clean("repair_vs_bind/clean",
              repair_vs_bind(CorrectRepairEvict, cards)),
        mutant("shard_commit_race/two_write_bind",
               shard_commit_race(TwoWriteBindScheduler),
               needle="victim never bound"),
        Twin("shard_commit_race/clean", shard_commit_race(Scheduler),
             budget=CARD_BUDGET, bound=1, exhaust=True),
        mutant("shard_commit_race/extender_kept_stamp",
               shard_commit_race(KeptStampScheduler, extender_bind=True),
               needle="victim never bound"),
        Twin("shard_commit_race/extender_clean",
             shard_commit_race(Scheduler, extender_bind=True),
             budget=CARD_BUDGET, bound=1, exhaust=True),
        racer("retry_count/unguarded", retry_count(UnguardedRetryClient),
              needle="lost retry count"),
        racer("retry_count/clean", retry_count(HTTPAPIClient),
              exhaust=True),
        racer("transitions/unguarded",
              transitions(UnguardedTransitionElector),
              needle="lost transition count"),
        racer("transitions/clean", transitions(lease.Elector),
              exhaust=True),
        racer("double_drain/unclaimed",
              double_drain(UnclaimedFlushLifecycle), needle="counted 2 times"),
        racer("double_drain/clean", double_drain(NodeLifecycle),
              exhaust=True),
        racer("apf_reject_during_drain/clean", apf_reject_during_drain),
    ]


def run_twin(twin: Twin) -> dict:
    """Explore one twin; its row (schedules, the failing index, seconds,
    schedules/s). Raises AssertionError when a mutant is not found within
    its budget or a clean scenario fails."""
    t0 = time.perf_counter()
    res = sch.explore(twin.scenario, max_schedules=twin.budget,
                      preemption_bound=twin.bound, seed=0)
    seconds = time.perf_counter() - t0
    row = {"scenario": twin.name, "schedules": res.schedules,
           "pruned": res.pruned, "budget": twin.budget,
           "preemption_bound": twin.bound,
           "failing_index": res.failure.schedule_index
           if res.failure is not None else None,
           "exhausted": res.exhausted, "seconds": seconds,
           "schedules_per_s": res.schedules / seconds if seconds else None}
    if twin.needle is not None:
        if res.failure is None:
            raise AssertionError(
                f"{twin.name}: mutant not found in {res.schedules} schedules")
        # the double drain may show as the shared map mutating under a
        # concurrent flusher instead (a KeyError)
        if twin.needle not in res.failure.summary and not (
                twin.name.startswith("double_drain") and
                "KeyError" in res.failure.summary):
            raise AssertionError(f"{twin.name}: {res.failure.summary}")
        if res.failure.schedule_index >= twin.budget:
            raise AssertionError(
                f"{twin.name}: found at schedule "
                f"{res.failure.schedule_index}, past {twin.budget}")
    else:
        if not res.ok:
            raise AssertionError(f"{twin.name}: {res.failure.render()}")
        if twin.exhaust and not res.exhausted:
            raise AssertionError(
                f"{twin.name}: {res.schedules} schedules did not exhaust")
    return row

