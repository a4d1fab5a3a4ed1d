"""``kgtpu-gpu-simulate``: the one-process cluster demo, over fake GPU
hosts.

The port's copy of ``kubegpu_tpu/cmd/simulate.py``. It starts the port's
API server, ``--hosts`` fake HGX H100 hosts (eight cards each) with their
advertisers, and the port's scheduler; submits a mix (a plain 1-card pod,
a pod with a device-memory floor, a 4-card auto-topology pod, a 1-card pod
bound to a volume, and a gang of 8-card members) and prints the
placements with what each container gets from `GPURuntimeHook`.
``--schedulers N`` runs N optimistic replicas over the one server, each
owning a pod-name-hash shard under a lease.

The scenarios (each raises on a violated invariant):

* ``--chaos [node-loss]``: 4 hosts under a seeded chaos transport, a
  2 x 8-card gang placed, one node agent killed: the lifecycle controller
  detects the loss and evicts, and the gang rebinds whole on survivors.
* ``--chaos chip-kill``: one card allocated to the gang fails (a seeded
  pick): the advertiser reports it, the repair controller checkpoints and
  evicts, and the gang rebinds clean of the dead card, with no card held
  twice and no relist.
* ``--chaos-ha``: two replicas over a WAL-backed HTTP server; replica 0 is
  killed (its shard is stolen) and the server restarted from its WAL on
  the same port: every pod placed once, the watch resumed seq-exact.
* ``--chaos-tenant-flood [--proxies N]``: one tenant floods the front door
  while well-behaved tenants churn; with proxies, the flood is reads at
  one watch-cache proxy and the server's request rate stays flat.

The demo touches no device: its fleet is fake hosts. The CLI and JSON keep
the JAX package's names (``chip-kill``, ``abuser_bound_chips``); printed
text says "card".
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.cluster import stream
from kubegpu_tpu_torch.cluster.apiserver import Conflict, InMemoryAPIServer
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.core.types import ContainerInfo, PodInfo
from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser
from kubegpu_tpu_torch.node.fake import FakeGPUBackend, hgx_h100_inventory
from kubegpu_tpu_torch.node.manager import DevicesManager, GPUDeviceManager
from kubegpu_tpu_torch.runtime.hook import GPURuntimeHook
from kubegpu_tpu_torch.scheduler.core import Scheduler
from kubegpu_tpu_torch.scheduler.gang import RESOURCE_GANG, RESOURCE_GANG_SIZE
from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler

# The memory floor of the mix's floored pod: below the fake H100's 80 GiB.
MEMORY_FLOOR = 64 * 2**30
# Cards a gang member takes: a whole HGX host, as a JAX member takes a
# whole v5p host.
GANG_CARDS = 8


def make_pod(name: str, cards: int, pod_requests: dict | None = None,
             memory: int = 0) -> dict:
    """An unbound pod of one container asking ``cards`` cards (each with
    ``memory`` bytes at least, when given); ``pod_requests`` are pod-level
    device requests (a gang, auto-topology)."""
    pi = PodInfo(name=name, requests=dict(pod_requests or {}))
    reqs = {grammar.RESOURCE_NUM_GPU: cards}
    if memory:
        reqs[grammar.RESOURCE_MEMORY_PER_GPU] = memory
    pi.running_containers["main"] = ContainerInfo(requests=reqs)
    meta = {"name": name}
    codec.pod_info_to_annotation(meta, pi)
    return {"metadata": meta,
            "spec": {"containers": [{"name": "main",
                                     "resources": {"requests": {"cpu": "1"}}}]}}


def gang_pod(name: str, gang: int, size: int,
             cards: int = GANG_CARDS) -> dict:
    return make_pod(name, cards, pod_requests={RESOURCE_GANG: gang,
                                               RESOURCE_GANG_SIZE: size})


def _host_manager(host: int) -> tuple:
    """``(backend, started DevicesManager, its GPUDeviceManager)`` of fake
    HGX host ``host``."""
    backend = FakeGPUBackend(hgx_h100_inventory(host))
    gpu = GPUDeviceManager(backend)
    mgr = DevicesManager()
    mgr.add_device(gpu)
    mgr.start()
    return backend, mgr, gpu


def _create_host(api, name: str, pods: int = 100) -> None:
    api.create_node({"metadata": {"name": name,
                                  "labels": {"kubernetes.io/hostname": name}},
                     "status": {"allocatable": {"cpu": "64", "pods": pods}}})


# ---- the summaries of the JSON document ------------------------------------

def _fit_cache_summary() -> dict:
    """The fit memo and the masked pass: a dead cache (no hit on a
    many-pod run) shows here without a profiler."""
    return {"hits": metrics.FIT_CACHE_HITS.value,
            "misses": metrics.FIT_CACHE_MISSES.value,
            "invalidations": metrics.FIT_CACHE_INVALIDATIONS.value,
            "vector_passes": metrics.FIT_VECTOR_PASS_MS.n,
            "vector_pass_p50_ms": round(
                metrics.FIT_VECTOR_PASS_MS.percentile(0.5), 4),
            "scalar_fallback": metrics.FIT_SCALAR_FALLBACK.value,
            "verdict_timeouts": metrics.FIT_VERDICT_TIMEOUTS.value}


def _batch_summary() -> dict:
    """The batch cycle: cycles run, pods and classes a cycle, and the
    bound-pod rate."""
    cycles = metrics.SCHED_BATCH_SIZE.n
    return {"cycles": cycles,
            "pods_per_cycle_mean": round(
                metrics.SCHED_BATCH_SIZE.total / max(cycles, 1), 2),
            "classes_per_cycle_mean": round(
                metrics.SCHED_BATCH_CLASSES.total / max(cycles, 1), 2),
            "throughput_pods_per_s": round(
                metrics.SCHED_THROUGHPUT.value, 1)}


def _data_plane_summary() -> dict:
    """The binder, the watch batches and the wires: bind latency and
    count, binds in flight, the last watch batch, events coalesced away,
    bytes per wire and direction, frame codec cost, stream push lag."""
    return {"bind_p50_ms": round(metrics.BIND_LATENCY_MS.percentile(0.5), 3),
            "bind_count": metrics.BIND_LATENCY_MS.n,
            "bind_inflight": metrics.BIND_INFLIGHT.value,
            "watch_batch_size": metrics.WATCH_BATCH_SIZE.value,
            "watch_coalesced_total": metrics.WATCH_COALESCED.value,
            "transport_bytes_total": {
                f"{wire}_{direction}": child.value
                for (wire, direction), child
                in metrics.TRANSPORT_BYTES.children()},
            "frame_encode_p50_ms": round(
                metrics.FRAME_ENCODE_MS.percentile(0.5), 4),
            "frame_decode_p50_ms": round(
                metrics.FRAME_DECODE_MS.percentile(0.5), 4),
            "watch_push_lag_p50_ms": round(
                metrics.WATCH_PUSH_LAG_MS.percentile(0.5), 4)}


def _ha_summary() -> dict:
    """Commits the arbiter refused, lease transitions, the WAL's time per
    append and its last snapshot's size."""
    return {"sched_conflicts_total": metrics.SCHED_CONFLICTS.value,
            "lease_transitions_total": metrics.LEASE_TRANSITIONS.value,
            "wal_fsync_p50_ms": round(metrics.WAL_FSYNC_MS.percentile(0.5), 4),
            "wal_appends": metrics.WAL_FSYNC_MS.n,
            "wal_snapshot_bytes": metrics.WAL_SNAPSHOT_BYTES.value}


def _apf_summary() -> dict:
    """The front door: queue wait of seated requests, rejects per band
    (the system band must stay at zero) and pods the DRF gate parked."""
    return {"apf_queue_wait_p50_ms": round(
                metrics.APF_QUEUE_WAIT_MS.percentile(0.5), 4),
            "apf_queue_wait_p99_ms": round(
                metrics.APF_QUEUE_WAIT_MS.percentile(0.99), 4),
            "apf_rejects_total": {
                band: child.value for (band,), child
                in metrics.APF_REJECTS.children()},
            "quota_parked_total": metrics.QUOTA_PARKED.value}


def _proxy_summary(replicas) -> dict:
    """The proxy tier: requests per server role (where a flood landed),
    each replica's downstream watchers, the upstream hop's lag, and the
    upstream leg's bytes (wire="proxy")."""
    return {"api_requests_total": {
                server: child.value for (server,), child
                in metrics.API_REQUESTS.children()},
            "downstream_watchers": {
                r.name: r.downstream_watchers() for r in replicas},
            "proxy_upstream_lag_p50_ms": round(
                metrics.PROXY_UPSTREAM_LAG_MS.percentile(0.5), 3),
            "proxy_upstream_lag_p99_ms": round(
                metrics.PROXY_UPSTREAM_LAG_MS.percentile(0.99), 3),
            "upstream_wire_bytes": {
                dir_: child.value for (wire, dir_), child
                in metrics.TRANSPORT_BYTES.children()
                if wire == stream.WIRE_PROXY}}


def _pod_cards(api, name: str) -> list:
    """The card UUIDs a pod's allocation annotation pins."""
    pi = codec.annotation_to_pod_info(
        api.get_pod(name).get("metadata") or {})
    cards = []
    for cont in pi.running_containers.values():
        for path in cont.allocate_from.values():
            uuid = grammar.gpu_id_from_path(path)
            if uuid:
                cards.append(uuid)
    return cards


def _bound_cards(api, names) -> dict:
    """{pod: [(node, card UUID)]} of every bound pod of ``names``: the
    read-back that shows no card leaked and none held twice."""
    cards = {}
    for name in names:
        pod = api.get_pod(name)
        node = (pod.get("spec") or {}).get("nodeName")
        if not node:
            continue
        cards[name] = [(node, c) for c in _pod_cards(api, name)]
    return cards


def _check_gang_cards(cards: dict, members: int) -> list:
    """Raise unless every member holds GANG_CARDS cards and no card is held
    twice; the flat list of ``(node, card)``."""
    flat = [c for cs in cards.values() for c in cs]
    if sorted(len(c) for c in cards.values()) != [GANG_CARDS] * members \
            or len(set(flat)) != GANG_CARDS * members:
        raise RuntimeError(f"card leak or short allocation: {cards}")
    return flat


# ---- the scenarios ---------------------------------------------------------

def run_chaos_scenario(seed: int = 0, lost_after_s: float = 0.9,
                       stale_after_s: float = 0.3,
                       advertise_interval_s: float = 0.1,
                       drop: float = 0.05):
    """Kill one node agent of a 2 x 8-card gang under a seeded chaos
    transport; measure detection, eviction and rebind. Returns
    ``recovery_ms``, the victim node, the fault counts and the placements;
    raises if the gang does not rebind whole on 16 distinct cards off the
    lost node."""
    from kubegpu_tpu_torch.cluster.chaos import ChaosConfig, ChaosNetwork
    from kubegpu_tpu_torch.scheduler.lifecycle import NodeLifecycle

    net = ChaosNetwork(seed=seed)
    api = InMemoryAPIServer()
    advs = {}
    for i in range(4):
        name = f"host{i}"
        _create_host(api, name)
        _, mgr, _ = _host_manager(i)
        adv = DeviceAdvertiser(
            net.proxy(api, f"agent-{name}", ChaosConfig(drop=drop)),
            mgr, name)
        adv.start(interval_s=advertise_interval_s, retry_s=0.03)
        advs[name] = adv
    # chaos on the verbs every failure path requeues through (list_pods is
    # out: the engine's cold-start sync reads it with no retry above the
    # in-memory client)
    sched_api = net.proxy(api, "scheduler", ChaosConfig(
        drop=drop, delay=0.2, delay_s=0.002,
        verbs={"bind_many", "bind_pod", "update_pod_annotations",
               "record_event", "get_pod"}))
    sched = Scheduler(sched_api, build_device_scheduler())
    sched.start()
    lifecycle = NodeLifecycle(
        net.proxy(api, "lifecycle", ChaosConfig(drop=drop)),
        stale_after_s=stale_after_s, lost_after_s=lost_after_s)
    lifecycle.start(interval_s=0.05)
    names = ["chaos-gang-0", "chaos-gang-1"]
    try:
        for name in names:
            api.create_pod(gang_pod(name, 77, 2))

        def placements(deadline_s, forbidden=None):
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                bound = {}
                for name in names:
                    try:
                        node = api.get_pod(name)["spec"].get("nodeName")
                    except KeyError:
                        # mid-eviction: deleted, its copy not created yet
                        break
                    if not node or (forbidden and node == forbidden):
                        break
                    bound[name] = node
                else:
                    return bound
                time.sleep(0.02)
            raise RuntimeError(
                f"gang did not (re)bind in {deadline_s}s "
                f"(forbidden={forbidden}, faults={net.faults})")

        first = placements(20.0)
        victim = first[names[0]]
        advs[victim].stop()  # the node agent dies mid-gang
        t0 = time.monotonic()
        final = placements(30.0, forbidden=victim)
        recovery_ms = (time.monotonic() - t0) * 1e3
        _check_gang_cards(_bound_cards(api, names), len(names))
        doc = {"recovery_ms": round(recovery_ms, 1),
               "victim": victim,
               "first_placement": first,
               "final_placement": final,
               "evicted_pods": lifecycle.evicted_total,
               "fit_cache": _fit_cache_summary(),
               "batch": _batch_summary(),
               "data_plane": _data_plane_summary(),
               "chaos_faults": {f"{c}:{k}": n for (c, k), n
                                in sorted(net.faults.items())}}
        return doc
    finally:
        lifecycle.stop()
        for adv in advs.values():
            adv.stop()
        sched.stop()


def run_chip_kill_scenario(seed: int = 0,
                           advertise_interval_s: float = 0.05,
                           deadline_s: float = 30.0):
    """Fail one card ALLOCATED to a running 2 x 8-card gang: the advertiser
    reports it, the repair controller checkpoints and evicts, the engine
    replans onto healthy cards. Returns ``recovery_ms``, the victim (node,
    card) and the placements; raises if the gang does not recover, lands
    on the dead card, leaks or double-books a card, was not asked to
    checkpoint, or the watch relisted."""
    from kubegpu_tpu_torch.cluster.chaos import DeviceChaos
    from kubegpu_tpu_torch.scheduler.repair import RepairController

    api = InMemoryAPIServer()
    backends = {}
    advs = {}
    for i in range(4):
        name = f"host{i}"
        _create_host(api, name)
        backends[name], mgr, _ = _host_manager(i)
        adv = DeviceAdvertiser(api, mgr, name)
        adv.start(interval_s=advertise_interval_s, retry_s=0.03)
        advs[name] = adv
    sched = Scheduler(api, build_device_scheduler())
    sched.start()
    repair = RepairController(api)
    repair.start(interval_s=0.05)
    names = ["ck-gang-0", "ck-gang-1"]
    try:
        for name in names:
            api.create_pod(gang_pod(name, 77, 2))

        def placements(deadline, forbidden_card=None):
            stop_at = time.monotonic() + deadline
            while time.monotonic() < stop_at:
                bound = {}
                for name in names:
                    try:
                        pod = api.get_pod(name)
                    except KeyError:
                        break  # mid-eviction: its copy not created yet
                    node = (pod.get("spec") or {}).get("nodeName")
                    if not node:
                        break
                    cards = _pod_cards(api, name)
                    if len(cards) != GANG_CARDS or (
                            forbidden_card and
                            forbidden_card in [(node, c) for c in cards]):
                        break
                    bound[name] = node
                else:
                    return bound
                time.sleep(0.02)
            raise RuntimeError(
                f"gang did not (re)bind clean of the dead card in "
                f"{deadline}s (forbidden={forbidden_card}, "
                f"parked={repair.parked()})")

        first = placements(20.0)
        # the victim: a seeded choice among the allocated cards, injected
        # through the seeded fault injector
        allocated = sorted((first[name], card) for name in names
                           for card in _pod_cards(api, name))
        victim_node, victim_card = random.Random(seed).choice(allocated)
        chaos = DeviceChaos(backends, seed=seed)
        chaos.kill_chip(node=victim_node, chip_id=victim_card)
        t0 = time.monotonic()
        final = placements(deadline_s,
                           forbidden_card=(victim_node, victim_card))
        recovery_ms = (time.monotonic() - t0) * 1e3
        flat = _check_gang_cards(_bound_cards(api, names), len(names))
        if (victim_node, victim_card) in set(flat):
            raise RuntimeError(f"gang rebound onto the dead card: {flat}")
        for name in names:
            if not any(e.get("reason") == "CheckpointRequested"
                       for e in api.list_events(involved_name=name)):
                raise RuntimeError(
                    f"no CheckpointRequested event for {name}")
        if sched.resync_count:
            raise RuntimeError(f"watch relisted {sched.resync_count}x")
        doc = {"recovery_ms": round(recovery_ms, 1),
               "victim": {"node": victim_node, "chip": victim_card},
               "first_placement": first,
               "final_placement": final,
               "repairs": repair.repaired_total,
               "relists": sched.resync_count,
               "injected": [list(f[:3]) for f in chaos.injected],
               "fit_cache": _fit_cache_summary(),
               "batch": _batch_summary(),
               "data_plane": _data_plane_summary()}
        return doc
    finally:
        repair.stop()
        for adv in advs.values():
            adv.stop()
        sched.stop()


def run_ha_chaos_scenario(pods_before: int = 6, pods_mid: int = 3,
                          pods_after: int = 3, wal_dir: str | None = None,
                          lease_ttl_s: float = 0.6,
                          deadline_s: float = 30.0,
                          wire: str = "stream"):
    """Two optimistic replicas (shard leases, work stealing) over a
    WAL-backed HTTP server. Replica 0 is killed mid-stream (replica 1
    steals its shard at the lease's vacancy); then the server is torn down
    and recovered from its WAL on the same port. Every pod (a 2-member gang
    among them) must place exactly once, with no card leaked or held twice,
    and the surviving replica's watch must resume seq-exact. Raises on any
    violation; returns the accounting."""
    import shutil
    import tempfile

    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient, serve_api
    from kubegpu_tpu_torch.cluster.lease import ShardCoordinator
    from kubegpu_tpu_torch.cluster.wal import WriteAheadLog

    tmp = wal_dir or tempfile.mkdtemp(prefix="kgtpu-gpu-wal-")
    owns_tmp = wal_dir is None
    wal = WriteAheadLog(tmp, fsync=False, snapshot_every=40)
    server, url = serve_api(InMemoryAPIServer(), wal=wal)
    port = int(url.rsplit(":", 1)[1])
    admin = HTTPAPIClient(url, wire=wire)
    replicas: list = []
    submitted: list = []
    try:
        for i in range(4):
            name = f"host{i}"
            _create_host(admin, name)
            _, mgr, _ = _host_manager(i)
            DeviceAdvertiser(admin, mgr, name).advertise_once()

        def start_replica(shard):
            client = HTTPAPIClient(url, watch_batch_s=0.002,
                                   watch_kinds=("node", "pod", "pv", "pvc"),
                                   wire=wire)
            coord = ShardCoordinator(client, shard, 2, f"replica-{shard}",
                                     ttl_s=lease_ttl_s)
            sched = Scheduler(client, build_device_scheduler(),
                              bind_async=True, shard_owned=coord.owns,
                              name=f"sched-{shard}")
            coord.on_change = sched.queue.move_all_to_active
            coord.start(interval_s=lease_ttl_s / 4.0)
            sched.start()
            return client, coord, sched

        replicas.append(start_replica(0))
        replicas.append(start_replica(1))

        def submit(prefix, count):
            for i in range(count):
                name = f"{prefix}-{i}"
                pod = make_pod(name, 1)
                # a create is sent once (POST), so one racing the restart
                # retries here; a Conflict means an earlier try landed
                for attempt in range(50):
                    try:
                        admin.create_pod(pod)
                        break
                    except Conflict:
                        break
                    except Exception:
                        if attempt == 49:
                            raise
                        time.sleep(0.1)
                submitted.append(name)

        def wait_bound(deadline=deadline_s):
            end = time.monotonic() + deadline
            pending = list(submitted)
            while time.monotonic() < end:
                try:
                    pending = [n for n in submitted
                               if not (admin.get_pod(n).get("spec") or {})
                               .get("nodeName")]
                except Exception:
                    time.sleep(0.1)  # the server is restarting
                    continue
                if not pending:
                    return
                time.sleep(0.05)
            raise RuntimeError(f"pods failed to place: {pending}")

        # phase 1: both replicas place a stream, and a gang, which routes
        # whole to one shard by its gang id
        submit("ha-a", pods_before)
        for i in range(2):
            name = f"ha-gang-{i}"
            admin.create_pod(gang_pod(name, 55, 2, cards=2))
            submitted.append(name)
        wait_bound()

        # phase 2: replica 0 dies; its shard's lease lapses and replica 1
        # steals the work
        client0, coord0, sched0 = replicas[0]
        sched0.stop()
        coord0.stop()
        client0.close()
        replicas[0] = None
        submit("ha-b", pods_mid)
        wait_bound()

        # phase 3: the server crashes and recovers from its WAL on the same
        # port; the surviving replica's watch must resume seq-exact
        server.shutdown()
        wal = WriteAheadLog(tmp, fsync=False, snapshot_every=40)
        server, _ = serve_api(InMemoryAPIServer(), port=port, wal=wal)
        submit("ha-c", pods_after)
        wait_bound()

        client1 = replicas[1][0]
        cards = _bound_cards(admin, submitted)
        placed = set(cards)
        if placed != set(submitted):
            raise RuntimeError(f"unplaced pods: {set(submitted) - placed}")
        claims = [c for cs in cards.values() for c in cs]
        if len(claims) != len(set(claims)):
            dups = sorted(c for c in set(claims) if claims.count(c) > 1)
            raise RuntimeError(f"cards held twice: {dups}")
        if any(not cs for cs in cards.values()):
            raise RuntimeError("a bound pod carries no card allocation")
        if client1.relist_count != 0:
            raise RuntimeError(
                f"watch resume was not seq-exact across the server restart "
                f"({client1.relist_count} relist(s))")
        return {"placed": len(placed),
                "watch_relists": client1.relist_count,
                "wal_recovered_records": wal.recovered_records,
                "stolen_shards": sorted(replicas[1][1].owned_shards()),
                "ha": _ha_summary()}
    finally:
        for rep in replicas:
            if rep is None:
                continue  # replica 0, torn down in phase 2
            client, coord, sched = rep
            sched.stop()
            coord.stop()
            client.close()
        admin.close()
        server.shutdown()  # closes the WAL too
        if owns_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def tenant_pod(name: str, tenant: str, cards: int = 1) -> dict:
    """A tenant-labelled pod for the multi-tenant scenario."""
    pod = make_pod(name, cards)
    pod["metadata"].setdefault("labels", {})["kgtpu.io/tenant"] = tenant
    return pod


def run_tenant_flood_scenario(tenants: int = 3, churn_pods: int = 12,
                              flood_threads: int = 3,
                              flood_pace_s: float = 0.005,
                              p99_ratio_limit: float = 2.0,
                              deadline_s: float = 60.0,
                              wire: str = "stream",
                              proxies: int = 0,
                              api_rate_ratio_limit: float = 1.5):
    """One abusive tenant floods the priority-and-fairness front door while
    ``tenants`` well-behaved tenants churn 1-card pods, heartbeats flow, a
    lease renews and the lifecycle controller watches for stale nodes.
    Quiet first (no flood), then under the flood. Raises unless all of:

    * every well-behaved pod places, and their create-to-bound p99 holds
      within ``p99_ratio_limit`` of quiet;
    * no lease is lost (renewals ride the exempt system band);
    * no node goes Lost and nothing is evicted;
    * the system band rejected nothing;
    * the DRF gate engaged (the abuser parked) and the abuser's bound cards
      stayed at or below its fair share (plus one pod of slack);
    * the well-behaved churn finished before the deadline.

    With ``proxies`` > 0, shared-nothing watch-cache proxies
    (``cluster/proxy.py``), each with its own front door, stand in front
    of the server: tenants shard across them, the lease renews through
    one, and the abuser is a READ flood at one replica's mirror. Then the
    server's request rate under the flood must stay within
    ``api_rate_ratio_limit`` of quiet, and the fair-share checks (create
    flood mechanics) do not apply. Returns per-phase p99s, the flood's
    counts, the front door and quota summaries (and the proxy tier's)."""
    from kubegpu_tpu_torch.cluster.apf import (BAND_SYSTEM, BAND_WORKLOAD,
                                               APFDispatcher, BandConfig,
                                               TooManyRequests,
                                               pod_chip_request)
    from kubegpu_tpu_torch.cluster.chaos import TenantFlood
    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient, serve_api
    from kubegpu_tpu_torch.cluster.lease import Elector
    from kubegpu_tpu_torch.scheduler.lifecycle import NodeLifecycle
    from kubegpu_tpu_torch.scheduler.quota import (DRFQuotaGate,
                                                   node_resource_totals)

    api = InMemoryAPIServer()
    # a tight workload band: the flood queues and is shed there, while
    # system traffic passes the front door untouched
    workload_band = dict(seats=6, queues=16, queue_len=16,
                         queue_wait_s=0.5, hand=4)
    apf = APFDispatcher(bands={BAND_WORKLOAD: BandConfig(**workload_band)})
    server, url = serve_api(api, apf=apf)
    admin = HTTPAPIClient(url, wire=wire)
    advs: list = []
    closers: list = []
    replicas: list = []
    elector = lifecycle = sched = None
    try:
        if proxies > 0:
            from kubegpu_tpu_torch.cluster.proxy import WatchCacheProxy

            # each replica has its OWN front door: a flooding tenant
            # saturates the shard it reaches, nothing else
            replicas = [
                WatchCacheProxy(url, name=f"proxy{i}",
                                apf=APFDispatcher(bands={
                                    BAND_WORKLOAD:
                                        BandConfig(**workload_band)}))
                for i in range(proxies)]

        def shard_url(i: int) -> str:
            return replicas[i % len(replicas)].url if replicas else url

        for i in range(4):
            name = f"host{i}"
            _create_host(admin, name, pods=10000)
            _, mgr, _ = _host_manager(i)
            adv_client = HTTPAPIClient(url, wire=wire)
            closers.append(adv_client)
            adv = DeviceAdvertiser(adv_client, mgr, name)
            adv.start(interval_s=0.15, retry_s=0.05)
            advs.append(adv)

        gate = DRFQuotaGate(hungry_grace_s=2.0)
        sched_client = HTTPAPIClient(url, watch_batch_s=0.002,
                                     watch_kinds=("node", "pod", "pv",
                                                  "pvc", "quota"),
                                     wire=wire)
        closers.append(sched_client)
        sched = Scheduler(sched_client, build_device_scheduler(),
                          bind_async=True, quota=gate)
        sched.start()

        life_client = HTTPAPIClient(url, wire=wire)
        closers.append(life_client)
        lifecycle = NodeLifecycle(life_client, stale_after_s=0.6,
                                  lost_after_s=2.0)
        lifecycle.start(interval_s=0.1)

        # fronted, the renewals go THROUGH a proxy: the forwarded path must
        # keep them on the exempt system band at both hops
        lease_client = HTTPAPIClient(shard_url(1), wire=wire)
        closers.append(lease_client)
        elector = Elector(lease_client.acquire_lease, "flood-lease",
                          "survivor", ttl_s=0.6)
        elector.start(interval_s=0.15)

        # bound and deleted, straight off the admin watch
        bound_seen: dict = {}
        deleted_seen: dict = {}

        def track(kind, event, obj):
            if kind != "pod":
                return
            pname = obj["metadata"]["name"]
            if event in ("added", "modified") and \
                    (obj.get("spec") or {}).get("nodeName"):
                ev = bound_seen.get(pname)
                if ev is not None:
                    ev.set()
            elif event == "deleted":
                ev = deleted_seen.get(pname)
                if ev is not None:
                    ev.set()

        admin.add_watcher(track)
        tenant_names = [f"tenant-{i}" for i in range(tenants)]

        def churn(idx, tenant, phase, latencies, errors):
            """One well-behaved tenant: create, bound, delete, in turn,
            honouring the front door's retry-after. The latency is the
            whole create-to-bound span, throttle waits included. Fronted,
            the tenant talks to its shard's proxy."""
            client = HTTPAPIClient(shard_url(idx), wire=wire)
            try:
                for k in range(churn_pods):
                    pname = f"{tenant}-{phase}-{k}"
                    bound_seen[pname] = threading.Event()
                    t0 = time.perf_counter()
                    for _attempt in range(200):
                        try:
                            client.create_pod(tenant_pod(pname, tenant))
                            break
                        except TooManyRequests as e:
                            time.sleep(max(0.01, e.retry_after_s))
                    else:
                        errors.append(f"{pname}: create never admitted")
                        return
                    if not bound_seen[pname].wait(deadline_s):
                        errors.append(f"{pname}: never bound")
                        return
                    latencies.append(time.perf_counter() - t0)
                    deleted_seen[pname] = threading.Event()
                    for _attempt in range(200):
                        try:
                            client.delete_pod(pname)
                            break
                        except TooManyRequests as e:
                            # the DELETE's own retries ran out under the
                            # flood: go on being a good citizen
                            time.sleep(max(0.01, e.retry_after_s))
                    else:
                        errors.append(f"{pname}: delete never admitted")
                        return
                    deleted_seen[pname].wait(10.0)
            finally:
                client.close()

        def run_phase(phase):
            latencies: list = []
            errors: list = []
            threads = [threading.Thread(target=churn,
                                        args=(i, t, phase, latencies,
                                              errors),
                                        daemon=True)
                       for i, t in enumerate(tenant_names)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=deadline_s * 2)
            hung = sum(1 for t in threads if t.is_alive())
            if hung:
                # a timed-out join is not success: a wedged churn thread
                # must not slip past the checks with part of its latencies
                errors.append(f"{hung} churn thread(s) still running "
                              f"after {deadline_s * 2:.0f}s")
            if errors:
                raise RuntimeError(
                    f"{phase} churn failed: {errors[:4]} "
                    f"(front door so far: {_apf_summary()})")
            return latencies

        def p99(lat):
            s = sorted(lat)
            return s[int(0.99 * (len(s) - 1))] * 1e3

        # the server's request rate a phase: fronted, it must stay flat
        # under the flood (the read flood ends at a replica's mirror)
        apiserver_reqs = metrics.API_REQUESTS.labels("apiserver")

        quiet_reqs0 = apiserver_reqs.value
        quiet_t0 = time.perf_counter()
        quiet_lat = run_phase("quiet")
        quiet_req_rate = (apiserver_reqs.value - quiet_reqs0) / \
            max(time.perf_counter() - quiet_t0, 1e-9)

        lease_transitions_before = elector.transitions
        node_lost_before = metrics.NODE_LOST.value
        evicted_before = lifecycle.evicted_total
        quota_parked_before = metrics.QUOTA_PARKED.value

        # fronted: a READ flood at ONE replica; direct: a create flood at
        # the server's own front door
        flood = TenantFlood(
            lambda: HTTPAPIClient(shard_url(0), wire=wire),
            tenant="abuser", threads=flood_threads, pace_s=flood_pace_s,
            mode="read" if replicas else "mutate").start()
        flood_reqs0 = apiserver_reqs.value
        flood_t0 = time.perf_counter()
        try:
            flood_lat = run_phase("flood")
        finally:
            flood_counts = flood.stop()
        flood_req_rate = (apiserver_reqs.value - flood_reqs0) / \
            max(time.perf_counter() - flood_t0, 1e-9)

        quiet_p99 = p99(quiet_lat)
        flood_p99 = p99(flood_lat)
        ratio = flood_p99 / quiet_p99 if quiet_p99 > 0 else 0.0

        # the abuser's bound cards against its DRF share (tenants + 1
        # actors, one pod of slack for an admit racing the last release),
        # the capacity from the nodes as advertised
        abuser_bound = sum(
            pod_chip_request(p) for p in admin.list_pods(bound=True)
            if ((p["metadata"].get("labels") or {})
                .get("kgtpu.io/tenant")) == "abuser")
        total_cards = sum(node_resource_totals(n)["chips"]
                          for n in admin.list_nodes())
        fair_cards = total_cards / (tenants + 1)

        front_door = _apf_summary()
        failures = []
        if ratio > p99_ratio_limit:
            failures.append(
                f"well-behaved p99 degraded {ratio:.2f}x under flood "
                f"({quiet_p99:.1f} -> {flood_p99:.1f} ms, limit "
                f"{p99_ratio_limit}x)")
        if elector.transitions != lease_transitions_before:
            failures.append(
                f"lease lost during flood "
                f"({elector.transitions - lease_transitions_before} "
                f"transition(s))")
        if metrics.NODE_LOST.value != node_lost_before or \
                lifecycle.evicted_total != evicted_before:
            failures.append("heartbeat-driven node loss/eviction "
                            "during flood")
        if front_door["apf_rejects_total"].get(BAND_SYSTEM, 0):
            failures.append("system band traffic was rejected")
        if sched_client.relist_count != 0:
            failures.append(
                f"scheduler watch lost its resume window under flood "
                f"({sched_client.relist_count} relist(s))")
        quota_parked_during = \
            metrics.QUOTA_PARKED.value - quota_parked_before
        if replicas:
            # read flood: nothing is created, so the invariant moves to the
            # hop: the server's rate stays flat while the replica absorbs
            if flood_counts["accepted"] + flood_counts["rejected"] == 0:
                failures.append("read flood never engaged the proxy tier")
            rate_ratio = flood_req_rate / quiet_req_rate \
                if quiet_req_rate > 0 else 0.0
            if rate_ratio > api_rate_ratio_limit:
                failures.append(
                    f"apiserver request rate rose {rate_ratio:.2f}x "
                    f"under flood ({quiet_req_rate:.0f} -> "
                    f"{flood_req_rate:.0f} req/s, limit "
                    f"{api_rate_ratio_limit}x): the flood leaked "
                    f"through the proxy tier")
        else:
            if gate.parked_count() == 0 and quota_parked_during == 0:
                # the delta, not the process-wide counter: an earlier run
                # in this process must not hide a gate that never engaged
                failures.append("DRF gate never engaged against the flood")
            if abuser_bound > fair_cards + 1:
                failures.append(
                    f"abuser bound {abuser_bound} cards, over its fair "
                    f"share of {fair_cards:.1f}")
        if failures:
            raise RuntimeError("tenant-flood invariants violated: "
                               + "; ".join(failures))
        out = {"wellbehaved_quiet_p99_ms": round(quiet_p99, 2),
               "wellbehaved_flood_p99_ms": round(flood_p99, 2),
               "p99_ratio": round(ratio, 2),
               "flood": flood_counts,
               "abuser_bound_chips": abuser_bound,
               "abuser_fair_chips": round(fair_cards, 1),
               "quota_parked": quota_parked_during,
               "front_door": front_door,
               "lease_transitions": elector.transitions,
               "watch_relists": sched_client.relist_count,
               "evictions": lifecycle.evicted_total,
               "apiserver_quiet_req_per_s": round(quiet_req_rate, 1),
               "apiserver_flood_req_per_s": round(flood_req_rate, 1)}
        if replicas:
            out["proxies"] = _proxy_summary(replicas)
        return out
    finally:
        if elector is not None:
            elector.stop()
        if lifecycle is not None:
            lifecycle.stop()
        for adv in advs:
            adv.stop()
        if sched is not None:
            sched.stop()
        for closer in closers:
            closer.close()
        admin.close()
        for replica in replicas:
            replica.stop()
        server.shutdown()


# ---- the binary ------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    from kubegpu_tpu_torch.cmd import common

    p = argparse.ArgumentParser(
        prog="kgtpu-gpu-simulate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hosts", type=int, default=4,
                   help="fake HGX H100 hosts (eight cards each)")
    p.add_argument("--schedulers", type=int, default=1,
                   help="optimistic scheduler replicas over one API server "
                        "(shard leases and conflict commits)")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--chaos", nargs="?", const="node-loss",
                   choices=("node-loss", "chip-kill"), default=None,
                   help="a device-failure recovery scenario: node-loss (the "
                        "default when the flag is bare: a node agent killed "
                        "mid-gang under the seeded chaos transport) or "
                        "chip-kill (an allocated card fails; the repair "
                        "controller checkpoints and moves the gang)")
    p.add_argument("--chaos-ha", action="store_true",
                   help="the HA scenario: a scheduler replica killed and the "
                        "WAL-backed API server restarted under 2 replicas")
    p.add_argument("--chaos-tenant-flood", action="store_true",
                   help="the multi-tenant overload scenario: one tenant "
                        "floods the priority-and-fairness front door while "
                        "well-behaved tenants churn; holds their p99, every "
                        "lease and every node")
    p.add_argument("--proxies", type=int, default=0,
                   help="front the API server with N watch-cache proxy "
                        "replicas, each with its own front door; with "
                        "--chaos-tenant-flood the abuser is a read flood at "
                        "one replica and the server's request rate must "
                        "stay flat")
    p.add_argument("--seed", type=int, default=0,
                   help="the chaos scenarios' seed")
    p.add_argument("--wire", choices=("stream", "json"), default="stream",
                   help="the control-plane wire of the HTTP scenarios")
    p.add_argument("--trace-out", default=None,
                   help="write the run's span ring as Chrome trace-event "
                        "JSON (open in Perfetto)")
    common.add_observability_flags(p)
    return p


def main(argv=None) -> int:
    from kubegpu_tpu_torch.cmd import common

    args = parser().parse_args(argv)
    # the sampler and the metrics time-series cover the whole run; a
    # scenario that fails is when the trace matters most, so both writers
    # run on every exit path
    stop_obs = common.start_observability(args)
    try:
        return _run_simulation(args)
    finally:
        if args.trace_out:
            n = obs.write_trace(args.trace_out)
            # stderr: --json readers parse stdout as one document
            print(f"trace: {n} spans -> {args.trace_out}",
                  file=sys.stderr, flush=True)
        stop_obs()


def _emit(doc: dict, args, text: str) -> int:
    print(json.dumps(doc, indent=2) if args.json else text, flush=True)
    return 0


def _run_simulation(args) -> int:
    if args.chaos == "chip-kill":
        r = run_chip_kill_scenario(seed=args.seed)
        return _emit(r, args,
                     f"card {r['victim']['chip']} on {r['victim']['node']} "
                     f"killed mid-gang; checkpointed and moved in "
                     f"{r['recovery_ms']:.0f} ms ({r['first_placement']} -> "
                     f"{r['final_placement']})")
    if args.chaos:
        r = run_chaos_scenario(seed=args.seed)
        return _emit(r, args,
                     f"node {r['victim']} killed mid-gang; recovered in "
                     f"{r['recovery_ms']:.0f} ms ({r['first_placement']} -> "
                     f"{r['final_placement']})")
    if args.chaos_tenant_flood:
        r = run_tenant_flood_scenario(wire=args.wire, proxies=args.proxies)
        r["wire_protocol"] = args.wire
        if args.proxies:
            text = (f"tenant flood ({args.proxies} proxies): well-behaved "
                    f"p99 {r['wellbehaved_quiet_p99_ms']} -> "
                    f"{r['wellbehaved_flood_p99_ms']} ms ({r['p99_ratio']}x) "
                    f"while the abuser's read flood "
                    f"({r['flood']['accepted']} served / "
                    f"{r['flood']['rejected']} shed) was absorbed at the "
                    f"proxy tier: apiserver "
                    f"{r['apiserver_quiet_req_per_s']} -> "
                    f"{r['apiserver_flood_req_per_s']} req/s; 0 lease "
                    f"losses, 0 evictions; proxies={r['proxies']}")
        else:
            text = (f"tenant flood: well-behaved p99 "
                    f"{r['wellbehaved_quiet_p99_ms']} -> "
                    f"{r['wellbehaved_flood_p99_ms']} ms ({r['p99_ratio']}x) "
                    f"while the abuser had {r['flood']['accepted']} creates "
                    f"admitted / {r['flood']['rejected']} shed, "
                    f"{r['quota_parked']} pods quota-parked, abuser bound "
                    f"{r['abuser_bound_chips']} of "
                    f"{r['abuser_fair_chips']} fair cards; 0 lease losses, "
                    f"0 evictions")
        return _emit(r, args, text)
    if args.chaos_ha:
        r = run_ha_chaos_scenario(wire=args.wire)
        r["wire_protocol"] = args.wire
        return _emit(r, args,
                     f"HA chaos: {r['placed']} pods placed exactly once "
                     f"across a scheduler kill and an apiserver restart "
                     f"({r['ha']['sched_conflicts_total']} conflicts "
                     f"arbitrated, {r['watch_relists']} relists, "
                     f"{r['wal_recovered_records']} WAL records replayed)")
    return _run_default(args)


def _run_default(args) -> int:
    from kubegpu_tpu_torch.cluster.lease import ShardCoordinator

    api = InMemoryAPIServer()
    hooks = {}
    for i in range(args.hosts):
        name = f"host{i}"
        _create_host(api, name)
        _, mgr, gpu = _host_manager(i)
        DeviceAdvertiser(api, mgr, name).advertise_once()
        hooks[name] = GPURuntimeHook(api, gpu)

    # the pipelined binder, as in the binary; with --schedulers N, N
    # replicas share the server, each owning a pod-name-hash shard under a
    # lease, gangs routed whole by gang id, conflicts arbitrated there
    n_sched = max(1, args.schedulers)
    scheds = []
    coords = []
    for shard in range(n_sched):
        owns = None
        if n_sched > 1:
            coord = ShardCoordinator(api, shard, n_sched, f"sim-{shard}",
                                     ttl_s=5.0)
            coords.append(coord)
            owns = coord.owns
        s = Scheduler(api, build_device_scheduler(), bind_async=True,
                      shard_owned=owns, name=f"sched-{shard}")
        if n_sched > 1:
            coords[shard].on_change = s.queue.move_all_to_active
            coords[shard].tick()
        scheds.append(s)

    api.create_pod(make_pod("plain-1card", 1))
    api.create_pod(make_pod("memory-floored", 1, memory=MEMORY_FLOOR))
    api.create_pod(make_pod("auto-4card", 4, pod_requests={
        grammar.GPU_TOPOLOGY_GENERATION: 1}))
    # a pod bound to a volume whose node affinity pins it to host1: the
    # placement is visibly steered and the claim turns Bound when placed
    pinned_host = f"host{min(1, args.hosts - 1)}"
    api.create_pvc({"metadata": {"name": "demo-claim"},
                    "spec": {"resources": {"requests": {"storage": "10Gi"}},
                             "storageClassName": ""}})
    api.create_pv({"metadata": {"name": "demo-vol"},
                   "spec": {"capacity": {"storage": "10Gi"},
                            "storageClassName": "",
                            "nodeAffinity": {"required": {
                                "nodeSelectorTerms": [{"matchExpressions": [
                                    {"key": "kubernetes.io/hostname",
                                     "operator": "In",
                                     "values": [pinned_host]}]}]}}}})
    vol_pod = make_pod("vol-1card", 1)
    vol_pod["spec"]["volumes"] = [
        {"name": "data", "persistentVolumeClaim": {"claimName": "demo-claim"}}]
    api.create_pod(vol_pod)
    gang_n = min(2, args.hosts)
    for i in range(gang_n):
        api.create_pod(gang_pod(f"gang-{i}", 1, gang_n))
    if n_sched == 1:
        scheds[0].run_until_idle()
    else:
        # the replicas' cycles in turn until the cluster settles: each
        # drains its own shard, and one that sees another's assume loses
        # that conflict and requeues
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            for c in coords:
                c.tick()
            for s in scheds:
                s.run_until_idle()
            if all((p.get("spec") or {}).get("nodeName")
                   for p in api.list_pods()):
                break
            time.sleep(0.02)

    rows = []
    for pod in api.list_pods():
        name = pod["metadata"]["name"]
        node = pod.get("spec", {}).get("nodeName")
        env = {}
        if node:
            cfg = hooks[node].create_container(name, "main", {})
            env = {e["key"]: e["value"] for e in cfg.get("envs", [])}
        row = {"pod": name, "node": node or "<pending>",
               "cards": env.get("CUDA_VISIBLE_DEVICES", ""),
               "rank": (f"{env['RANK']}/{env['WORLD_SIZE']}"
                        if "RANK" in env else "")}
        if name == "vol-1card":
            row["volume"] = api.get_pvc("demo-claim")["spec"] \
                .get("volumeName", "<unbound>")
        rows.append(row)

    fit_cache = _fit_cache_summary()
    data_plane = _data_plane_summary()
    batch = _batch_summary()
    doc = {"placements": rows, "fit_cache": fit_cache,
           "batch": batch, "data_plane": data_plane}
    if n_sched > 1:
        doc["ha"] = {"schedulers": n_sched, **_ha_summary()}
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        # a card as the first two groups of its UUID (the fakes' host and
        # index); the JSON document has CUDA_VISIBLE_DEVICES whole
        short = {r["pod"]: ",".join("-".join(u.split("-")[:3])
                                    for u in r["cards"].split(",") if u)
                 for r in rows}
        width = max(len(r["pod"]) for r in rows) + 2
        cards_w = max(len(c) for c in short.values()) + 2
        print(f"{'POD':<{width}}{'NODE':<11}{'CARDS':<{cards_w}}"
              f"{'RANK':<6}VOLUME")
        for r in rows:
            print(f"{r['pod']:<{width}}{r['node']:<11}"
                  f"{short[r['pod']]:<{cards_w}}{r['rank']:<6}"
                  f"{r.get('volume', '')}")
        print(f"fit cache: {fit_cache['hits']} hits / "
              f"{fit_cache['misses']} misses / "
              f"{fit_cache['invalidations']} invalidations")
        print(f"batch: {batch['cycles']} cycles, "
              f"{batch['pods_per_cycle_mean']} pods/cycle, "
              f"{batch['classes_per_cycle_mean']} classes/cycle, "
              f"{batch['throughput_pods_per_s']} pods/s bound")
        print(f"data plane: {data_plane['bind_count']} binds "
              f"(p50 {data_plane['bind_p50_ms']} ms, "
              f"{data_plane['bind_inflight']} in flight); last watch "
              f"batch {data_plane['watch_batch_size']}, "
              f"{data_plane['watch_coalesced_total']} events coalesced")
        if n_sched > 1:
            ha = doc["ha"]
            print(f"ha: {ha['schedulers']} replicas, "
                  f"{ha['sched_conflicts_total']} conflicts arbitrated, "
                  f"{ha['lease_transitions_total']} lease transitions")
    for s in scheds:
        s.stop()
    for coord in coords:
        coord.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
