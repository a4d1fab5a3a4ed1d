"""``kgtpu-gpu-scheduler``: the port's scheduling engine as a binary.

The port's copy of ``kubegpu_tpu/cmd/scheduler_main.py`` (the reference's
`kube-scheduler/cmd/scheduler.go` and `cmd/app/server.go`): the engine of
``scheduler/core.py`` with `GPUScheduler` compiled in
(``registry.build_device_scheduler``), more plugins from
``--scheduler-plugins-dir``, over the port's client of the API server
(``cluster/httpapi.py``, ``--wire stream`` by default, negotiated down to
JSON against a server without the stream wire), watching nodes, pods,
volumes, claims and quotas. ``--config`` (JSON or YAML) fills in every
flag not given on the command line, and its ``policy``, ``policyFile`` or
``algorithmProvider`` recompose the predicates and priorities; its
``extenders`` and the policy's (``scheduler/extender.py``) are consulted
after the engine's own filter and score, and may own the binding.

Three shapes:

solo (the default)
    One engine schedules every pod.

``--leader-elect``
    Active/standby: replicas contend for one lease; only its holder
    schedules, and a replica that loses the lease stands by again.

``--replicas N --shard I`` (N above 1)
    Active/active: N replicas split the pods by a hash of the pod's name
    (a gang's by its gang id, ``cluster/lease.shard_of``), each holding
    its shard's lease through a `ShardCoordinator` and taking over the
    work of a shard whose lease lapses. Replicas commit through the API
    server's arbiter, which refuses a GPU card claimed twice
    (``kgtpu-gpu-apiserver``); the loser forgets and requeues its pod.

``--node-grace-s G`` (above 0) runs the node lifecycle controller
(``scheduler/lifecycle.py``) beside any shape, singleton-elected on its
own lease (``LIFECYCLE_LEASE``): a node whose heartbeat stands still for
``--node-stale-s`` (default G / 3) is Stale, for G Lost, and its pods are
evicted and requeued. ``--node-stale-s`` alone starts no controller.
``--repair`` runs the repair controller (``scheduler/repair.py``) the same
way on ``REPAIR_LEASE``: a bound pod (a whole gang) on a card its node
reports degraded is checkpoint-signalled, evicted and requeued.
``--tenant-quota`` puts the dominant-resource fair-share gate
(``scheduler/quota.py``) in front of every scheduling cycle, weighted by
the config's ``tenantWeights`` ({tenant: weight}).

SIGTERM and SIGINT stop it cleanly (exit 0).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from kubegpu_tpu_torch import obs
from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
from kubegpu_tpu_torch.cluster.lease import (LIFECYCLE_LEASE, REPAIR_LEASE,
                                             Elector, ShardCoordinator)
from kubegpu_tpu_torch.cmd import common
from kubegpu_tpu_torch.scheduler import factory
from kubegpu_tpu_torch.scheduler.core import Scheduler
from kubegpu_tpu_torch.scheduler.extender import load_extenders
from kubegpu_tpu_torch.scheduler.lifecycle import NodeLifecycle
from kubegpu_tpu_torch.scheduler.quota import DRFQuotaGate
from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler
from kubegpu_tpu_torch.scheduler.repair import RepairController

LEASE_NAME = "kgtpu-scheduler"
# what the engine consumes: Event records never ride this watch
WATCH_KINDS = ("node", "pod", "pv", "pvc", "quota")
# the keys the config file may set: the JAX binary's flags, the health
# port and flight directory, and the tenants' fair-share weights
# (``tenantWeights``, read by `build_scheduler`)
CONFIG_KEYS = ("api", "wire", "parallelism", "lease_ttl", "node_grace_s",
               "node_stale_s", "bind_workers", "watch_batch_ms", "replicas",
               "shard", "healthz_port", "flight_dir", "tenantWeights")


def build_scheduler(client, args, config: dict | None = None,
                    shard_owned=None, name: str | None = None) -> Scheduler:
    """The engine over ``client``: `GPUScheduler` compiled in, the plugins
    of ``--scheduler-plugins-dir``, the algorithm and extenders of
    ``config``, and with ``--tenant-quota`` the fair-share gate weighted by
    its ``tenantWeights``."""
    config = config or {}
    ds = build_device_scheduler()
    if args.scheduler_plugins_dir:
        ds.add_devices_from_plugins(args.scheduler_plugins_dir)
    # a Policy document recomposes the predicates and priorities by name,
    # inline under "policy" or in the file "policyFile" names
    policy = config.get("policy")
    if policy is None and config.get("policyFile"):
        policy = common.load_config(config["policyFile"])
    if policy:
        algorithm = factory.algorithm_from_policy(policy)
    elif config.get("algorithmProvider"):
        algorithm = factory.algorithm_provider(config["algorithmProvider"])
    else:
        algorithm = None
    # extenders declared inside the policy join the top-level ones
    # (upstream puts them in the policy)
    extenders = load_extenders(config)
    if isinstance(policy, dict) and policy.get("extenders"):
        extenders += load_extenders({"extenders": policy["extenders"]})
    quota = DRFQuotaGate(weights=config.get("tenantWeights")) \
        if args.tenant_quota else None
    sched = Scheduler(client, ds, bind_async=bool(args.bind_async),
                      parallelism=args.parallelism, extenders=extenders,
                      priority_weights=config.get("priorityWeights"),
                      algorithm=algorithm, bind_workers=args.bind_workers,
                      shard_owned=shard_owned, name=name, quota=quota)
    sched.preemption_enabled = not args.disable_preemption
    return sched


def start_lifecycle_elector(client, args, holder: str) -> Elector | None:
    """The node lifecycle controller, gated on ``--node-grace-s`` and
    singleton-elected on its own lease: exactly one replica runs evictions
    (two controllers would race the requeues), and a dead holder's
    successor takes over, whichever scheduling shape runs."""
    if not args.node_grace_s or args.node_grace_s <= 0:
        return None
    stale = args.node_stale_s if args.node_stale_s > 0 \
        else args.node_grace_s / 3.0
    controller = NodeLifecycle(client, stale_after_s=stale,
                               lost_after_s=args.node_grace_s)
    elector = Elector(client.acquire_lease, LIFECYCLE_LEASE, holder,
                      args.lease_ttl, on_acquire=controller.start,
                      on_lose=controller.stop)
    elector.start()
    return elector


def start_repair_elector(client, args, holder: str) -> Elector | None:
    """The repair controller, gated on ``--repair`` and singleton-elected
    on its own lease, as the lifecycle controller is: two controllers
    planning the same gang's migration would evict it twice."""
    if not args.repair:
        return None
    controller = RepairController(client)
    elector = Elector(client.acquire_lease, REPAIR_LEASE, holder,
                      args.lease_ttl, on_acquire=controller.start,
                      on_lose=controller.stop)
    elector.start()
    return elector


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kgtpu-gpu-scheduler", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--api", default="http://127.0.0.1:8070")
    p.add_argument("--wire", choices=("stream", "json"), default="stream",
                   help="control-plane wire: framed binary requests with "
                        "server-pushed watch batches (default), or the "
                        "JSON long poll; stream negotiates down to json "
                        "against a server without it")
    p.add_argument("--parallelism", type=int, default=16,
                   help="fit-pool width")
    p.add_argument("--bind-async", action="store_true",
                   help="pipelined binder: the cycle stops at assume and a "
                        "worker pool overlaps the bind round trips")
    p.add_argument("--bind-workers", type=int, default=4,
                   help="bind worker pool width (with --bind-async)")
    p.add_argument("--watch-batch-ms", type=float, default=0.0,
                   help="the server's linger per watch window: fuller, "
                        "coalesced batches for a later first event")
    p.add_argument("--disable-preemption", action="store_true")
    p.add_argument("--leader-elect", action="store_true",
                   help="active/standby: only the lease's holder schedules")
    p.add_argument("--replicas", type=int, default=1,
                   help="active/active replicas sharding the queue (with "
                        "--shard); they commit through the API server's "
                        "arbiter")
    p.add_argument("--shard", type=int, default=0,
                   help="this replica's shard, 0 to --replicas - 1")
    p.add_argument("--lease-ttl", type=float, default=15.0,
                   help="seconds a lease lives unrenewed; renewed every "
                        "third of it")
    p.add_argument("--node-grace-s", type=float, default=0.0,
                   help="node lifecycle controller: seconds a node's "
                        "heartbeat may stand still before the node is Lost "
                        "and its pods are evicted and requeued; 0 disables")
    p.add_argument("--node-stale-s", type=float, default=0.0,
                   help="seconds to Stale (observational); default "
                        "--node-grace-s / 3")
    p.add_argument("--tenant-quota", action="store_true",
                   help="dominant-resource fair-share card quotas across "
                        "tenants (pods labelled kgtpu.io/tenant): a tenant "
                        "over its share parks with a typed QuotaExceeded "
                        "reason at pop time and is requeued when cards "
                        "free up; weights from the config's tenantWeights")
    p.add_argument("--repair", action="store_true",
                   help="repair controller: a pod (a whole gang) on a card "
                        "its node reports degraded is checkpoint-signalled,"
                        " evicted and requeued, or parked with a typed "
                        "reason when nothing could take it; singleton-"
                        "elected on its own lease")
    p.add_argument("--healthz-port", type=int, default=0,
                   help="/healthz, /metrics, /metrics/history, "
                        "/debug/traces, /debug/pod/<name> and "
                        "/debug/profile on loopback; 0 disables")
    p.add_argument("--flight-dir", default=None,
                   help="directory for the flight recorder's dumps "
                        "(internal error, conflict streak, lease lost); "
                        "defaults to $KGTPU_FLIGHT_DIR, unset disables")
    p.add_argument("--scheduler-plugins-dir", default=None,
                   help="load more device-scheduler plugins (*.py "
                        "exporting create_device_scheduler_plugin)")
    p.add_argument("--config", default=None,
                   help="JSON/YAML file; flags given on the command line "
                        "win")
    common.add_observability_flags(p)
    return p


def parse_args(argv=None) -> tuple:
    """``(args, config)``: the command line over the config file over the
    defaults."""
    p = parser()
    args = p.parse_args(argv)
    config = common.load_config(args.config)
    common.merge_flags(p, argv, args, config, CONFIG_KEYS)
    return args, config


def main(argv=None) -> int:
    # a latency-sensitive loop sharing its process with the informer,
    # binder and fit-pool threads: the default 5 ms switch interval lets
    # any of them stall a cycle for milliseconds
    sys.setswitchinterval(0.0005)
    args, config = parse_args(argv)
    sharded = (args.replicas or 1) > 1
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    # started before any lock of the client or engine exists, so the lock
    # probe wraps them all
    stop_obs = common.start_observability(args)
    obs.RECORDER.proc = f"sched-{args.shard % args.replicas}" if sharded \
        else "scheduler"
    if args.flight_dir:
        obs.FLIGHT.configure(args.flight_dir)
    client = HTTPAPIClient(args.api, watch_batch_s=args.watch_batch_ms / 1e3,
                           watch_kinds=WATCH_KINDS, wire=args.wire)
    health = common.serve_health(args.healthz_port, extra_status=lambda: True)
    holder = f"{os.uname().nodename}-{os.getpid()}"
    lifecycle = start_lifecycle_elector(client, args, holder)
    repair = start_repair_elector(client, args, holder)
    try:
        if sharded:
            run_sharded(client, args, config, holder, stop)
        elif not args.leader_elect:
            sched = build_scheduler(client, args, config)
            sched.start()
            print(f"scheduler running against {args.api}", flush=True)
            stop.wait()
            sched.stop()
        else:
            run_leader_elected(client, args, config, holder, stop)
    finally:
        for elector, lease in ((lifecycle, LIFECYCLE_LEASE),
                               (repair, REPAIR_LEASE)):
            if elector is None:
                continue
            # demotes: the controller's loop joins and its parked
            # requeues get a last flush
            elector.stop()
            try:
                client.release_lease(lease, holder)
            except Exception:  # analysis: disable=no-swallowed-exceptions -- shutdown, once a lease: an unreleased lease only makes the successor wait out its TTL, the lease's own fallback (the reference's binary holds no such leases at exit)
                pass
        stop_obs()
        client.close()
        if health is not None:
            health.shutdown()
            health.server_close()
    return 0


def run_sharded(client, args, config: dict, holder: str,
                stop: threading.Event) -> None:
    """Active/active: the coordinator first (the engine's pop filter reads
    its ownership), then the engine, whose queue the coordinator wakes on
    an ownership change so a taken-over shard's pods are tried at once."""
    shard = args.shard % args.replicas
    coord = ShardCoordinator(client, shard, args.replicas, holder,
                             ttl_s=args.lease_ttl)
    sched = build_scheduler(client, args, config, shard_owned=coord.owns,
                            name=f"sched-{shard}")
    coord.on_change = sched.queue.move_all_to_active
    coord.start()
    sched.start()
    print(f"scheduler replica {shard}/{args.replicas} ({holder}) running "
          f"against {args.api}", flush=True)
    stop.wait()
    # releases the shard's lease: a peer takes the work without waiting
    # out the TTL
    coord.stop()
    sched.stop()


def run_leader_elected(client, args, config: dict, holder: str,
                       stop: threading.Event) -> None:
    """Active/standby through `Elector`: promote on acquiring the lease,
    renew every third of the TTL, demote on a denial or once the lease
    could have lapsed (a transport error within the TTL keeps the lead)."""
    print(f"scheduler candidate {holder} (leader election on)", flush=True)
    state: dict = {"sched": None}

    def promote():
        state["sched"] = build_scheduler(client, args, config)
        state["sched"].start()
        print(f"{holder} became leader", flush=True)

    def demote():
        sched, state["sched"] = state["sched"], None
        if sched is not None:
            sched.stop()
        print(f"{holder} lost the lease, standing by", flush=True)

    elector = Elector(client.acquire_lease, LEASE_NAME, holder,
                      args.lease_ttl, on_acquire=promote, on_lose=demote)
    while not stop.is_set():
        elector.tick()
        stop.wait(args.lease_ttl / 3.0)
    elector.stop()          # demotes, stopping the engine, when leading
    try:
        client.release_lease(LEASE_NAME, holder)
    except Exception:
        # the standby then waits out the TTL
        pass


if __name__ == "__main__":
    raise SystemExit(main())
