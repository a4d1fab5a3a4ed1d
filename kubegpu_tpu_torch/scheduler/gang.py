"""Multi-node gang scheduling for NVIDIA cards: place a pod-set
all-or-nothing, each member's cards on one host.

The port's copy of ``kubegpu_tpu/scheduler/gang.py``. A TPU slice spans
hosts, so the JAX planner searches the cluster for one ICI-contiguous
block; hosts advertise no links between each other's cards, so what stays
here is the host-aligned split: members are taken largest first, and each
goes to the host where the plugin's own per-host fit leaves the fewest
free cards (`GangPlanner.plan`). The gang layer only *decides*, emitting
pinned allocations per pod (exact card paths, identity allocate_from);
the normal assume/bind path then revalidates and commits them
all-or-nothing. A gang that does not fit may preempt: in place of the
JAX planner's cheapest contiguous block, `GangPlanner.plan_preemption`
ranks sets of lower-priority pod-sets by eviction cost and plans the gang
on hosts where a set's cards are released.

Gang membership rides in pod-level annotation requests, under the JAX
package's keys so both engines read one wire:

- ``alpha.tpu/gang``:       gang id (int-encoded name hash or index —
                            ResourceList values are ints on the wire)
- ``alpha.tpu/gang-size``:  number of pods in the gang
"""

from __future__ import annotations

from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.utils import sorted_keys

RESOURCE_GANG = grammar.RESOURCE_GANG
RESOURCE_GANG_SIZE = grammar.RESOURCE_GANG_SIZE

# Per-pod process contract the scheduler writes alongside the pinned
# allocation: one JSON blob {gang, rank, count, coordinator_node,
# coordinator_port}. The runtime hook (``runtime/hook.py``) turns it into
# torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK env that
# `workload.spmd.distributed_init_from_env` consumes — the wire protocol
# that lets N scheduled pods form ONE torch.distributed group.
GANG_PROCESS_ANNOTATION = "pod.alpha/GangProcess"
GANG_PORT_BASE = 28000
GANG_PORT_SPAN = 2048


def gang_coordinator_port(gang: int, used: set | frozenset = frozenset()) -> int:
    """Deterministic per-gang coordinator port, skipping ``used`` ports.

    Starts at ``BASE + gang % SPAN`` and linearly probes: two live gangs
    whose ids are congruent mod SPAN (or a port already claimed on the
    coordinator host) must not collide — a second coordinator on the
    same port would either fail to bind or absorb the other gang's
    workers with a mismatched process count."""
    start = int(gang) % GANG_PORT_SPAN
    for i in range(GANG_PORT_SPAN):
        port = GANG_PORT_BASE + (start + i) % GANG_PORT_SPAN
        if port not in used:
            return port
    raise RuntimeError(f"all {GANG_PORT_SPAN} gang coordinator ports in use")


def coordinator_ports_in_use(api, coordinator_node: str,
                             pods: list | None = None) -> set:
    """Ports already promised to live gangs coordinated on ``node`` —
    read from existing pods' process-contract annotations, so the claim
    survives a scheduler restart exactly like every other decision (the
    API server is the checkpoint, SURVEY.md §6). Contracts only persist
    at commit time, so callers with gangs still in flight (the pipelined
    binder) pass those promises in via ``extra_used`` below. ``pods``
    short-circuits the API list — the scheduler hands its informer
    mirror in (read-only) so a gang commit doesn't pay a deep-copying
    cluster-wide list per plan."""
    import json

    used = set()
    if pods is None:
        try:
            pods = api.list_pods()
        except Exception:
            return used
    for pod in pods:
        raw = ((pod.get("metadata") or {}).get("annotations") or {}).get(
            GANG_PROCESS_ANNOTATION)
        if not raw:
            continue
        try:
            gp = json.loads(raw)
        except ValueError:
            continue
        if gp.get("coordinator_node") == coordinator_node:
            used.add(int(gp.get("coordinator_port", 0)))
    return used


def annotate_gang_processes(members: list, assignment: dict,
                            gang: int, api=None,
                            extra_used=(), pods: list | None = None) -> tuple:
    """Write each member's process contract into its annotations.

    Rank order is the sorted member-name order (the same determinism
    rule as everything else); the coordinator is rank 0's node.
    ``extra_used`` holds ``(node, port)`` promises not yet visible on the
    API (gang commits in flight on the pipelined binder). Returns the
    ``(coordinator_node, port)`` claim so the caller can track it until
    the contract annotations persist."""
    import json

    names = sorted(m["metadata"]["name"] for m in members)
    ranks = {name: i for i, name in enumerate(names)}
    coordinator_node = assignment[names[0]][0]
    used = coordinator_ports_in_use(api, coordinator_node, pods) \
        if api or pods is not None else set()
    used |= {p for node, p in extra_used if node == coordinator_node}
    port = gang_coordinator_port(gang, used)
    for member in members:
        name = member["metadata"]["name"]
        ann = member.setdefault("metadata", {}).setdefault("annotations", {})
        ann[GANG_PROCESS_ANNOTATION] = json.dumps({
            "gang": int(gang),
            "rank": ranks[name],
            "count": len(names),
            "coordinator_node": coordinator_node,
            "coordinator_port": port,
        }, sort_keys=True)
    return coordinator_node, port


def gang_key(kube_pod: dict):
    """(gang id, size) from the pod annotation, or None.

    Fast-paths on the raw annotation string so ordinary pods don't pay a
    full codec decode in the hot scheduling loop.
    """
    raw = ((kube_pod.get("metadata") or {}).get("annotations") or {}).get(
        codec.POD_ANNOTATION_KEY)
    if not raw or RESOURCE_GANG not in raw:
        return None
    try:
        pod_info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=False)
    except Exception:
        return None
    gang = pod_info.requests.get(RESOURCE_GANG)
    size = pod_info.requests.get(RESOURCE_GANG_SIZE)
    if gang is None or not size:
        return None
    return int(gang), int(size)


class GangBuffer:
    """Holds gang members until the full pod-set has arrived. Thread-safe:
    the watcher thread discards deleted members while the scheduler thread
    adds and drops."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._gangs: dict = {}  # gang id -> {pod name: kube_pod}

    def add(self, kube_pod: dict, gang: int, size: int) -> list | None:
        with self._lock:
            members = self._gangs.setdefault(gang, {})
            members[kube_pod["metadata"]["name"]] = kube_pod
            if len(members) >= size:
                return [members[n] for n in sorted_keys(members)]
            return None

    def discard_pod(self, pod_name: str) -> None:
        with self._lock:
            for members in self._gangs.values():
                members.pop(pod_name, None)

    def drop_gang(self, gang: int) -> None:
        with self._lock:
            self._gangs.pop(gang, None)

    def pending(self) -> int:
        with self._lock:
            return sum(len(m) for m in self._gangs.values())


class GangPlanner:
    """Places a gang host by host, through the device plugins' own fit
    (``devices``, by default the scheduler cache's)."""

    def __init__(self, cache, devices=None):
        self.cache = cache
        self.devices = devices if devices is not None \
            else cache.device_scheduler

    @staticmethod
    def _demand(pods: list) -> dict | None:
        """{pod name: cards} from each member's running containers'
        ``alpha.gpu/numgpu``, or None when any member asks for none."""
        sizes = {}
        for pod in pods:
            info = codec.kube_pod_to_pod_info(pod, invalidate_existing=True)
            sizes[pod["metadata"]["name"]] = sum(
                int(c.requests.get(grammar.RESOURCE_NUM_GPU, 0))
                for c in info.running_containers.values())
        if not sizes or any(n <= 0 for n in sizes.values()):
            return None
        return sizes

    @staticmethod
    def _free_cards(node) -> list:
        """The node's free card leaves, sorted by card prefix."""
        return sorted(
            (res for res, alloc in node.allocatable.items()
             if grammar.gpu_id_from_path(res) is not None
             and alloc - node.used.get(res, 0) > 0),
            key=grammar.gpu_prefix_from_path)

    @classmethod
    def _withhold(cls, node, count: int) -> None:
        """Mark ``count`` free cards used — room a nominated preemptor is
        owed. Deterministic: the highest-sorted cards are withheld, so
        every planning pass protects the SAME cards."""
        if count <= 0:
            return
        for res in cls._free_cards(node)[-count:]:
            node.used[res] = node.allocatable[res]

    def hosts(self, reserved: dict | None = None) -> dict:
        """{node name: a private copy of its cycle-snapshot inventory},
        in name order, with ``reserved`` ({node: card count}) withheld
        from each node's free cards."""
        names, snaps, _ = self.cache.cycle_snapshot()
        out = {}
        for name in names:
            node = snaps[name].node_ex.clone()
            self._withhold(node, (reserved or {}).get(name, 0))
            out[name] = node
        return out

    def plan(self, pods: list, reserved: dict | None = None,
             hosts: dict | None = None):
        """Assign each gang pod a host and its exact cards.

        Returns ``{pod_name: (node_name, {(is_init, container): {card path:
        value}})}`` or None, in which case nothing is pinned. Members are
        taken largest first, then by name; each tries every host in order
        (``hosts``, which the plan does not change; by default the cycle
        snapshot's, with ``reserved`` ({node: card count}) withheld) on a
        copy of the host's inventory already charged with the gang's
        earlier members. A host fits when the device plugins' fit succeeds
        there with allocation on; among those, the one left with the
        fewest free cards wins, then the name (the JAX planner's best-fit
        rule). Member sizes may differ; the plugins apply each member's
        memory floor."""
        sizes = self._demand(pods)
        if sizes is None:
            return None
        hosts = dict(self.hosts(reserved) if hosts is None else hosts)
        devices = self.devices
        by_name = {p["metadata"]["name"]: p for p in pods}
        assignment = {}
        for pod_name in sorted(sizes, key=lambda n: (-sizes[n], n)):
            best = None
            for host in hosts:
                trial = hosts[host].clone()
                info = codec.kube_pod_to_pod_info(by_name[pod_name],
                                                  invalidate_existing=True)
                fits, _, _ = devices.pod_fits_resources(info, trial, True)
                if not fits:
                    continue
                devices.take_pod_resources(info, trial)
                key = (len(self._free_cards(trial)), host)
                if best is None or key < best[0]:
                    best = (key, trial, info)
            if best is None:
                return None
            (_, host), trial, info = best
            hosts[host] = trial
            assignment[pod_name] = (host, {
                (is_init, cname): {phys: cont.dev_requests[req]
                                   for req, phys in cont.allocate_from.items()}
                for cname, cont, is_init in info.all_containers()
                if cont.allocate_from})
        return assignment

    # -- preemption ---------------------------------------------------------

    MAX_VICTIM_SETS = 64     # plans one preemption search may run
    EXACT_UNITS = 10         # up to this many units, every set is ranked

    @staticmethod
    def _counts_fit(sizes: list, free: dict) -> bool:
        """The plan's rule on counts alone: members largest first, each on
        the host left with the fewest free cards, then the name. In count
        mode, where the plugins' fit asks only for free cards, this is the
        plan's own outcome; a set it refuses is never planned."""
        left = dict(free)
        for need in sizes:
            fitting = [(n - need, h) for h, n in left.items() if n >= need]
            if not fitting:
                return False
            rest, host = min(fitting)
            left[host] = rest
        return True

    def plan_preemption(self, pods: list, units: list, owners: dict,
                        cost, reserved: dict | None = None,
                        stats: dict | None = None):
        """Gang preemption: the cheapest set of eviction units whose cards,
        released, let the gang place host by host (the GPU counterpart of
        the JAX planner's block search, `generic_scheduler.go:226-290`'s
        victim selection run against pod-sets).

        ``units`` are lists of bound pods evicted together (a pod widened
        to its whole bound gang), each below the gang's priority; a unit
        that holds no card is left out;
        ``owners`` maps ``(node, card prefix)`` to the pod holding that
        card; ``cost(frozenset of pod names)`` returns a sortable key
        (smaller is cheaper) or None to forbid a set. Sets are tried in
        cost order, then by their sorted pod names. Up to
        ``EXACT_UNITS`` units every set is ranked (exact); above, units
        are added cheapest first until the gang places, then each is
        dropped again, dearest first, when the gang still places without
        it. A set is planned only once `_counts_fit` passes on each
        host's free cards plus the cards it frees, and at most
        ``MAX_VICTIM_SETS`` plans are run. Reservations withhold truly
        free cards only: withholding a victim's card instead would let the
        gang take exactly the free room a nominated preemptor is owed.

        Returns ``(assignment, victim names)`` or None. The victims are
        the units whose cards the assignment uses; none when the plan
        found room among cards already free. ``stats`` (a dict), when
        given, receives ``sets_tried`` (sets counted) and ``plans``."""
        sizes = self._demand(pods)
        stats = stats if stats is not None else {}
        stats.update(sets_tried=0, plans=0)
        if sizes is None:
            return None
        devices = self.devices
        base = self.hosts(reserved)
        free = {h: len(self._free_cards(n)) for h, n in base.items()}
        demand = sorted(sizes.values(), reverse=True)
        held_units = []  # (unit, {host: cards it holds there})
        for unit in units:
            held: dict = {}
            for pod in unit:
                host = (pod.get("spec") or {}).get("nodeName")
                node = base.get(host)
                if node is None:
                    continue
                info = codec.kube_pod_to_pod_info(pod,
                                                  invalidate_existing=False)
                for _, cont, _ in info.all_containers():
                    for path in cont.allocate_from.values():
                        if grammar.gpu_id_from_path(path) is not None and \
                                path in node.allocatable:
                            held[host] = held.get(host, 0) + 1
            if held:  # a unit holding no card frees nothing
                held_units.append((unit, held))
        if not held_units:
            return None
        units = [u for u, _ in held_units]
        freed = [h for _, h in held_units]
        names = [frozenset(p["metadata"]["name"] for p in u) for u in units]

        def counts_fit(chosen) -> bool:
            stats["sets_tried"] += 1
            after = dict(free)
            for i in chosen:
                for host, n in freed[i].items():
                    after[host] += n
            return self._counts_fit(demand, after)

        def place(chosen):
            stats["plans"] += 1
            hosts = {h: n.clone() for h, n in base.items()}
            for i in chosen:
                for pod in units[i]:
                    host = (pod.get("spec") or {}).get("nodeName")
                    if host in hosts:
                        devices.return_pod_resources(
                            codec.kube_pod_to_pod_info(
                                pod, invalidate_existing=False), hosts[host])
            return self.plan(pods, hosts=hosts)

        def key_of(chosen):
            victims = frozenset().union(*(names[i] for i in chosen))
            key = cost(victims)
            return None if key is None else (key, tuple(sorted(victims)))

        found = None
        if len(units) <= self.EXACT_UNITS:
            ranked = []
            for mask in range(1, 1 << len(units)):
                chosen = [i for i in range(len(units)) if mask >> i & 1]
                key = key_of(chosen)
                if key is not None:
                    ranked.append((key, chosen))
            ranked.sort(key=lambda kc: kc[0])
            for _, chosen in ranked:
                if not counts_fit(chosen):
                    continue
                if stats["plans"] >= self.MAX_VICTIM_SETS:
                    return None
                assignment = place(chosen)
                if assignment is not None:
                    found = (assignment, chosen)
                    break
        else:
            order = sorted((k, [i]) for i in range(len(units))
                           if (k := key_of([i])) is not None)
            chosen: list = []
            for _, (i,) in order:
                chosen.append(i)
                if not counts_fit(chosen):
                    continue
                if stats["plans"] >= self.MAX_VICTIM_SETS:
                    return None
                assignment = place(chosen)
                if assignment is not None:
                    found = (assignment, list(chosen))
                    break
            if found is not None:
                # keep the set minimal: drop each unit, dearest first,
                # when the gang still places without it
                assignment, chosen = found
                for i in reversed(list(chosen)):
                    rest = [j for j in chosen if j != i]
                    if not rest or not counts_fit(rest):
                        continue
                    if stats["plans"] >= self.MAX_VICTIM_SETS:
                        break
                    trial = place(rest)
                    if trial is not None:
                        assignment, chosen = trial, rest
                found = (assignment, chosen)
        if found is None:
            return None
        assignment, chosen = found
        used = set()
        for host, cards in assignment.values():
            for paths in cards.values():
                for path in paths:
                    owner = owners.get((host, grammar.gpu_prefix_from_path(
                        path)))
                    if owner is not None:
                        used.add(owner)
        victims = frozenset().union(*(names[i] for i in chosen
                                      if names[i] & used))
        return assignment, victims

    @staticmethod
    def pin_pod(kube_pod: dict, node_name: str, cards: dict) -> dict:
        """Write the planned cards into the pod annotation as identity
        requests (``allocate_from[path] == path``), so the pod's
        allocation is exactly the one the plan charged. ``cards`` is one
        member's ``plan`` entry: {(is_init, container): {card path:
        value}}."""
        pod_info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=True)
        for name, cont, is_init in pod_info.all_containers():
            mine = cards.get((is_init, name))
            if not mine:
                continue
            cont.dev_requests = {
                k: v for k, v in cont.dev_requests.items()
                if not grammar.is_group_resource(k)}
            cont.allocate_from = {}
            for path in sorted(mine):
                cont.dev_requests[path] = mine[path]
                cont.allocate_from[path] = path
        pod_info.node_name = node_name
        codec.pod_info_to_annotation(kube_pod.setdefault("metadata", {}), pod_info)
        return kube_pod
