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
all-or-nothing.

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
    """Places a gang host by host, through the device plugins' own fit."""

    def __init__(self, cache):
        self.cache = cache

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

    def plan(self, pods: list, reserved: dict | None = None):
        """Assign each gang pod a host and its exact cards.

        Returns ``{pod_name: (node_name, {(is_init, container): {card path:
        value}})}`` or None, in which case nothing is pinned. Members are
        taken largest first, then by name; each tries every host of the
        cycle snapshot in name order on a copy of the host's inventory
        already charged with the gang's earlier members and with
        ``reserved`` ({node: card count}) withheld. A host fits when the
        device plugins' fit succeeds there with allocation on; among
        those, the one left with the fewest free cards wins, then the
        name (the JAX planner's best-fit rule). Member sizes may differ;
        the plugins apply each member's memory floor."""
        sizes = self._demand(pods)
        if sizes is None:
            return None
        devices = self.cache.device_scheduler
        names, snaps, _ = self.cache.cycle_snapshot()
        hosts = {}
        for name in names:
            node = snaps[name].node_ex.clone()
            self._withhold(node, (reserved or {}).get(name, 0))
            hosts[name] = node
        by_name = {p["metadata"]["name"]: p for p in pods}
        assignment = {}
        for pod_name in sorted(sizes, key=lambda n: (-sizes[n], n)):
            best = None
            for host in names:
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
