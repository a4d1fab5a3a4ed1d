"""Shared by the port's API server tests (tests/test_torch_apiserver.py,
test_torch_apiserver_http.py, test_torch_wal.py, test_torch_apf.py,
test_torch_apiserver_main.py and test_torch_scheduler_main.py): GPU
objects and their TPU twins, a seeded script of API operations that runs
alike on the JAX package's `InMemoryAPIServer` and the port's, and
``kgtpu-gpu-apiserver`` as a subprocess (`APIServerBinary`).

The JAX server keys its arbiter and its hard cap by TPU chips, the port's
by GPU cards. So the JAX side gets the TPU twin of every object (`twin`:
``.../gpu/<UUID>/cards`` becomes ``.../tpu/<UUID>/chips`` and
``alpha.gpu/numgpu`` becomes ``alpha.tpu/numchips``), and its answers are
mapped back (`untwin`) before they are compared with the port's.
"""

from __future__ import annotations

import json
import random

from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.core.types import ContainerInfo, NodeInfo, PodInfo
from kubegpu_tpu_torch.node import fake
from kubegpu_tpu_torch.node.manager import GPUDeviceManager

# GPU spelling -> TPU spelling; neither side of a pair occurs in the
# other's objects, so the mapping is a bijection on what the script makes
_TWIN = (("alpha.gpu/numgpu", "alpha.tpu/numchips"), ("/gpu/", "/tpu/"),
         ("/cards", "/chips"))

TENANT = "kgtpu.io/tenant"
NODES = ("host0", "host1", "host2")


def twin(obj):
    """The TPU twin of a JSON-shaped value."""
    text = json.dumps(obj)
    for gpu, tpu in _TWIN:
        text = text.replace(gpu, tpu)
    return json.loads(text)


def untwin(obj):
    """The GPU spelling of a twin (`twin`'s inverse)."""
    text = json.dumps(obj)
    for gpu, tpu in _TWIN:
        text = text.replace(tpu, gpu)
    return json.loads(text)


def card_path(node: int, card: int) -> str:
    """The cards-leaf path of card ``card`` of HGX host ``node``."""
    return grammar.gpu_resource(fake.fake_uuid(node, card),
                                grammar.CARDS_SUFFIX, (grammar.GPU_GRP1, 0),
                                (grammar.GPU_GRP0, card // 2))


def gpu_node(name: str, host: int = 0) -> dict:
    """A node advertising a fake HGX host's eight cards, as the node agent
    writes it."""
    info = NodeInfo(name=name)
    GPUDeviceManager(fake.FakeGPUBackend(
        fake.hgx_h100_inventory(host))).update_node_info(info)
    meta = {"name": name, "annotations": {
        codec.NODE_ADDRESS_ANNOTATION: "127.0.0.1"}}
    codec.node_info_to_annotation(meta, info)
    return {"metadata": meta,
            "status": {"allocatable": {"cpu": "64", "pods": 110}}}


def gpu_pod(name: str, cards: int = 1, tenant: str | None = None,
            alloc: tuple = (), gang: int | None = None) -> dict:
    """A pod asking ``cards`` cards; ``alloc`` = ``(node index, card
    indexes)`` writes the allocation the engine would (``allocatefrom``
    per card), ``gang`` a gang process contract."""
    info = PodInfo(name=name, running_containers={"main": ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: cards})})
    if alloc:
        host, idxs = alloc
        cont = info.running_containers["main"]
        for i in idxs:
            path = card_path(host, i)
            cont.dev_requests[path] = 1
            cont.allocate_from[path] = path
        info.node_name = NODES[host]
    meta = {"name": name}
    if tenant:
        meta["labels"] = {TENANT: tenant}
    codec.pod_info_to_annotation(meta, info)
    if gang is not None:
        meta["annotations"]["pod.alpha/GangProcess"] = json.dumps({
            "gang": gang, "coordinator_node": NODES[alloc[0]] if alloc
            else NODES[0], "coordinator_port": 29500 + gang % 3})
    return {"metadata": meta, "spec": {"containers": [
        {"name": "main", "resources": {"requests": {"cpu": "1"}}}]}}


def script(seed: int, n_ops: int = 160) -> list:
    """A seeded list of ``(verb, args)`` in GPU spelling: nodes, pods with
    allocations, annotations, binds one by one and in batches (refusals
    among them), deletes, volumes and claims, PDBs, the four owner kinds,
    events past a small ``MAX_EVENTS``, quotas with hard caps, and
    leases."""
    rng = random.Random(seed)
    ops = [("create_node", (gpu_node(n, i),)) for i, n in enumerate(NODES)]
    ops += [("set_quota", ("ta", {"weight": 2, "hard_chips": 6})),
            ("set_quota", ("tb", {"hard_chips": 3}))]
    names: list = []
    pvs = pvcs = 0

    def alloc():
        n = rng.choice((1, 1, 2))
        return rng.randrange(3), tuple(sorted(rng.sample(range(8), n)))

    def pod_args(name):
        host, idxs = alloc()
        gang = rng.randrange(4) if rng.random() < 0.2 else None
        return gpu_pod(name, len(idxs), rng.choice((None, "ta", "tb")),
                       (host, idxs), gang), host
    for _ in range(n_ops):
        r = rng.random()
        pick = rng.choice(names) if names else "ghost"
        if r < 0.16:
            name = f"p{len(names)}"
            names.append(name)
            ops.append(("create_pod", (pod_args(name)[0],)))
        elif r < 0.19:
            ops.append(("create_pod", (gpu_pod(pick),)))  # often a dup
        elif r < 0.29:
            pod, host = pod_args(pick)
            ops.append(("update_pod_annotations",
                        (pick, pod["metadata"]["annotations"])))
            if rng.random() < 0.5:
                ops.append(("bind_pod", (pick, NODES[host])))
        elif r < 0.36:
            ops.append(("bind_pod", (pick, rng.choice(NODES))))
        elif r < 0.48:
            batch = rng.sample(names, min(len(names), rng.randint(1, 3))) \
                if names else ["ghost"]
            bindings, anns = {}, {}
            for name in batch:
                pod, host = pod_args(name)
                bindings[name] = NODES[host]
                if rng.random() < 0.8:
                    anns[name] = pod["metadata"]["annotations"]
            ops.append(("bind_many", (bindings, anns)))
        elif r < 0.52:
            batch = rng.sample(names, min(len(names), 2)) if names else []
            ops.append(("update_pod_annotations_many", (
                {n: pod_args(n)[0]["metadata"]["annotations"]
                 for n in batch},)))
        elif r < 0.57:
            ops.append(("delete_pod", (pick,)))
        elif r < 0.60:
            ops.append(("patch_node_metadata", (rng.choice(NODES + ("gone",)),
                        {"labels": {"zone": rng.choice("ab")}})))
        elif r < 0.66:
            if rng.random() < 0.5:
                pvs += 1
                ops.append(("create_pv", ({"metadata": {"name": f"pv{pvs}"},
                            "spec": {"capacity": {"storage": "10Gi"}}},)))
            else:
                pvcs += 1
                ops.append(("create_pvc", ({"metadata": {"name": f"c{pvcs}"},
                            "spec": {"resources": {"requests": {
                                "storage": "5Gi"}}}},)))
        elif r < 0.70:
            ops.append(("bind_volume", (f"pv{rng.randint(1, pvs + 1)}",
                                        f"c{rng.randint(1, pvcs + 1)}")))
        elif r < 0.72:
            ops.append(("delete_pv" if rng.random() < 0.5 else "delete_pvc",
                        (f"pv{rng.randint(1, pvs + 1)}",)))
        elif r < 0.76:
            kind = rng.choice(("pdb", "service", "rc", "rs", "statefulset"))
            name = f"{kind}{rng.randrange(3)}"
            if rng.random() < 0.7:
                ops.append((f"create_{kind}", ({"metadata": {"name": name},
                            "spec": {"selector": {"matchLabels": {
                                "app": name}}}},)))
            else:
                ops.append((f"delete_{kind}", (name,)))
        elif r < 0.86:
            ops.append(("record_event", ("Pod", pick, "Normal",
                                         rng.choice(("Scheduled", "Failed")),
                                         f"m{rng.randrange(12)}")))
        elif r < 0.88:
            ops.append(("record_events", ([
                {"kind": "Pod", "name": pick, "reason": "Batch",
                 "message": f"b{rng.randrange(30)}"}
                for _ in range(rng.randint(1, 4))],)))
        elif r < 0.91:
            tenant = rng.choice(("ta", "tb", "tc"))
            if rng.random() < 0.7:
                ops.append(("set_quota", (tenant, {
                    "hard_chips": rng.randint(2, 8)})))
            else:
                ops.append(("delete_quota", (tenant,)))
        elif r < 0.95:
            lease = f"l{rng.randrange(2)}"
            verb = rng.choice(("acquire_lease", "release_lease"))
            holder = rng.choice(("a", "b"))
            ops.append((verb, (lease, holder, 30.0) if verb ==
                        "acquire_lease" else (lease, holder)))
            ops.append(("lease_holder", (lease,)))
        else:
            ops.append(rng.choice((
                ("list_pods", ()), ("list_nodes", ()), ("list_quotas", ()),
                ("list_events", (pick,)), ("get_pod", (pick,)),
                ("list_pvs", ()), ("list_pvcs", ()), ("list_pdbs", ()),
                ("list_services", ()), ("list_statefulsets", ()))))
    ops += [("list_pods", ()), ("list_quotas", ()), ("list_events", ()),
            ("list_pvcs", ()), ("list_pvs", ())]
    return ops


def outcome(fn, *args):
    """``("ok", value)`` or ``("raise", type name, sorted per_pod keys)``:
    the port's and the JAX server's error messages differ in one word
    (card, chip), so the comparison takes the type and the pods named."""
    try:
        return ("ok", fn(*args))
    except (KeyError, RuntimeError) as err:
        return ("raise", type(err).__name__,
                sorted(getattr(err, "per_pod", {}) or {}))


class APIServerBinary:
    """``python -m kubegpu_tpu_torch.cmd.apiserver_main --port P ARGS`` as
    a subprocess, waited for until it says it listens (``url``); `kill`
    and `restart` keep its port and arguments."""

    def __init__(self, repo: str, *args, port: int = 0):
        import socket

        if not port:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
        self.repo, self.args, self.port = repo, args, port
        self.url = f"http://127.0.0.1:{port}"
        self.proc = None
        self.start()

    def start(self) -> None:
        import os
        import subprocess
        import sys

        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubegpu_tpu_torch.cmd.apiserver_main",
             "--port", str(self.port), *self.args],
            cwd=self.repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("apiserver listening at "):
            self.proc.kill()
            raise AssertionError(f"the apiserver said {line!r}: "
                                 f"{self.proc.stderr.read()[-3000:]}")
        self.line = line.strip()

    def stop(self, sig=None, timeout: float = 10.0) -> int:
        import signal

        proc = self.proc
        if proc.poll() is None:
            proc.send_signal(sig or signal.SIGTERM)
        try:
            return proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            proc.stderr.close()
