"""The port's real-Kubernetes client (`kubegpu_tpu_torch.cluster.kubeclient`)
against its mock API server (`cluster/mock_kube.py`), which speaks the
real wire grammar: paths, verbs, strategic-merge-patch content types, the
Binding subresource, streaming watches, bearer auth, and the advertise ->
schedule -> bind -> hook flow over GPU cards. Each test of
tests/test_kubeclient.py has its counterpart here; then the trace header,
a seeded script of verbs that the port's client and mock answer as the
JAX package's do (and across: either client against the other's mock),
and the stale stamp a refused bind used to leave over the two-stage
``bind_many``."""

import copy
import json
import random
import socket
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu_torch import obs  # noqa: E402
from kubegpu_tpu_torch.cluster.apiserver import (Conflict,  # noqa: E402
                                                 NotFound)
from kubegpu_tpu_torch.cluster.kubeclient import (KubeAPIClient,  # noqa: E402
                                                  KubeConfig)
from kubegpu_tpu_torch.cluster.mock_kube import serve_mock_kube  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser  # noqa: E402
from kubegpu_tpu_torch.node.manager import (DevicesManager,  # noqa: E402
                                            GPUDeviceManager)
from kubegpu_tpu_torch.runtime.hook import GPURuntimeHook  # noqa: E402
from kubegpu_tpu_torch.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.registry import (  # noqa: E402
    build_device_scheduler)
from tests import torch_api as ta  # noqa: E402


@pytest.fixture()
def kube():
    server, url, api = serve_mock_kube()
    client = KubeAPIClient(KubeConfig(server=url))
    yield client, api
    client.close()
    server.shutdown()


def _node(name):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": "8", "pods": 100}}}


def _pod(name, cards=0):
    if cards:
        return ta.gpu_pod(name, cards)
    return {"metadata": {"name": name},
            "spec": {"containers": [{"name": "main", "resources": {
                "requests": {"cpu": "1"}}}]}}


def _gpu_host(client, name, host=0):
    """A fake HGX host's device manager, advertised onto ``name`` through
    ``client``; returns the node's `GPUDeviceManager`."""
    gpu = GPUDeviceManager(fake.FakeGPUBackend(fake.hgx_h100_inventory(host)))
    mgr = DevicesManager()
    mgr.add_device(gpu)
    mgr.start()
    DeviceAdvertiser(client, mgr, name).advertise_once()
    return gpu


def _sched(url):
    return Scheduler(KubeAPIClient(KubeConfig(server=url)),
                     build_device_scheduler())


def _run_until_bound(client, sched, name, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sched.run_until_idle()
        if client.get_pod(name)["spec"].get("nodeName"):
            return True
        time.sleep(0.05)
    return False


def _card_uuids(kube_pod) -> list:
    info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=False)
    return sorted(grammar.gpu_id_from_path(path)
                  for cont in info.running_containers.values()
                  for path in cont.allocate_from.values()
                  if grammar.gpu_id_from_path(path) is not None)


def _stop(sched):
    sched.stop()
    sched.api.close()


def test_node_crud_and_strategic_merge_patch(kube):
    client, _ = kube
    client.create_node(_node("n1"))
    assert client.get_node("n1")["metadata"]["name"] == "n1"
    client.patch_node_metadata("n1", {"annotations": {"a": "1"}})
    client.patch_node_metadata("n1", {"annotations": {"b": "2"}})
    ann = client.get_node("n1")["metadata"]["annotations"]
    assert ann == {"a": "1", "b": "2"}  # merge, not replace
    assert [n["metadata"]["name"] for n in client.list_nodes()] == ["n1"]
    client.delete_node("n1")
    with pytest.raises(NotFound):
        client.get_node("n1")


def test_pod_crud_bind_subresource_and_field_selector(kube):
    client, _ = kube
    client.create_node(_node("n1"))
    client.create_pod(_pod("p1"))
    client.create_pod(_pod("p2"))
    client.update_pod_annotations("p1", {"k": "v"})
    assert client.get_pod("p1")["metadata"]["annotations"] == {"k": "v"}
    client.bind_pod("p1", "n1")
    assert client.get_pod("p1")["spec"]["nodeName"] == "n1"
    on_node = client.list_pods(node_name="n1")
    assert [p["metadata"]["name"] for p in on_node] == ["p1"]
    assert [p["metadata"]["name"] for p in client.list_pods(bound=True)] \
        == ["p1"]
    client.delete_pod("p2")
    assert len(client.list_pods()) == 1


def test_bind_many_annotates_then_binds(kube):
    client, _ = kube
    assert KubeAPIClient.atomic_bind_many is False
    client.create_node(_node("n1"))
    client.create_pod(_pod("g1"))
    client.create_pod(_pod("g2"))
    client.bind_many({"g1": "n1", "g2": "n1"},
                     {"g1": {"x": "1"}, "g2": {"x": "2"}})
    for name, x in (("g1", "1"), ("g2", "2")):
        pod = client.get_pod(name)
        assert pod["spec"]["nodeName"] == "n1"
        assert pod["metadata"]["annotations"]["x"] == x


def test_watch_streams_events_and_close_joins_the_informers(kube):
    client, _ = kube
    events = []
    client.add_watcher(lambda kind, evt, obj: events.append(
        (kind, evt, obj["metadata"]["name"])))
    client.create_node(_node("n1"))
    client.create_pod(_pod("p1"))
    client.delete_pod("p1")
    deadline = time.monotonic() + 10
    want = {("node", "added", "n1"), ("pod", "added", "p1"),
            ("pod", "deleted", "p1")}
    while time.monotonic() < deadline and not want.issubset(set(events)):
        time.sleep(0.05)
    assert want.issubset(set(events)), events
    threads = list(client._watch_threads)
    assert len(threads) == 4 and all(t.is_alive() for t in threads)
    t0 = time.monotonic()
    client.close()  # blocked reads with no timeout must wake
    assert time.monotonic() - t0 < 5.0
    assert not any(t.is_alive() for t in threads)
    assert not client._watch_conns


def test_a_dropped_watch_relists_and_misses_nothing(kube):
    """A watch stream cut under the informer (its socket shut down, as a
    dropped connection) relists and streams on: an object created while
    it was down arrives, as ``added`` from the relist or the stream."""
    client, api = kube
    seen = []
    client.add_watcher(lambda kind, evt, obj: seen.append(
        (kind, evt, obj["metadata"]["name"])))
    client.create_node(_node("before"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            ("node", "added", "before") not in seen:
        time.sleep(0.02)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with client._watch_lock:
            socks = [c.sock for c in client._watch_conns
                     if c.sock is not None]
        if len(socks) == 4:
            break
        time.sleep(0.02)
    assert len(socks) == 4
    for sock in socks:
        sock.shutdown(socket.SHUT_RDWR)  # every stream drops at once
    api.create_node(_node("during"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            ("node", "added", "during") not in seen:
        time.sleep(0.05)
    assert ("node", "added", "during") in seen, seen
    client.create_node(_node("after"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            ("node", "added", "after") not in seen:
        time.sleep(0.05)
    assert ("node", "added", "after") in seen, seen


def test_bearer_auth_enforced():
    server, url, _ = serve_mock_kube(token="sekrit")
    try:
        bad = KubeAPIClient(KubeConfig(server=url))
        with pytest.raises(RuntimeError, match="401"):
            bad.list_nodes()
        good = KubeAPIClient(KubeConfig(server=url, token="sekrit"))
        assert good.list_nodes() == []
    finally:
        server.shutdown()


def _kubeconfig_doc():
    return {
        "current-context": "test",
        "contexts": [{"name": "test",
                      "context": {"cluster": "c", "user": "u",
                                  "namespace": "gpu-jobs"}}],
        "clusters": [{"name": "c",
                      "cluster": {"server": "https://1.2.3.4:6443/",
                                  "insecure-skip-tls-verify": True}}],
        "users": [{"name": "u", "user": {"token": "tok123"}}],
    }


def test_kubeconfig_parsing(tmp_path, monkeypatch):
    path = tmp_path / "kubeconfig"
    path.write_text(json.dumps(_kubeconfig_doc()))  # JSON is valid YAML
    # a JSON kubeconfig needs no PyYAML
    monkeypatch.setitem(sys.modules, "yaml", None)
    kc = KubeConfig.from_kubeconfig(str(path))
    assert kc.server == "https://1.2.3.4:6443"
    assert kc.token == "tok123"
    assert kc.insecure is True
    assert kc.namespace == "gpu-jobs"
    # load(path) reads the same file
    assert KubeConfig.load(str(path)) == kc
    # YAML that is not JSON needs PyYAML, and says so when it is absent
    path.write_text("current-context: test\n")
    with pytest.raises(RuntimeError, match="PyYAML"):
        KubeConfig.from_kubeconfig(str(path))


def test_kubeconfig_yaml_through_pyyaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "kubeconfig"
    path.write_text(yaml.safe_dump(_kubeconfig_doc()))
    kc = KubeConfig.from_kubeconfig(str(path))
    assert (kc.server, kc.token, kc.namespace) == \
        ("https://1.2.3.4:6443", "tok123", "gpu-jobs")


def test_in_cluster_requires_env(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError, match="not running in a cluster"):
        KubeConfig.in_cluster()
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    kc = KubeConfig.in_cluster()
    assert kc.server == "https://10.0.0.1:443"


def test_end_to_end_over_real_grammar(kube):
    """The full loop on Kubernetes REST over GPU cards: the advertiser
    patches the node annotation, the scheduler watches, schedules, writes
    the pod annotation and binds through the Binding subresource; the
    runtime hook then gives the pod CUDA_VISIBLE_DEVICES for its cards."""
    client, _ = kube
    client.create_node(_node("host0"))
    gpu = _gpu_host(client, "host0")
    node = client.get_node("host0")
    assert codec.NODE_ANNOTATION_KEY in node["metadata"]["annotations"]

    sched = _sched(client.config.server)
    try:
        client.create_pod(_pod("job-a", cards=2))
        assert _run_until_bound(client, sched, "job-a")
        pod = client.get_pod("job-a")
        assert pod["spec"]["nodeName"] == "host0"
        uuids = _card_uuids(pod)
        assert len(uuids) == 2
        inventory = {g.uuid for g in gpu.backend.inventory.gpus}
        assert set(uuids) <= inventory
        config = GPURuntimeHook(client, gpu).create_container(
            "job-a", "main", {})
        env = {e["key"]: e["value"] for e in config["envs"]}
        assert sorted(env["CUDA_VISIBLE_DEVICES"].split(",")) == uuids
    finally:
        _stop(sched)


def test_pvc_pv_crud_and_two_patch_bind(kube):
    """The real binder's wire shape: PV claimRef patch, then PVC
    volumeName patch, both strategic-merge; re-claim conflicts."""
    client, api = kube
    client.create_pvc({"metadata": {"name": "c1"},
                       "spec": {"resources": {"requests":
                                              {"storage": "5Gi"}},
                                "storageClassName": ""}})
    client.create_pv({"metadata": {"name": "v1"},
                      "spec": {"capacity": {"storage": "10Gi"},
                               "storageClassName": ""}})
    assert [p["metadata"]["name"] for p in client.list_pvcs()] == ["c1"]
    assert [p["metadata"]["name"] for p in client.list_pvs()] == ["v1"]
    client.bind_volume("v1", "c1")
    assert client.get_pv("v1")["spec"]["claimRef"]["name"] == "c1"
    assert client.get_pvc("c1")["spec"]["volumeName"] == "v1"
    client.create_pvc({"metadata": {"name": "c2"}, "spec": {}})
    with pytest.raises(Conflict):
        client.bind_volume("v1", "c2")  # re-claim conflicts (409)
    # the client-side GET-verify guards even against servers that would
    # merge a foreign claimRef (real apiserver behaviour)
    api.create_pv({"metadata": {"name": "v9"},
                   "spec": {"capacity": {"storage": "1Gi"},
                            "storageClassName": "",
                            "claimRef": {"name": "someone-else"}}})
    with pytest.raises(Conflict):
        client.bind_volume("v9", "c2")
    # a same-named claim in another namespace is a foreign binding too
    api.create_pv({"metadata": {"name": "v10"},
                   "spec": {"capacity": {"storage": "1Gi"},
                            "storageClassName": "",
                            "claimRef": {"name": "c2",
                                         "namespace": "other-ns"}}})
    with pytest.raises(Conflict):
        client.bind_volume("v10", "c2")
    client.delete_pvc("c2")
    client.delete_pv("v1")
    with pytest.raises(NotFound):
        client.get_pv("v1")


def test_volume_binding_end_to_end_over_real_grammar(kube):
    """An unbound-PVC GPU pod over Kubernetes REST: the scheduler waits,
    the PV arrives through the pv watch, the pod binds and the claim flips
    to Bound through the two-patch bind."""
    client, _ = kube
    client.create_node(_node("host0"))
    _gpu_host(client, "host0")
    sched = _sched(client.config.server)
    try:
        client.create_pvc({"metadata": {"name": "data"},
                           "spec": {"resources": {"requests":
                                                  {"storage": "5Gi"}},
                                    "storageClassName": ""}})
        pod = _pod("vol-job", cards=1)
        pod["spec"]["volumes"] = [
            {"name": "d", "persistentVolumeClaim": {"claimName": "data"}}]
        client.create_pod(pod)
        sched.run_until_idle()
        assert not client.get_pod("vol-job")["spec"].get("nodeName")
        client.create_pv({"metadata": {"name": "vol1"},
                          "spec": {"capacity": {"storage": "10Gi"},
                                   "storageClassName": ""}})
        assert _run_until_bound(client, sched, "vol-job")
        assert client.get_pod("vol-job")["spec"]["nodeName"] == "host0"
        assert client.get_pvc("data")["spec"]["volumeName"] == "vol1"
        assert client.get_pv("vol1")["spec"]["claimRef"]["name"] == "data"
    finally:
        _stop(sched)


def test_scheduler_restart_no_double_charge_from_watch_replay(kube):
    """A real watch replays current objects as ADDED on connect; a
    restarted scheduler both lists bound pods and sees them replayed, and
    must charge each card once, or the leaked cards leave later pods
    unschedulable (an HGX host's 8 cards, 4 + 4)."""
    client, _ = kube
    client.create_node(_node("host0"))
    _gpu_host(client, "host0")
    sched1 = _sched(client.config.server)
    client.create_pod(_pod("job-a", cards=4))
    try:
        assert _run_until_bound(client, sched1, "job-a")
    finally:
        _stop(sched1)
    # restart: fresh scheduler, fresh informer (replays job-a as ADDED)
    sched2 = _sched(client.config.server)
    try:
        client.create_pod(_pod("job-b", cards=4))
        assert _run_until_bound(client, sched2, "job-b"), \
            "job-b unschedulable: bound pod double-charged on restart"
        cards = [u for name in ("job-a", "job-b")
                 for u in _card_uuids(client.get_pod(name))]
        assert len(cards) == 8 and len(set(cards)) == 8
    finally:
        _stop(sched2)


def test_kubeclient_attaches_trace_header():
    client = KubeAPIClient(KubeConfig(server="http://127.0.0.1:1"))
    assert obs.TRACE_HEADER not in client._headers()
    with obs.span("bind_commit", pod="p1") as sp:
        hdr = client._headers()[obs.TRACE_HEADER]
    doc = json.loads(hdr)
    assert doc["parent"] == f"{sp.trace_id}/{sp.span_id}"


# ---- the refused bind over a two-stage bind_many ---------------------------


def test_a_refused_bind_leaves_no_stamp_and_the_pod_binds_later(kube):
    """Kubernetes has no atomic multi-bind, so the client's ``bind_many``
    annotates, then binds. A card taken behind the engine's back between
    its assume and its bind (a rival bound through the server itself,
    deterministically, inside the engine's bind call) refuses the bind
    409 after the allocation was stamped; the engine must withdraw it, or
    every replan reads the stale pin back and fails on the taken card.
    The pod binds on a later cycle, to another card."""
    client, api = kube
    client.create_node(_node("host0"))
    _gpu_host(client, "host0")
    sched = _sched(client.config.server)
    real = sched.api.bind_many
    taken: list = []

    def racing_bind_many(bindings, annotations):
        if not taken:
            name, host = next(iter(bindings.items()))
            stamp = copy.deepcopy(annotations[name])
            rival = _pod("rival", cards=1)
            rival["metadata"]["annotations"] = stamp
            api.create_pod(rival)
            api.bind_many({"rival": host}, {"rival": stamp})
            taken.extend(_card_uuids(api.get_pod("rival")))
        return real(bindings, annotations)

    sched.api.bind_many = racing_bind_many
    # every state the server gives the pod, in order: (node, its cards)
    states: list = []
    api.add_watcher(lambda kind, event, obj: states.append(
        ((obj.get("spec") or {}).get("nodeName"), _card_uuids(obj)))
        if kind == "pod" and obj["metadata"]["name"] == "job" else None)
    try:
        client.create_pod(_pod("job", cards=1))
        deadline = time.monotonic() + 10
        while not taken and time.monotonic() < deadline:
            sched.run_until_idle()  # until the informers deliver the pod
            time.sleep(0.02)
        assert taken, "the engine never reached its bind"
        assert _run_until_bound(client, sched, "job")
        uuids = _card_uuids(client.get_pod("job"))
        assert len(uuids) == 1 and uuids != taken
        # the refused bind stamped the taken card on the pending pod; the
        # very next state withdraws it, before the pod is stamped again
        at = states.index((None, taken))
        assert states[at + 1] == (None, []), \
            f"the refused bind's allocation stayed stamped: {states}"
    finally:
        _stop(sched)


# ---- the port's client and mock against the JAX package's -----------------


def _kube_script(seed: int, n_ops: int = 70) -> list:
    """A seeded list of ``(verb, args)`` of the client's surface in GPU
    spelling: nodes and their patches, pods with allocations, annotation
    writes one by one and batched, binds one by one and batched (refusals
    among them), deletes, field-selected lists, volumes and claims with
    the two-patch bind, and the four owner listers (which the mock does
    not serve)."""
    rng = random.Random(seed)
    ops = [("create_node", (ta.gpu_node(n, i),))
           for i, n in enumerate(ta.NODES)]
    names: list = []
    pvs = pvcs = 0

    def pod_args(name):
        n = rng.choice((1, 1, 2))
        host = rng.randrange(3)
        idxs = tuple(sorted(rng.sample(range(8), n)))
        return ta.gpu_pod(name, n, alloc=(host, idxs)), host

    for _ in range(n_ops):
        r = rng.random()
        pick = rng.choice(names) if names else "ghost"
        if r < 0.18:
            name = f"p{len(names)}"
            names.append(name)
            ops.append(("create_pod", (pod_args(name)[0],)))
        elif r < 0.21:
            ops.append(("create_pod", (ta.gpu_pod(pick),)))  # often a dup
        elif r < 0.31:
            pod, host = pod_args(pick)
            ops.append(("update_pod_annotations",
                        (pick, pod["metadata"]["annotations"])))
            if rng.random() < 0.5:
                ops.append(("bind_pod", (pick, ta.NODES[host])))
        elif r < 0.38:
            ops.append(("bind_pod", (pick, rng.choice(ta.NODES))))
        elif r < 0.48:
            batch = rng.sample(names, min(len(names), rng.randint(1, 3))) \
                if names else ["ghost"]
            bindings, anns = {}, {}
            for name in batch:
                pod, host = pod_args(name)
                bindings[name] = ta.NODES[host]
                anns[name] = pod["metadata"]["annotations"]
            ops.append(("bind_many", (bindings, anns)))
        elif r < 0.52:
            batch = rng.sample(names, min(len(names), 2)) if names else []
            ops.append(("update_pod_annotations_many", (
                {n: pod_args(n)[0]["metadata"]["annotations"]
                 for n in batch},)))
        elif r < 0.57:
            ops.append(("delete_pod", (pick,)))
        elif r < 0.61:
            ops.append(("patch_node_metadata",
                        (rng.choice(ta.NODES + ("gone",)),
                         {"labels": {"zone": rng.choice("ab")}})))
        elif r < 0.68:
            if rng.random() < 0.5:
                pvs += 1
                ops.append(("create_pv", ({"metadata": {"name": f"pv{pvs}"},
                            "spec": {"capacity": {"storage": "10Gi"}}},)))
            else:
                pvcs += 1
                ops.append(("create_pvc", ({"metadata": {"name": f"c{pvcs}"},
                            "spec": {"resources": {"requests": {
                                "storage": "5Gi"}}}},)))
        elif r < 0.73:
            ops.append(("bind_volume", (f"pv{rng.randint(1, pvs + 1)}",
                                        f"c{rng.randint(1, pvcs + 1)}")))
        elif r < 0.76:
            ops.append(("delete_pv" if rng.random() < 0.5 else "delete_pvc",
                        (f"pv{rng.randint(1, pvs + 1)}",)))
        elif r < 0.80:
            ops.append((rng.choice(("list_services", "list_rcs", "list_rss",
                                    "list_statefulsets")), ()))
        else:
            ops.append(rng.choice((
                ("list_pods", ()), ("list_nodes", ()),
                ("list_pods", (rng.choice(ta.NODES),)),
                ("list_pods", (None, None, True)),
                ("get_pod", (pick,)), ("get_node", (rng.choice(ta.NODES),)),
                ("list_pvs", ()), ("list_pvcs", ()),
                ("get_pv", (f"pv{rng.randint(1, pvs + 1)}",)))))
    ops += [("list_pods", ()), ("list_nodes", ()), ("list_pvcs", ()),
            ("list_pvs", ())]
    return ops


def _jax_side():
    from kubegpu_tpu.cluster import kubeclient as jax_kube
    from kubegpu_tpu.cluster import mock_kube as jax_mock

    return jax_kube, jax_mock


class _Run:
    """One client against one mock, the script replayed in the mock's
    spelling (``twin`` for the JAX one's TPU arbiter), its replies and
    typed errors in GPU spelling, and every watch event the client's
    informers delivered."""

    def __init__(self, client_pkg: str, mock_pkg: str):
        jax_kube, jax_mock = _jax_side()
        mock = serve_mock_kube if mock_pkg == "port" \
            else jax_mock.serve_mock_kube
        self.spell = (lambda x: x) if mock_pkg == "port" else ta.twin
        self.unspell = (lambda x: x) if mock_pkg == "port" else ta.untwin
        self.server, url, self.api = mock()
        kube_mod = sys.modules[KubeAPIClient.__module__] \
            if client_pkg == "port" else jax_kube
        self.client = kube_mod.KubeAPIClient(kube_mod.KubeConfig(server=url))
        self.events: list = []
        self._lock = threading.Lock()
        self._logged = 0  # events the server emitted since _ready
        self.api.add_watcher(self._on_logged)
        self.client.add_watcher(self._on_event)
        self._ready()

    def _on_logged(self, kind, event, obj):
        with self._lock:
            self._logged += 1

    def _on_event(self, kind, event, obj):
        with self._lock:
            self.events.append((kind, event, obj))

    def _ready(self):
        """Block until every informer streams: one sentinel of each kind
        seen (through its list or its watch); later events arrive on the
        streams, in order."""
        self.client.create_node({"metadata": {"name": "sentinel"}})
        self.client.create_pod({"metadata": {"name": "sentinel"},
                                "spec": {}})
        self.client.create_pv({"metadata": {"name": "sentinel"}, "spec": {}})
        self.client.create_pvc({"metadata": {"name": "sentinel"},
                                "spec": {}})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with self._lock:
                seen = {k for k, _, o in self.events
                        if o["metadata"]["name"] == "sentinel"}
            if seen == {"node", "pod", "pv", "pvc"}:
                break
            time.sleep(0.02)
        else:
            raise AssertionError(f"informers never started: {seen}")
        with self._lock:
            self.events.clear()
            self._logged = 0

    def play(self, ops) -> list:
        out = []
        for verb, args in ops:
            got = ta.outcome(getattr(self.client, verb),
                             *self.spell(list(args)))
            out.append(self.unspell(list(got)))
        return out

    def delivered(self) -> dict:
        """``{kind: [(event, object), ...]}`` once the informers have
        delivered every event the server emitted."""
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with self._lock:
                if len(self.events) >= self._logged:
                    break
            time.sleep(0.02)
        with self._lock:
            events = list(self.events)
        by_kind: dict = {}
        for kind, event, obj in events:
            by_kind.setdefault(kind, []).append(
                (event, self.unspell(obj)))
        return by_kind

    def close(self):
        self.client.close()
        self.server.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_script_equals_the_jax_client_and_mock(seed):
    """The port's client over the port's mock answers a seeded script of
    verbs as the JAX client over the JAX mock does (on the TPU twins):
    replies, typed errors with their per-pod keys, and the watch events
    each kind's informer delivers, in order."""
    ops = _kube_script(seed)
    port, ref = _Run("port", "port"), _Run("jax", "jax")
    try:
        got, want = port.play(ops), ref.play(ops)
        for i, ((verb, _), a, b) in enumerate(zip(ops, got, want)):
            assert a == b, f"op {i} {verb}: port {a} != jax {b}"
        events_ref, events_port = ref.delivered(), port.delivered()
        assert events_port == events_ref
        assert sum(len(v) for v in events_port.values()) > 20
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("client_pkg,mock_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_each_client_speaks_to_the_other_mock(client_pkg, mock_pkg):
    """The port's client against the JAX mock, and the JAX client against
    the port's mock, answer the script as the port's pair does."""
    ops = _kube_script(7)
    base, cross = _Run("port", "port"), _Run(client_pkg, mock_pkg)
    try:
        assert cross.play(ops) == base.play(ops)
        assert cross.delivered() == base.delivered()
    finally:
        base.close()
        cross.close()
