"""``kgtpu-gpu-scheduler`` (`kubegpu_tpu_torch/cmd/scheduler_main.py`) as a
subprocess against the JAX API server (`serve_api`) with fake HGX and PCIe
hosts (`tests/test_torch_gpu_e2e.py`'s `GPUHost`), on each wire: it places
a seeded stream exactly as the port's engine in process does
(`tests/torch_sched.py`), binds a GPU gang all or nothing where the JAX
binary with the port's plugin leaves it buffered, refuses a TPU pod with an
event, fails over under ``--leader-elect``, serves ``/debug/pod/<name>``,
runs its profiler and metrics time-series, writes one flight dump for a
conflict streak, runs the node lifecycle controller (a node whose
heartbeat stops loses its pod, which the binary binds elsewhere), gates
tenants by their configured weights (``--tenant-quota``), repairs a pod
off a failed card (``--repair``, elected as the JAX binary elects its
controller), and calls the config's and the policy's extenders. The JAX
server's arbiter lets two pods claim one GPU card (ROADMAP Queue 3); two
``--replicas 2 --shard I`` binaries over the port's ``kgtpu-gpu-apiserver``
bind every pod once with no card claimed twice, on both wires."""

import contextlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import Conflict as JaxConflict  # noqa: E402
from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.cluster.httpapi import serve_api  # noqa: E402
from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu_torch.cluster import apiserver as port_api  # noqa: E402
from kubegpu_tpu_torch.cluster import httpapi as port_http  # noqa: E402
from kubegpu_tpu_torch.cluster import lease  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient  # noqa: E402
from kubegpu_tpu_torch.cmd import scheduler_main  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from tests import torch_api as ta  # noqa: E402
from tests import torch_sched as ts  # noqa: E402
from tests.test_torch_gpu_e2e import SCHEDULER_PLUGINS, GPUHost  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = ("json", "stream")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class Binary:
    """A scheduler binary as a subprocess (the port's, or with ``module``
    the JAX one), waited for until it says it runs; its later stdout lines
    collect in ``lines``."""

    READY = ("scheduler running", "scheduler candidate", "scheduler replica")

    def __init__(self, url, tmp_path, *args,
                 module="kubegpu_tpu_torch.cmd.scheduler_main"):
        self.healthz = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        self.err_path = tmp_path / f"sched-{self.healthz}.err"
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, "--api", url, "--healthz-port",
             str(self.healthz), *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=self._err,
            text=True)
        self.lines: list = []
        for line in self.proc.stdout:
            self.lines.append(line.strip())
            if line.startswith(self.READY):
                break
        else:
            self.stop()
            raise AssertionError(f"{module} exited: {self.stderr()}")
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.strip())

    def said(self, text: str) -> bool:
        return any(text in line for line in list(self.lines))

    def stderr(self) -> str:
        if not self._err.closed:
            self._err.flush()
        return self.err_path.read_text()[-3000:]

    def get(self, path: str):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.healthz}{path}", timeout=10) as r:
            body = r.read().decode()
        return json.loads(body) if path.startswith(
            ("/debug", "/metrics/history")) else body

    def metric(self, name: str) -> float:
        for line in self.get("/metrics").splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
        raise AssertionError(f"no {name} in /metrics")

    def stop(self, sig=signal.SIGTERM, timeout: float = 10.0):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            reader = getattr(self, "_reader", None)
            if reader is not None:
                reader.join(timeout=5)
            self.proc.stdout.close()
            self._err.close()


@contextlib.contextmanager
def served(*inventories, apf=None, api=None):
    """The JAX API server (``api``, or a new one) with one `GPUHost` per
    inventory, on HTTP: ``(api, url)``."""
    api = api if api is not None else InMemoryAPIServer()
    for i, inv in enumerate(inventories):
        GPUHost(api, f"host{i}", inv)
    server, url = serve_api(api, apf=apf)
    try:
        yield api, url
    finally:
        server.shutdown()


def _bound(api, name):
    return (api.get_pod(name).get("spec") or {}).get("nodeName")


def _failed(api, name):
    return [e for e in api.list_events(involved_name=name)
            if e.get("reason") == "FailedScheduling"]


def _stream(seed: int) -> list:
    rng = random.Random(seed)
    return [ts.pod(f"s{seed}-{i}", rng.choice([1, 2, 4, 8]),
                   auto=rng.random() < 0.25) for i in range(12)]


INVENTORIES = (fake.hgx_h100_inventory, fake.pcie_h100_inventory,
               fake.hgx_h100_inventory)


def _in_process_placements(pods: list) -> list:
    api, _, sched = ts.cluster("port", *(f() for f in INVENTORIES))
    out = []
    try:
        for pod in pods:
            api.create_pod(json.loads(json.dumps(pod)))
            sched.run_until_idle()
            out.append(ts.placement(api, pod["metadata"]["name"]))
    finally:
        sched.stop()
    return out


@pytest.mark.parametrize("wire", WIRES)
def test_the_binary_places_a_seeded_stream_as_the_engine_in_process(
        tmp_path, wire):
    pods = _stream(seed={"json": 3, "stream": 4}[wire])
    want = _in_process_placements(pods)
    assert any(node for node, _ in want) and \
        any(node is None for node, _ in want)
    with served(*(f() for f in INVENTORIES)) as (api, url):
        binary = Binary(url, tmp_path, "--wire", wire)
        try:
            got = []
            for pod in pods:
                name = pod["metadata"]["name"]
                api.create_pod(pod)
                _wait(lambda: _bound(api, name) or _failed(api, name),
                      what=f"{name} bound or refused")
                got.append(ts.placement(api, name))
            assert got == want
            # the first pod's cycle, as its /debug/pod answer shows it
            first = next(p["metadata"]["name"] for p, (node, _) in
                         zip(pods, want) if node)
            doc = binary.get(f"/debug/pod/{first}")
            names = [s["name"] for s in doc["spans"]]
            assert "schedule_cycle" in names and doc["state"] == "bound"
            assert doc["proc"] == "scheduler"
            assert binary.metric("scheduler_schedule_attempts_total") >= \
                len(pods)
        finally:
            assert binary.stop() == 0, binary.stderr()


def _gang(gid: int, size: int, numgpu: int, prefix: str) -> list:
    return [ts.pod(f"{prefix}-{i}", numgpu, gang_id=gid, gang_size=size)
            for i in range(size)]


def test_a_gpu_gang_binds_all_or_nothing(tmp_path):
    big, pair = ts.free_gang_id(), None
    with served(fake.hgx_h100_inventory(), fake.hgx_h100_inventory()) as \
            (api, url):
        binary = Binary(url, tmp_path, "--wire", "stream")
        try:
            # three 8-card members over two 8-card hosts: none binds
            for pod in _gang(big, 3, 8, "big"):
                api.create_pod(pod)
            refused = _wait(lambda: [e for i in range(3)
                                     for e in _failed(api, f"big-{i}")],
                            what="the big gang's refusal")
            assert f"gang {big} of 3 does not fit" in refused[0]["message"]
            pair = next(g for g in range(big + 1, big + 200)
                        if g != big and _port_free(g))
            for pod in _gang(pair, 2, 8, "pair"):
                api.create_pod(pod)
            _wait(lambda: all(_bound(api, f"pair-{i}") for i in range(2)),
                  what="the pair gang")
            nodes = {_bound(api, f"pair-{i}") for i in range(2)}
            assert nodes == {"host0", "host1"}
            contracts = [ts.contract(api, f"pair-{i}") for i in range(2)]
            assert sorted(c["rank"] for c in contracts) == [0, 1]
            assert {c["gang"] for c in contracts} == {pair}
            assert not any(_bound(api, f"big-{i}") for i in range(3))
        finally:
            assert binary.stop() == 0, binary.stderr()


def _port_free(gid: int) -> bool:
    from kubegpu_tpu_torch.scheduler.gang import gang_coordinator_port

    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", gang_coordinator_port(gid)))
            return True
        except OSError:
            return False


def test_the_jax_binary_with_the_plugin_leaves_the_same_gang_buffered(
        tmp_path):
    gid = ts.free_gang_id()
    with served(fake.hgx_h100_inventory(), fake.hgx_h100_inventory()) as \
            (api, url):
        binary = Binary(url, tmp_path, "--scheduler-plugins-dir",
                        SCHEDULER_PLUGINS,
                        module="kubegpu_tpu.cmd.scheduler_main")
        try:
            for pod in _gang(gid, 2, 8, "pair"):
                api.create_pod(pod)
            # a plain pod after the gang binds: the binary is scheduling
            api.create_pod(ts.pod("solo", 1))
            _wait(lambda: _bound(api, "solo"), what="the solo pod")
            # the gang was planned and parked for a backoff: its attempt
            # is over, and it bound nothing
            _wait(lambda: any(binary.get(f"/debug/pod/pair-{i}")[
                "backoff_parks"] for i in range(2)),
                what="the gang's parked attempt")
            assert not _bound(api, "pair-0") and not _bound(api, "pair-1")
        finally:
            assert binary.stop() == 0, binary.stderr()


def test_a_tpu_pod_is_refused_with_an_event(tmp_path):
    info = jax_codec.kube_pod_to_pod_info(ts.pod("tpu", 1),
                                          invalidate_existing=False)
    info.running_containers["main"].requests["alpha.tpu/numchips"] = 4
    del info.running_containers["main"].requests[grammar.RESOURCE_NUM_GPU]
    tpu_pod = {"metadata": {"name": "tpu"}, "spec": {"containers": [
        {"name": "main"}]}}
    jax_codec.pod_info_to_annotation(tpu_pod["metadata"], info)
    with served(fake.hgx_h100_inventory()) as (api, url):
        binary = Binary(url, tmp_path)
        try:
            api.create_pod(tpu_pod)
            events = _wait(lambda: _failed(api, "tpu"), what="the refusal")
            assert "no device plugin serves alpha.tpu/numchips" in \
                events[-1]["message"]
            assert not _bound(api, "tpu")
        finally:
            assert binary.stop() == 0, binary.stderr()


def test_leader_election_binds_from_the_holder_and_fails_over(tmp_path):
    ttl = 1.0
    with served(fake.hgx_h100_inventory()) as (api, url):
        a = Binary(url, tmp_path, "--leader-elect", "--lease-ttl", str(ttl))
        b = Binary(url, tmp_path, "--leader-elect", "--lease-ttl", str(ttl))
        try:
            leader = _wait(lambda: next(
                (x for x in (a, b) if x.said("became leader")), None),
                what="a leader")
            standby = b if leader is a else a
            holder = api.lease_holder(scheduler_main.LEASE_NAME)
            assert holder.endswith(f"-{leader.proc.pid}")
            api.create_pod(ts.pod("first", 2))
            _wait(lambda: _bound(api, "first"), what="the first pod")
            assert not standby.said("became leader")
            assert standby.metric("scheduler_schedule_attempts_total") == 0
            assert leader.metric("scheduler_schedule_attempts_total") >= 1
            assert leader.metric("lease_transitions_total") == 1
            t0 = time.monotonic()
            leader.stop(signal.SIGKILL)
            api.create_pod(ts.pod("second", 2))
            _wait(lambda: _bound(api, "second"), timeout=3 * ttl + 2,
                  what="the standby's bind")
            assert time.monotonic() - t0 <= 3 * ttl
            assert standby.said("became leader")
            assert api.lease_holder(scheduler_main.LEASE_NAME).endswith(
                f"-{standby.proc.pid}")
        finally:
            a.stop()
            b.stop()
        assert standby.proc.returncode == 0, standby.stderr()


def _cards(annotations) -> set:
    """The cards a pod's allocation pins on its node (``.../gpu/<UUID>``
    prefixes)."""
    raw = (annotations or {}).get(codec.POD_ANNOTATION_KEY)
    if not raw:
        return set()
    info = codec.annotation_to_pod_info({"annotations": {
        codec.POD_ANNOTATION_KEY: raw}})
    return {grammar.gpu_prefix_from_path(p)
            for _, c, _ in info.all_containers()
            for p in c.allocate_from.values()
            if grammar.gpu_prefix_from_path(p)}


class _GPUArbiter:
    """A front door that refuses, with the per-pod detail the engine reads,
    a bind that would claim a card another bound pod holds, serialising
    the check with the write: what the JAX server's arbiter
    (`apiserver._bind_conflicts_locked`) does for TPU chips and not for
    GPU cards (ROADMAP Queue 3)."""

    def __init__(self, api):
        self.api = api
        self.lock = threading.Lock()
        self.refused = 0

    def _conflicts(self, bindings: dict, annotations: dict) -> dict:
        held = {}
        for pod in self.api.list_pods(bound=True):
            for card in _cards(pod["metadata"].get("annotations")):
                held[(pod["spec"]["nodeName"], card)] = \
                    pod["metadata"]["name"]
        per_pod = {}
        for name, node in sorted(bindings.items()):
            for card in sorted(_cards(annotations.get(name))):
                owner = held.setdefault((node, card), name)
                if owner != name:
                    per_pod[name] = f"card {card} on {node} taken by {owner}"
        return per_pod

    @contextlib.contextmanager
    def admit(self, method, parts, query, body, peer=""):
        if method == "POST" and parts == ["bindmany"]:
            bindings = body["bindings"]
            annotations = body.get("annotations") or {}
        elif method == "POST" and parts[:1] == ["pods"] and \
                parts[2:] == ["bind"]:
            # the engine wrote the allocation with a PUT just before
            bindings = {parts[1]: body["node"]}
            annotations = {parts[1]: self.api.get_pod(parts[1])[
                "metadata"].get("annotations")}
        else:
            yield "workload"
            return
        with self.lock:
            per_pod = self._conflicts(bindings, annotations)
            if per_pod:
                self.refused += 1
                raise JaxConflict("card taken", per_pod=per_pod)
            yield "workload"


def test_the_jax_arbiter_lets_two_pods_claim_one_gpu_card():
    """The JAX API server's arbiter keys claims by TPU chip paths only: two
    pods bound onto one GPU card both commit there, and `_GPUArbiter`
    refuses the second."""
    api = InMemoryAPIServer()
    GPUHost(api, "host0", fake.hgx_h100_inventory())
    _, _, sched = ts.cluster("port", fake.hgx_h100_inventory())
    sched.api._api.create_pod(ts.pod("a", 1))
    sched.run_until_idle()
    sched.stop()
    placed = sched.api._api.get_pod("a")
    ann = placed["metadata"]["annotations"]
    for name in ("a", "b"):
        api.create_pod(ts.pod(name, 1))
    api.bind_many({"a": "host0"}, {"a": ann})
    api.bind_many({"b": "host0"}, {"b": ann})
    assert _bound(api, "a") == _bound(api, "b") == "host0"
    assert _cards(api.get_pod("a")["metadata"]["annotations"]) == \
        _cards(api.get_pod("b")["metadata"]["annotations"]) != set()
    door = _GPUArbiter(api)
    api.create_pod(ts.pod("c", 1))
    with pytest.raises(JaxConflict) as err:
        with door.admit("POST", ["bindmany"], {}, {
                "bindings": {"c": "host0"}, "annotations": {"c": ann}}):
            pass
    assert set(err.value.per_pod) == {"c"}


def _card_claims(client) -> list:
    """``(node, card UUID)`` of every card a bound pod holds."""
    cards = []
    for pod in client.list_pods(bound=True):
        info = codec.kube_pod_to_pod_info(pod, False)
        node = pod["spec"]["nodeName"]
        for c in info.running_containers.values():
            cards += [(node, grammar.gpu_id_from_path(p))
                      for p in c.allocate_from.values()
                      if grammar.gpu_id_from_path(p)]
    return cards


def test_sharded_replicas_bind_every_pod_once(tmp_path):
    """Two ``kgtpu-gpu-scheduler --replicas 2 --shard I`` over a
    ``kgtpu-gpu-apiserver`` with eight fake HGX hosts, on each wire: a
    4-card gang of two and 40 one-card pods all bind, each once and on one
    node, no card is held by two pods (the port's arbiter refuses a card
    claimed twice), and both replicas commit some of the pods, the gang
    whole."""
    gid = ts.free_gang_id()
    for wire in WIRES:
        server = ta.APIServerBinary(REPO, "--wire", wire)
        client = HTTPAPIClient(server.url, wire=wire)
        reps = []
        try:
            binds = {}
            lock = threading.Lock()

            def watch(kind, event, obj):
                node = (obj.get("spec") or {}).get("nodeName")
                if kind == "pod" and node:
                    with lock:
                        binds.setdefault(obj["metadata"]["name"],
                                         set()).add(node)

            client.add_watcher(watch)
            for i in range(8):
                client.create_node(ta.gpu_node(f"host{i}", i))
            reps = [Binary(server.url, tmp_path, "--replicas", "2",
                           "--shard", str(s), "--lease-ttl", "1",
                           "--wire", wire) for s in range(2)]
            assert [r.said(f"scheduler replica {s}/2") for s, r in
                    enumerate(reps)] == [True, True]
            # until a replica has seen the other's lease it also takes the
            # other's vacant shard: the pods come once both are held and a
            # coordinator tick (a third of the TTL) has passed
            _wait(lambda: all(client.lease_holder(
                f"{lease.SHARD_LEASE_PREFIX}-{s}") for s in range(2)),
                what="both shard leases held")
            time.sleep(1.0)
            # the gang first: once the singles have spread over the hosts
            # no two of them may have four cards free
            for pod in _gang(gid, 2, 4, "g"):
                client.create_pod(pod)
            names = [f"r{i}" for i in range(40)]
            for name in names:
                client.create_pod(ts.pod(name, 1))
            names += ["g-0", "g-1"]
            _wait(lambda: all(p["spec"].get("nodeName") for p in
                              client.list_pods()) and
                  len(client.list_pods(bound=True)) == 42, timeout=60,
                  what="every pod bound")
            cards = _card_claims(client)
            assert len(cards) == 40 + 8 == len(set(cards))
            _wait(lambda: len(binds) == 42, what="the binds watched")
            assert all(len(binds[n]) == 1 for n in names)
            # each plain pod committed once, by one replica or the other
            commits = [r.metric("scheduler_binding_latency_microseconds_count")
                       for r in reps]
            assert sum(commits) == 40 and all(commits), commits
            gang_owner = reps[lease.shard_of(f"gang:{gid}", 2)]
            assert gang_owner.get("/debug/pod/g-0")["state"] == "bound"
        finally:
            for r in reps:
                assert r.stop() == 0, r.stderr()
            client.close()
            assert server.stop() == 0


def test_the_profiler_and_metrics_history_run_in_the_binary(tmp_path):
    """``--profile-dir`` installs the lock probe and the sampler before the
    client and engine exist, ``--metrics-interval-s`` the time-series;
    both answer on the health port while pods bind, and SIGTERM writes
    the profile."""
    prof = tmp_path / "profile"
    with served(fake.hgx_h100_inventory()) as (api, url):
        binary = Binary(url, tmp_path, "--profile-dir", str(prof),
                        "--profile-hz", "200", "--metrics-interval-s",
                        "0.05")
        try:
            for i in range(4):
                api.create_pod(ts.pod(f"p{i}", 2))
            _wait(lambda: all(_bound(api, f"p{i}") for i in range(4)),
                  what="four pods bound")
            status = _wait(lambda: (lambda d: d["active"] and {
                "sched-loop", "informer"} <= set(d["attribution"]["roles"])
                and d)(binary.get("/debug/profile")),
                what="the sampler seeing the loop and the informer")
            assert status["attribution"]["proc"] == "scheduler"
            history = _wait(lambda: (lambda d: d["active"] and any(
                snap["metrics"]["scheduler_schedule_attempts_total"]["v"]
                >= 4 for snap in d["series"]) and d)(
                binary.get("/metrics/history?limit=20")),
                what="a snapshot after the four attempts")
            assert history["interval_s"] == 0.05
            assert not prof.exists()
        finally:
            assert binary.stop() == 0, binary.stderr()
        pid = binary.proc.pid
        dumped = json.loads((prof / f"profile-{pid}.json").read_text())
        assert dumped["ticks"] > 0 and "sched-loop" in dumped["roles"]
        assert (prof / f"profile-{pid}.collapsed").read_text()


class _ConflictDoor:
    """A stand-in front door that refuses every commit of pod ``victim``
    with a 409 naming it, as a competing replica's win would."""

    @contextlib.contextmanager
    def admit(self, method, parts, query, body, peer=""):
        if method == "POST" and (
                (parts == ["bindmany"] and "victim" in
                 (body or {}).get("bindings", {}))
                or parts == ["pods", "victim", "bind"]):
            raise JaxConflict("card taken", per_pod={"victim": "card taken"})
        yield "workload"


def test_a_conflict_streak_writes_one_flight_dump(tmp_path):
    dumps = tmp_path / "flight"
    with served(fake.hgx_h100_inventory(), apf=_ConflictDoor()) as \
            (api, url):
        binary = Binary(url, tmp_path, "--flight-dir", str(dumps))
        try:
            api.create_pod(ts.pod("victim", 1))
            # a dump is written as .tmp, then renamed into place
            found = _wait(lambda: dumps.exists() and [
                f for f in os.listdir(dumps) if f.endswith(".json")],
                what="the flight dump")
            # the streak goes on (backoff retries); the dump does not
            _wait(lambda: len(binary.get("/debug/pod/victim")["spans"]) and
                  binary.get("/debug/pod/victim")["conflict_losses"] >= 5,
                  timeout=20, what="a longer streak")
            assert os.listdir(dumps) == found
            doc = json.loads((dumps / found[0]).read_text())
            assert doc["kind"] == "conflict_streak" and doc["pod"] == "victim"
            assert doc["detail"]["streak"] == 4
            assert binary.metric("flight_dumps_total") == 1
            assert not _bound(api, "victim")
        finally:
            assert binary.stop() == 0, binary.stderr()


@pytest.mark.parametrize("args,config,shard", [
    (("--replicas", "2", "--shard", "1"), None, "1/2"),
    ((), {"replicas": 3}, "0/3")],
    ids=["args0-None-10.7", "args1-config1-10.7"])
def test_flags_of_later_items_refuse_to_start(tmp_path, args, config, shard):
    """``--replicas`` above 1, once refused until the port had an API
    server whose arbiter keys GPU cards (ROADMAP item 10.7), now starts:
    on the command line and from the config, the binary runs against the
    port's server, takes its shard's lease and prints its replica line;
    SIGTERM releases the lease."""
    if config is not None:
        args = (*args, *_config(tmp_path, config))
    server, url = port_http.serve_api(port_api.InMemoryAPIServer())
    client = HTTPAPIClient(url)
    name = f"{lease.SHARD_LEASE_PREFIX}-{shard.split('/')[0]}"
    try:
        binary = Binary(url, tmp_path, "--lease-ttl", "3", *args)
        try:
            assert binary.said(f"scheduler replica {shard} (")
            holder = _wait(lambda: client.lease_holder(name),
                           what="the shard's lease")
            assert holder.endswith(f"-{binary.proc.pid}")
        finally:
            assert binary.stop() == 0, binary.stderr()
        assert client.lease_holder(name) is None
    finally:
        client.close()
        server.shutdown()


def _config(tmp_path, config: dict) -> tuple:
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return ("--config", str(path))


def test_tenant_quota_parks_a_tenant_over_its_weighted_share(tmp_path):
    """``--tenant-quota`` with ``tenantWeights`` {a: 3}: on one HGX host
    with 8 a-pods and 4 b-pods of one card pending before the binary
    starts, a binds its weighted share, 6 cards, and b its 2; the pods
    over a share park in the gate."""
    with served(fake.hgx_h100_inventory()) as (api, url):
        names = [f"a{i}" for i in range(8)] + [f"b{i}" for i in range(4)]
        for name in names:
            api.create_pod(ts.pod(name, 1,
                                  labels={"kgtpu.io/tenant": name[0]}))
        binary = Binary(url, tmp_path, "--tenant-quota",
                        *_config(tmp_path, {"tenantWeights": {"a": 3.0}}))
        try:
            _wait(lambda: sum(1 for n in names if _bound(api, n)) == 8,
                  what="8 pods bound")
            time.sleep(0.3)
            bound = [n for n in names if _bound(api, n)]
            assert [n[0] for n in sorted(bound)] == ["a"] * 6 + ["b"] * 2
            assert binary.metric("quota_parked_total") >= 1
        finally:
            assert binary.stop() == 0, binary.stderr()


def test_repair_takes_its_lease_and_moves_a_pod_off_a_failed_card(tmp_path):
    """``--repair`` elects the repair controller on ``REPAIR_LEASE``; a
    card of the bound pod fails, the controller evicts and requeues the
    pod, and the binary binds the copy off that card."""
    api = InMemoryAPIServer()
    hosts = [GPUHost(api, f"host{i}", fake.hgx_h100_inventory(host=i))
             for i in range(2)]
    with served(api=api) as (api, url):
        binary = Binary(url, tmp_path, "--repair", "--lease-ttl", "2")
        try:
            _wait(lambda: api.lease_holder(lease.REPAIR_LEASE),
                  what="the repair lease")
            api.create_pod(ts.pod("p", 8))
            node = _wait(lambda: _bound(api, "p"), what="the pod")
            _, alloc = ts.placement(api, "p")
            uuid = grammar.gpu_id_from_path(sorted(alloc["main"].values())[0])
            host = next(h for h in hosts if h.advertiser.node_name == node)
            host.backend.set_chip_health(uuid, "failed")
            host.advertiser.advertise_once()
            _wait(lambda: (ts.placement(api, "p") or (None,))[0] not in
                  (None, node), timeout=20, what="the pod rebound elsewhere")
            reasons = [e["reason"] for e in api.list_events("p")]
            assert {"CheckpointRequested", "Evicted"} <= set(reasons)
            _wait(lambda: "outcome=\"repaired\"} 1" in binary.get(
                "/metrics"), what="scheduler_repairs_total")
        finally:
            assert binary.stop() == 0, binary.stderr()
        # a clean stop hands the lease back
        assert api.lease_holder(lease.REPAIR_LEASE) is None


class _ExtenderStub:
    """A filter extender on loopback vetoing ``host0``."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        calls = self.calls = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                calls.append(body["pod"]["metadata"]["name"])
                keep = [n for n in body["nodeNames"] if n != "host0"]
                data = json.dumps({"nodeNames": keep, "failedNodes": {
                    "host0": "vetoed"}}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         kwargs={"poll_interval": 0.02}, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("where", ["config", "policy"])
def test_config_extenders_are_called(tmp_path, where):
    """An extender declared in the config (top level, or inside its
    policy) filters every pod: host0, which it vetoes, gets none."""
    stub = _ExtenderStub()
    declared = [{"urlPrefix": stub.url, "filterVerb": "filter"}]
    config = {"extenders": declared} if where == "config" else \
        {"policy": {"predicates": [{"name": "PodFitsResources"}],
                    "extenders": declared}}
    try:
        with served(fake.hgx_h100_inventory(0),
                    fake.hgx_h100_inventory(1)) as (api, url):
            binary = Binary(url, tmp_path, *_config(tmp_path, config))
            try:
                for i in range(3):
                    api.create_pod(ts.pod(f"p{i}", 2))
                nodes = [_wait(lambda i=i: _bound(api, f"p{i}"),
                               what=f"p{i}") for i in range(3)]
                assert nodes == ["host1"] * 3
                assert sorted(set(stub.calls)) == ["p0", "p1", "p2"]
            finally:
                assert binary.stop() == 0, binary.stderr()
    finally:
        stub.close()


def test_the_repair_elector_is_wired_as_jax_wires_it():
    """`start_repair_elector` twins the JAX binary's: nothing without
    ``--repair``; with it, an elector on ``REPAIR_LEASE`` under the
    holder's name that starts the controller, and stops it on demotion."""
    import argparse

    from kubegpu_tpu.cluster import lease as jax_lease
    from kubegpu_tpu.cmd import scheduler_main as jax_main

    assert lease.REPAIR_LEASE == jax_lease.REPAIR_LEASE
    for repair_on in (False, True):
        args = argparse.Namespace(repair=repair_on, lease_ttl=2.0)
        holders = []
        for start, client in (
                (scheduler_main.start_repair_elector,
                 ts.PortAPI(InMemoryAPIServer())),
                (jax_main.start_repair_elector, InMemoryAPIServer())):
            elector = start(client, args, "me")
            if not repair_on:
                assert elector is None
                continue
            try:
                _wait(lambda: client.lease_holder(lease.REPAIR_LEASE),
                      what="the repair lease")
                holders.append(client.lease_holder(lease.REPAIR_LEASE))
                controller = elector._on_acquire.__self__
                _wait(lambda: controller._thread is not None and
                      controller._thread.is_alive(), what="its loop")
            finally:
                elector.stop()
            assert not controller._thread.is_alive()
            assert type(controller).__name__ == "RepairController"
        assert holders == (["me", "me"] if repair_on else [])


@pytest.mark.parametrize("args,config,controller", [
    (("--node-grace-s", "5"), None, True),
    (("--node-stale-s", "2"), None, False),
    ((), {"node_grace_s": 5}, True)])
def test_the_node_lifecycle_flags_start_the_binary(tmp_path, args, config,
                                                   controller):
    """``--node-grace-s`` above 0 (on the command line or from the config
    file) starts the binary with its lifecycle elector, which takes the
    lifecycle lease and counts the Ready nodes; ``--node-stale-s`` alone
    leaves the grace at 0, so there is no controller (the JAX binary's
    rule)."""
    if config is not None:
        path = tmp_path / "config.json"
        path.write_text(json.dumps(config))
        args = (*args, "--config", str(path))
    with served(fake.hgx_h100_inventory(), fake.pcie_h100_inventory()) as \
            (api, url):
        binary = Binary(url, tmp_path, *args)
        try:
            assert binary.said("scheduler running")
            if controller:
                _wait(lambda: api.lease_holder(lease.LIFECYCLE_LEASE),
                      what="the lifecycle lease")
                _wait(lambda: binary.metric("scheduler_node_ready") == 2,
                      what="two Ready nodes")
            else:
                api.create_pod(ts.pod("p", 1))
                _wait(lambda: _bound(api, "p"), what="the pod")
                assert api.lease_holder(lease.LIFECYCLE_LEASE) is None
                assert binary.metric("scheduler_node_ready") == 0
        finally:
            assert binary.stop() == 0, binary.stderr()
        if controller:
            # a clean stop hands the lease back
            assert api.lease_holder(lease.LIFECYCLE_LEASE) is None


@pytest.mark.parametrize("wire", WIRES)
def test_a_node_whose_heartbeat_stops_loses_its_pod_to_another_node(
        tmp_path, wire):
    """Two hosts advertise; the binary binds an 8-card pod, then the
    pod's host stops stamping its heartbeat. The controller marks it
    Stale, then Lost, deletes the node, evicts the pod and requeues a copy
    without its cards, which the binary binds on the live host."""
    api = InMemoryAPIServer()
    hosts = {f"host{i}": GPUHost(api, f"host{i}", inv) for i, inv in
             enumerate((fake.hgx_h100_inventory(0),
                        fake.hgx_h100_inventory(1)))}
    alive = set(hosts)
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            for name in sorted(alive):
                hosts[name].advertiser.advertise_once()
            stop.wait(0.1)

    beater = threading.Thread(target=beat, daemon=True)
    beater.start()
    try:
        with served(api=api) as (api, url):
            binary = Binary(url, tmp_path, "--wire", wire, "--node-grace-s",
                            "1.5", "--node-stale-s", "0.5")
            try:
                api.create_pod(ts.pod("p", 8))
                first = _wait(lambda: _bound(api, "p"), what="the pod")
                _, cards = ts.placement(api, "p")
                alive.discard(first)
                other = next(n for n in hosts if n != first)
                # placement() answers None while the pod is evicted and
                # not yet requeued
                _wait(lambda: (ts.placement(api, "p") or (None,))[0] ==
                      other, timeout=20, what="the pod rebound on the live "
                      "host")
                _, moved = ts.placement(api, "p")
                assert set(moved["main"].values()).isdisjoint(
                    cards["main"].values())
                assert first not in {n["metadata"]["name"]
                                     for n in api.list_nodes()}
                reasons = {e["reason"] for e in api.list_events(first)}
                assert {"NodeLost"} <= reasons, reasons
                assert any(e["reason"] == "Evicted"
                           for e in api.list_events("p"))
                assert binary.metric("scheduler_node_lost_total") == 1
                assert binary.metric("scheduler_evictions_total") == 1
            finally:
                assert binary.stop() == 0, binary.stderr()
    finally:
        stop.set()
        beater.join()


def test_the_config_file_fills_in_what_the_command_line_leaves(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"lease_ttl": 3.0, "parallelism": 4,
                                "wire": "json", "replicas": 2}))
    args, config = scheduler_main.parse_args(
        ["--config", str(path), "--lease-ttl", "7"])
    assert (args.lease_ttl, args.parallelism, args.wire, args.replicas,
            args.bind_workers) == (7.0, 4, "json", 2, 4)
    assert config["lease_ttl"] == 3.0
    args, _ = scheduler_main.parse_args([])
    assert (args.lease_ttl, args.parallelism, args.wire) == \
        (15.0, 16, "stream")
