"""The port's watch-cache proxy (`kubegpu_tpu_torch/cluster/proxy.py`)
against its server and against the JAX package's proxy.

The six tests of ``tests/test_proxy.py`` on the port's proxy over the
port's `serve_api`; hop transparency (the seeded script of
`tests/torch_api.py` through the proxy gives the replies, typed errors and
watch stream the server gives straight); the same script through the JAX
proxy over the JAX server on TPU twins; the port's proxy over the JAX
server; the route tables; `_EventLog`'s proxy-mode ingest against JAX's;
a replay in which a card is claimed before its old holder's delete; and
the proxy metrics on ``/metrics``."""

import ast
import contextlib
import inspect
import random
import textwrap
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import apiserver as jax_api  # noqa: E402
from kubegpu_tpu.cluster import httpapi as jax_http  # noqa: E402
from kubegpu_tpu.cluster import proxy as jax_proxy  # noqa: E402
from kubegpu_tpu_torch.cluster import apiserver, httpapi, proxy, stream  # noqa: E402
from kubegpu_tpu_torch.cluster.apf import TooManyRequests  # noqa: E402
from kubegpu_tpu_torch.cluster.wal import WriteAheadLog  # noqa: E402
from tests import torch_api as ta  # noqa: E402
from tests.test_torch_apiserver_http import _normal, route  # noqa: E402

WIRES = ("stream", "json")


def _wait_for(pred, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture()
def upstream():
    api = apiserver.InMemoryAPIServer()
    server, url = httpapi.serve_api(api)
    try:
        yield api, url
    finally:
        server.shutdown()


# ---- the six tests of tests/test_proxy.py ----------------------------------

@pytest.mark.parametrize("wire", WIRES)
def test_reads_watch_and_forwarded_writes_through_proxy(upstream, wire):
    api, url = upstream
    prx = proxy.WatchCacheProxy(url, name="basic")
    client = httpapi.HTTPAPIClient(prx.url, wire=wire)
    direct = httpapi.HTTPAPIClient(url, wire=wire)
    seen: list = []
    client.add_watcher(
        lambda k, e, o: seen.append((e, o["metadata"]["name"])))
    try:
        client.create_pod({"metadata": {"name": "p1"}})
        # the write reached the source of truth
        assert api.get_pod("p1") is not None
        assert _wait_for(lambda: ("added", "p1") in seen)
        assert client.get_pod("p1")["metadata"]["name"] == "p1"
        assert client.relist_count == 0
        with pytest.raises(httpapi.NotFound) as via_proxy:
            client.get_pod("nope")
        with pytest.raises(httpapi.NotFound) as via_direct:
            direct.get_pod("nope")
        assert str(via_proxy.value) == str(via_direct.value)
        assert client.wire == wire
    finally:
        client.close()
        direct.close()
        prx.stop()


def test_resume_is_seq_exact_across_proxy_restart(upstream):
    api, url = upstream
    prx = proxy.WatchCacheProxy(url, name="restarted")
    port = int(prx.url.rsplit(":", 1)[1])
    client = httpapi.HTTPAPIClient(prx.url, wire="stream")
    seen: list = []
    client.add_watcher(
        lambda k, e, o: seen.append((e, o["metadata"]["name"])))
    try:
        api.create_pod({"metadata": {"name": "before"}})
        assert _wait_for(lambda: ("added", "before") in seen)
        prx.stop()
        # written while no proxy serves: the replacement carries it to the
        # resuming client from its own window
        api.create_pod({"metadata": {"name": "gap"}})
        prx = proxy.WatchCacheProxy(url, name="restarted2", port=port)
        api.create_pod({"metadata": {"name": "after"}})
        assert _wait_for(lambda: ("added", "after") in seen)
        assert seen.count(("added", "gap")) == 1
        assert seen.count(("added", "before")) == 1
        assert seen.count(("added", "after")) == 1
        assert client.relist_count == 0
        assert client.wire == "stream"
    finally:
        client.close()
        prx.stop()


def test_resume_across_wal_apiserver_restart_behind_live_proxy(tmp_path):
    api = apiserver.InMemoryAPIServer()
    server, url = httpapi.serve_api(
        api, wal=WriteAheadLog(str(tmp_path), fsync=False))
    port = int(url.rsplit(":", 1)[1])
    prx = proxy.WatchCacheProxy(url, name="over-wal")
    client = httpapi.HTTPAPIClient(prx.url, wire="stream")
    seen: list = []
    client.add_watcher(
        lambda k, e, o: seen.append((e, o["metadata"]["name"])))
    try:
        api.create_pod({"metadata": {"name": "before"}})
        assert _wait_for(lambda: ("added", "before") in seen)
        server.shutdown()
        api2 = apiserver.InMemoryAPIServer()
        server, _ = httpapi.serve_api(
            api2, port=port, wal=WriteAheadLog(str(tmp_path), fsync=False))
        api2.create_pod({"metadata": {"name": "after"}})
        assert _wait_for(lambda: ("added", "after") in seen, 15.0)
        assert seen.count(("added", "before")) == 1
        assert seen.count(("added", "after")) == 1
        assert client.relist_count == 0
    finally:
        client.close()
        prx.stop()
        server.shutdown()


def _pushes_until(conn, want: str, timeout_s: float = 10.0):
    """Read pushes until ``want`` arrives: ``(names, last seq, any
    relist)``."""
    names: list = []
    relist = False
    seq = 0
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and want not in names:
        out = conn.read_push(timeout=2.0)
        if out is None:
            continue
        relist = relist or bool(out.get("relist"))
        seq = out["seq"]
        names.extend(o["metadata"]["name"]
                     for _s, k, _e, o in out["events"] if k == "pod")
    assert want in names, f"never saw {want}, got {names}"
    return names, seq, relist


def test_migration_between_apiserver_and_proxy_is_seq_exact(upstream):
    api, url = upstream
    direct = stream.StreamConn.connect(url, 10.0)
    epoch = direct.subscribe(0, None, 0.0, timeout=10.0)["epoch"]
    api.create_pod({"metadata": {"name": "p0"}})
    _, cursor, relist = _pushes_until(direct, "p0")
    assert not relist
    direct.close()
    # the proxy syncs after p0: the cursor lies BELOW its floor, and only
    # the upstream backfill makes it resume instead of relist
    prx = proxy.WatchCacheProxy(url, name="migrate")
    try:
        api.create_pod({"metadata": {"name": "p1"}})
        via_proxy = stream.StreamConn.connect(prx.url, 10.0)
        ack = via_proxy.subscribe(cursor, None, 0.0, timeout=10.0)
        assert ack["epoch"] == epoch
        names, cursor, relist = _pushes_until(via_proxy, "p1")
        assert not relist and "p0" not in names
        via_proxy.close()
        # and back to the server at the proxy-advanced cursor
        api.create_pod({"metadata": {"name": "p2"}})
        direct = stream.StreamConn.connect(url, 10.0)
        assert direct.subscribe(cursor, None, 0.0,
                                timeout=10.0)["epoch"] == epoch
        names, _, relist = _pushes_until(direct, "p2")
        assert not relist and "p1" not in names
        direct.close()
    finally:
        prx.stop()


def test_torn_downstream_frame_never_severs_upstream(upstream):
    api, url = upstream
    prx = proxy.WatchCacheProxy(url, name="fuzzed")
    healthy = stream.StreamConn.connect(prx.url, 10.0)
    healthy.subscribe(0, None, 0.0, timeout=10.0)
    poisoned = stream.StreamConn.connect(prx.url, 10.0)
    poisoned.subscribe(0, None, 0.0, timeout=10.0)
    try:
        assert _wait_for(lambda: prx.downstream_watchers() == 2)
        poisoned._sock.sendall(b"\xde\xad\xbe\xef" * 8)
        assert _wait_for(lambda: prx.downstream_watchers() == 1), \
            "the poisoned connection was never severed"
        api.create_pod({"metadata": {"name": "alive"}})
        deadline = time.monotonic() + 10.0
        got: list = []
        while time.monotonic() < deadline and "alive" not in got:
            out = healthy.read_push(timeout=2.0)
            if out:
                assert not out.get("relist")
                got.extend(o["metadata"]["name"]
                           for _s, k, _e, o in out["events"])
        assert "alive" in got
        with pytest.raises(ConnectionError):
            for _ in range(10):
                poisoned.read_push(timeout=2.0)
    finally:
        healthy.close()
        poisoned.close()
        prx.stop()


def test_fanout_dedups_identical_filtered_windows():
    api = apiserver.InMemoryAPIServer()
    log = httpapi._EventLog(api)
    api.create_node({"metadata": {"name": "n1"}})
    frames = ([], [], [])
    log.add_stream_subscriber(frames[0].append, since=0, kinds=("pod",),
                              threaded=False)
    log.add_stream_subscriber(frames[1].append, since=log.seq(),
                              kinds=("pod",), threaded=False)
    log.add_stream_subscriber(frames[2].append, since=log.seq(),
                              threaded=False)
    e0, d0 = log.stream_encodes, log.stream_deliveries
    api.create_pod({"metadata": {"name": "p1"}})
    assert log.pump_once() == 3
    assert log.stream_deliveries - d0 == 3
    assert log.stream_encodes - e0 == 1
    assert frames[0] == frames[1] == frames[2]


# ---- the seeded script through a hop ---------------------------------------

class _ShedDoor:
    """A stand-in front door: a 429 with advice for every create of a pod
    named ``shed-*``, on both wires."""

    @contextlib.contextmanager
    def admit(self, method, parts, query=None, body=None, peer=""):
        if method == "POST" and parts == ["pods"] and \
                str(((body or {}).get("metadata") or {}).get(
                    "name", "")).startswith("shed-"):
            raise TooManyRequests("shed by the stand-in front door",
                                  retry_after_s=0.25)
        yield "workload"


def _script(seed: int) -> list:
    """`ta.script` with a shed create in every 25 ops."""
    ops = ta.script(seed)
    for i in range(len(ops) // 25):
        ops.insert(25 * (i + 1), ("create_pod", (ta.gpu_pod(f"shed-{i}"),)))
    return ops


def _watch_all(client) -> dict:
    status, doc = client.forward("GET", "/watch?since=0&timeout=0")
    assert status == 200 and not doc.get("relist")
    return doc


def _synced(prx, log) -> None:
    """Wait until the proxy's window reaches the upstream head: its reads
    then answer from a mirror that holds every write so far."""
    assert _wait_for(lambda: prx.event_log.seq() == log.seq())


@pytest.mark.parametrize("wire", WIRES)
def test_the_hop_is_transparent(wire):
    servers = [httpapi.serve_api(apiserver.InMemoryAPIServer(),
                                 apf=_ShedDoor()) for _ in range(2)]
    prx = proxy.WatchCacheProxy(servers[1][1], name="hop")
    direct = httpapi.HTTPAPIClient(servers[0][1], wire=wire)
    hop = httpapi.HTTPAPIClient(prx.url, wire=wire)
    try:
        statuses = set()
        card_409 = False
        for verb, args in _script(3):
            method, path, body = route(verb, args)
            want = direct.forward(method, path, body)
            got = hop.forward(method, path, body)
            assert got == want, (verb, args)
            statuses.add(got[0])
            card_409 |= got[0] == 409 and "/gpu/GPU-" in str(got[1])
            _synced(prx, servers[1][0].event_log)
        assert {200, 201, 403, 404, 409, 429} <= statuses and card_409
        # the typed errors, raised by the client through the hop as
        # straight at the server
        for fn, err in ((lambda c: c.get_pod("ghost"), httpapi.NotFound),
                        (lambda c: c.create_pod(ta.gpu_pod("shed-x")),
                         TooManyRequests)):
            with pytest.raises(err) as a:
                fn(direct)
            with pytest.raises(err) as b:
                fn(hop)
            assert str(a.value) == str(b.value)
            assert getattr(a.value, "retry_after_s", 0) == \
                getattr(b.value, "retry_after_s", 0)
        # a bound pod whose allocation pins a card
        pods = [p for p in direct.list_pods()
                if (p.get("spec") or {}).get("nodeName") and
                apiserver._pod_claims(p["metadata"].get("annotations"))[0]]
        victim = pods[0]
        thief = ta.gpu_pod("thief")
        for c in (direct, hop):
            c.create_pod(thief)
        bind = ({"thief": victim["spec"]["nodeName"]},
                {"thief": victim["metadata"]["annotations"]})
        with pytest.raises(httpapi.Conflict) as a:
            direct.bind_many(*bind)
        with pytest.raises(httpapi.Conflict) as b:
            hop.bind_many(*bind)
        assert a.value.per_pod == b.value.per_pod
        assert "/gpu/GPU-" in a.value.per_pod["thief"]
        _synced(prx, servers[1][0].event_log)
        mine, theirs = _watch_all(hop), _watch_all(direct)
        assert mine["epoch"] == servers[1][0].event_log.epoch
        assert mine["seq"] == theirs["seq"] > 40
        assert mine["events"] == theirs["events"]
        assert hop.wire == direct.wire == wire
    finally:
        hop.close()
        direct.close()
        prx.stop()
        for srv, _ in servers:
            srv.shutdown()


def _mask(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "epoch"}


def test_the_ports_proxy_equals_the_jax_proxy():
    servers = [httpapi.serve_api(apiserver.InMemoryAPIServer()),
               jax_http.serve_api(jax_api.InMemoryAPIServer())]
    proxies = [proxy.WatchCacheProxy(servers[0][1], name="port"),
               jax_proxy.WatchCacheProxy(servers[1][1], name="jax")]
    clients = [httpapi.HTTPAPIClient(p.url, wire="stream") for p in proxies]
    try:
        for verb, args in ta.script(1):
            method, path, body = route(verb, args)
            got = _normal(*clients[0].forward(method, path, body))
            want = _normal(*clients[1].forward(method, path, ta.twin(body)))
            if verb == "acquire_lease" and got[0] == 409:
                # a deliberate divergence: the JAX proxy rewrites a lease's
                # 409 (its body names the holder) into an error body; the
                # port's passes it as the server sent it
                assert want == (409, {"error": str(got[1]), "per_pod": {}})
                continue
            assert got == want, (verb, args)
            for p, (srv, _) in zip(proxies, servers):
                _synced(p, srv.event_log)
        mine = _normal(*clients[0].forward("GET", "/watch?since=0&timeout=0"))
        theirs = _normal(*clients[1].forward("GET",
                                             "/watch?since=0&timeout=0"))
        assert (mine[0], _mask(mine[1])) == (theirs[0], _mask(theirs[1]))
        assert len(mine[1]["events"]) > 20
    finally:
        for c in clients:
            c.close()
        for p in proxies:
            p.stop()
        for srv, _ in servers:
            srv.shutdown()


def test_the_ports_proxy_mirrors_the_jax_server():
    server, url = jax_http.serve_api(jax_api.InMemoryAPIServer())
    proxies = [proxy.WatchCacheProxy(url, name="port"),
               jax_proxy.WatchCacheProxy(url, name="jax")]
    clients = [httpapi.HTTPAPIClient(p.url, wire="stream") for p in proxies]
    try:
        for verb, args in ta.script(2):
            method, path, body = route(verb, args)
            clients[0].forward(method, path, ta.twin(body))
        for p in proxies:
            _synced(p, server.event_log)
        docs = [c.forward("GET", "/watch?since=0&timeout=0")
                for c in clients]
        assert docs[0] == docs[1] and len(docs[0][1]["events"]) > 20
        for path in ("/pods", "/nodes", "/events", "/pvcs", "/quotas"):
            mine, theirs = (c.forward("GET", path) for c in clients)
            if path == "/quotas":
                # chips_created is each mirror's own count of its pods'
                # devices: the port's counts GPU cards, which TPU twins
                # ask none of
                for _, doc in (mine, theirs):
                    for spec in doc["items"].values():
                        spec.pop("chips_created")
            assert mine == theirs, path
    finally:
        for c in clients:
            c.close()
        for p in proxies:
            p.stop()
        server.shutdown()


# ---- route tables, ingest, replay, metrics ---------------------------------

def _served_segments() -> set:
    """Every first path segment the port's `_route_request` answers with
    something other than its no-route 404, probed with each string literal
    of its source on every verb and path depth."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(
        httpapi._route_request)))
    words = {n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.isidentifier() and n.value.islower()}
    served = set()
    for word in sorted(words):
        for method in ("GET", "POST", "PUT", "PATCH", "DELETE"):
            for parts in ([word], [word, "x"], [word, "x", "annotations"],
                          [word, "x", "bind"], [word, "x", "metadata"],
                          [word, "pod", "x"], [word, "history"]):
                api = apiserver.InMemoryAPIServer()
                log = httpapi._EventLog(api)
                try:
                    status, doc = httpapi._route_request(
                        api, log, method, parts, {"timeout": "0"}, {})
                except Exception:
                    served.add(word)  # answered, with a typed error
                    continue
                if not (status == 404 and "no route" in str(doc)):
                    served.add(word)
    return served


def test_the_route_tables_equal_jax_and_cover_every_served_segment():
    assert proxy.LOCAL_ROUTES == jax_proxy.LOCAL_ROUTES
    assert proxy.FORWARDED_ROUTES == jax_proxy.FORWARDED_ROUTES
    served = _served_segments()
    assert {"pods", "nodes", "leases", "watch", "bindmany"} <= served
    assert served <= proxy.LOCAL_ROUTES | proxy.FORWARDED_ROUTES, \
        served - (proxy.LOCAL_ROUTES | proxy.FORWARDED_ROUTES)


def _batch(rng, lo: int, hi: int) -> list:
    seqs = sorted(rng.sample(range(lo, hi), min(hi - lo, rng.randint(1, 8))))
    rng.shuffle(seqs)  # a coalesced batch interleaves seqs across objects
    return [(s, rng.choice(("pod", "node")), rng.choice(("added", "deleted")),
             {"metadata": {"name": f"o{s % 5}"}, "v": s}) for s in seqs]


@pytest.mark.parametrize("seed", range(8))
def test_proxy_mode_ingest_equals_jax(seed):
    rng = random.Random(seed)
    logs = [httpapi._EventLog(apiserver.InMemoryAPIServer(), limit=12,
                              attach=False),
            jax_http._EventLog(jax_api.InMemoryAPIServer(), limit=12,
                               attach=False)]
    head = rng.randint(20, 40)
    ops = [("reset", (head, "e0"))]
    for _ in range(30):
        r = rng.random()
        if r < 0.7:
            nxt = head + rng.randint(1, 6)
            ops.append(("ingest", (_batch(rng, head - 2, nxt + 1), nxt)))
            head = nxt
        elif r < 0.9:
            floor = rng.randint(max(0, head - 30), head)
            ops.append(("backfill", (_batch(rng, floor - 3, head + 1),
                                     floor)))
        else:
            head = rng.randint(head - 5, head + 5)
            ops.append(("reset", (head, f"e{rng.randrange(3)}")))
    for name, args in ops:
        states = []
        for log in logs:
            getattr(log, name)(*args)
            states.append((log.seq(), log.floor(), log.epoch,
                           list(log._events),
                           [log.since(s, timeout=0)
                            for s in range(log.floor() - 2, log.seq() + 3)]))
        assert states[0] == states[1], (name, args)
    # a proxy-mode log never records its store's own writes
    api = apiserver.InMemoryAPIServer()
    log = httpapi._EventLog(api, attach=False)
    api.create_node({"metadata": {"name": "n"}})
    assert log.seq() == 0 and log.tail(5) == []


def test_the_mirror_takes_a_card_claimed_before_its_old_holders_delete():
    """Replayed with the claims coalesced out of order: b's bind on card 3
    arrives before a's delete that freed it. The mirror applies every
    record, and its index ends with b holding the card."""
    old = ta.gpu_pod("a", 1, alloc=(0, (3,)))
    new = ta.gpu_pod("b", 1, alloc=(0, (3,)))
    for pod in (old, new):
        pod["spec"]["nodeName"] = "host0"
    mirror = apiserver.InMemoryAPIServer()
    for kind, event, obj in (("node", "added", ta.gpu_node("host0")),
                             ("pod", "added", old), ("pod", "added", new),
                             ("pod", "deleted", old)):
        mirror.restore_object(kind, event, obj)
    assert [p["metadata"]["name"] for p in mirror.list_pods()] == ["b"]
    mirror.create_pod(ta.gpu_pod("c"))
    with pytest.raises(apiserver.Conflict) as err:
        mirror.bind_many({"c": "host0"},
                         {"c": new["metadata"]["annotations"]})
    assert "b" in err.value.per_pod["c"]
    # and through a live proxy: the events applied in that order
    server, url = httpapi.serve_api(apiserver.InMemoryAPIServer())
    prx = proxy.WatchCacheProxy(url, name="replay")
    try:
        assert prx._apply({"events": [
            (1, "node", "added", ta.gpu_node("host0")),
            (2, "pod", "added", new), (3, "pod", "deleted", old)],
            "seq": 3, "epoch": prx.event_log.epoch})
        assert [p["metadata"]["name"] for p in prx._mirror.list_pods()] == \
            ["b"]
    finally:
        prx.stop()
        server.shutdown()


def test_the_proxy_metrics_are_on_its_metrics_route(upstream):
    api, url = upstream
    prx = proxy.WatchCacheProxy(url, name="metered")
    watcher = stream.StreamConn.connect(prx.url, 10.0)
    watcher.subscribe(0, None, 0.0, timeout=10.0)
    try:
        # the gauge is read at each applied upstream batch: write once the
        # subscriber is registered
        assert _wait_for(lambda: prx.downstream_watchers() == 1)
        api.create_pod({"metadata": {"name": "m"}})
        assert watcher.read_push(timeout=10.0) is not None

        def scrape() -> str:
            with urllib.request.urlopen(prx.url + "/metrics",
                                        timeout=10) as r:
                return r.read().decode()
        # the gauge is set once the batch is applied, which may be just
        # after the push went out
        assert _wait_for(lambda: 'proxy_downstream_watchers{proxy="metered"}'
                         ' 1' in scrape())
        text = scrape()
        assert "proxy_upstream_lag_ms_count" in text
        count = [ln for ln in text.splitlines()
                 if ln.startswith("proxy_upstream_lag_ms_count")][0]
        assert float(count.split()[-1]) >= 1
        assert 'transport_bytes_total{wire="proxy",dir="rx"}' in text
    finally:
        watcher.close()
        prx.stop()


# ---- kgtpu-gpu-proxy as a subprocess ---------------------------------------

def test_the_proxy_binary_fronts_the_apiserver_binary():
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    server = ta.APIServerBinary(repo)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.cmd.proxy_main",
         "--upstream", server.url, "--port", "0", "--name", "p9", "--apf"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    clients = []
    try:
        line = proc.stdout.readline()
        assert line.startswith("proxy p9 listening at http://127.0.0.1:"), \
            (line, proc.stderr.read()[-3000:] if proc.poll() is not None
             else "")
        assert line.strip().endswith(
            f"(upstream {server.url}) (APF front door on)")
        url = line.split()[4]
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert r.status == 200
        direct = httpapi.HTTPAPIClient(server.url, wire="stream")
        clients.append(direct)
        for wire in WIRES:
            client = httpapi.HTTPAPIClient(url, wire=wire)
            clients.append(client)
            seen = []
            client.add_watcher(lambda k, e, o: seen.append(
                o["metadata"]["name"]))
            name = f"via-{wire}"
            client.create_node(ta.gpu_node(name))          # forwarded
            assert direct.get_node(name)["metadata"]["name"] == name
            assert _wait_for(lambda: name in seen)
            # the mirror answers, the watch having announced it
            assert client.get_node(name) == direct.get_node(name)
            assert client.wire == wire and client.relist_count == 0
    finally:
        for c in clients:
            c.close()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=15)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
            proc.stderr.close()
        server.stop()
    assert rc == 0
