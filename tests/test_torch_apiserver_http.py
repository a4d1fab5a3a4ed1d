"""The port's API server on both wires (`kubegpu_tpu_torch/cluster/httpapi.py`
`serve_api`) against the JAX package's: the seeded script of
`tests/torch_api.py` goes through the port's client (`forward`, which
returns every status raw) to each server, the JAX one on TPU twins, and
gives equal status codes, bodies and watch logs ``(seq, kind, event,
obj)``, the epoch masked. The JAX client talks to the port's server on the
stream wire; a cursor below the floor is answered with ``relist`` on both
wires; a server without the stream wire negotiates the client down to
JSON; ``coalesce_events`` equals JAX's; ``api_requests_total{server}``
counts each request."""

import io
import json
import random
import time
import urllib.parse
import urllib.request

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import apiserver as jax_api  # noqa: E402
from kubegpu_tpu.cluster import httpapi as jax_http  # noqa: E402
from kubegpu_tpu_torch.cluster import apiserver, httpapi, stream  # noqa: E402
from tests import torch_api as ta  # noqa: E402

WIRES = ("stream", "json")
_OWNERS = {"pdb": "pdbs", "service": "services", "rc": "rcs", "rs": "rss",
           "statefulset": "statefulsets", "pv": "pvs", "pvc": "pvcs"}


def route(verb: str, args: tuple) -> tuple:
    """``(method, path, body)`` of one op of `ta.script` on the wire."""
    q = urllib.parse.quote
    if verb.startswith("create_"):
        kind = verb[len("create_"):]
        return "POST", "/" + _OWNERS.get(kind, kind + "s"), args[0]
    if verb.startswith("delete_") and verb != "delete_quota":
        kind = verb[len("delete_"):]
        return "DELETE", f"/{_OWNERS.get(kind, kind + 's')}/{args[0]}", None
    if verb.startswith("list_") and verb != "list_events":
        kind = verb[len("list_"):-1]
        return "GET", "/" + _OWNERS.get(kind, kind + "s"), None
    table = {
        "patch_node_metadata": lambda n, p: ("PATCH", f"/nodes/{n}/metadata",
                                             p),
        "update_pod_annotations": lambda n, a: (
            "PUT", f"/pods/{n}/annotations", a),
        "update_pod_annotations_many": lambda a: ("PUT", "/podannotations",
                                                  a),
        "bind_pod": lambda n, node: ("POST", f"/pods/{n}/bind",
                                     {"node": node}),
        "bind_many": lambda b, a: ("POST", "/bindmany",
                                   {"bindings": b, "annotations": a}),
        "bind_volume": lambda pv, c: ("POST", "/bindvolume",
                                      {"pv": pv, "pvc": c}),
        "record_event": lambda k, n, t, r, m: ("POST", "/events", {
            "kind": k, "name": n, "type": t, "reason": r, "message": m}),
        "record_events": lambda evs: ("POST", "/events", evs),
        "set_quota": lambda t, spec: ("PUT", f"/quotas/{t}", spec),
        "delete_quota": lambda t: ("DELETE", f"/quotas/{t}", None),
        "acquire_lease": lambda n, h, ttl: ("POST", f"/leases/{n}",
                                            {"holder": h, "ttl": ttl}),
        "release_lease": lambda n, h: ("DELETE",
                                       f"/leases/{n}?holder={q(h)}", None),
        "lease_holder": lambda n: ("GET", f"/leases/{n}", None),
        "list_events": lambda n=None: ("GET", "/events" + (
            f"?involved={q(n)}" if n else ""), None),
        "get_pod": lambda n: ("GET", f"/pods/{n}", None),
    }
    return table[verb](*args)


def _normal(status: int, doc):
    """A reply in GPU spelling, its error text in the port's words."""
    doc = ta.untwin(doc)
    if status >= 400 and isinstance(doc, dict) and "error" in doc:
        doc["error"] = doc["error"].replace("chip ", "card ")
        doc["per_pod"] = {k: v.replace("chip ", "card ")
                          for k, v in doc.get("per_pod", {}).items()}
    return status, doc


class Pair:
    """The port's and the JAX server, each with the port's client on
    ``wire``."""

    def __init__(self, wire: str, max_events: int = 12, **kw):
        self.apis = (apiserver.InMemoryAPIServer(),
                     jax_api.InMemoryAPIServer())
        for api in self.apis:
            api.MAX_EVENTS = max_events
        self.servers = [httpapi.serve_api(self.apis[0], **kw),
                        jax_http.serve_api(self.apis[1], **kw)]
        self.clients = [httpapi.HTTPAPIClient(url, wire=wire)
                        for _, url in self.servers]

    def both(self, method, path, body=None):
        """The port's reply and the JAX one's, normalised."""
        got = _normal(*self.clients[0].forward(method, path, body))
        want = _normal(*self.clients[1].forward(method, path,
                                                ta.twin(body)))
        return got, want

    def logs(self):
        return [ta.untwin([list(e) for e in srv.event_log._events])
                for srv, _ in self.servers]

    def close(self):
        for client in self.clients:
            client.close()
        for srv, _ in self.servers:
            srv.shutdown()


@pytest.fixture(params=WIRES)
def pair(request):
    p = Pair(request.param)
    yield p
    p.close()
    assert all(c.wire == request.param for c in p.clients)


def _mask(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "epoch"}


@pytest.mark.parametrize("seed", range(3))
def test_a_seeded_script_gives_equal_replies_and_logs(pair, seed):
    statuses = set()
    for verb, args in ta.script(seed):
        got, want = pair.both(*route(verb, args))
        assert got == want, (verb, args)
        statuses.add(got[0])
    assert {200, 201, 403, 404, 409} <= statuses
    port_log, jax_log = pair.logs()
    assert port_log == jax_log and len(port_log) > 40
    head = port_log[-1][0]
    for since in (0, head // 2, head):
        got, want = pair.both("GET", f"/watch?since={since}&timeout=0")
        assert (got[0], _mask(got[1])) == (want[0], _mask(want[1]))
        assert got[1]["seq"] == head
    assert pair.apis[0].dump_state() == ta.untwin(
        pair.apis[1].dump_state())


def test_the_jax_client_talks_to_the_ports_server():
    api = apiserver.InMemoryAPIServer()
    server, url = httpapi.serve_api(api)
    client = jax_http.HTTPAPIClient(url, wire="stream")
    try:
        seen = []
        client.add_watcher(lambda k, e, o: seen.append(
            (k, o["metadata"]["name"], (o.get("spec") or {}).get("nodeName"))))
        client.create_node(ta.gpu_node("host0"))
        ann = ta.gpu_pod("x", 1, alloc=(0, (2,)))["metadata"]["annotations"]
        for name in ("a", "b"):
            client.create_pod(ta.gpu_pod(name))
        client.bind_many({"a": "host0"}, {"a": ann})
        with pytest.raises(jax_api.Conflict) as err:
            client.bind_many({"b": "host0"}, {"b": ann})
        assert set(err.value.per_pod) == {"b"}
        with pytest.raises(jax_api.NotFound):
            client.get_pod("ghost")
        assert client.get_pod("a")["spec"]["nodeName"] == "host0"
        # a push may fold a's add and bind into one event: wait for the
        # bind, in whichever event it rides
        deadline = time.monotonic() + 10
        while ("pod", "a", "host0") not in seen and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert ("pod", "a", "host0") in seen
        assert {s[:2] for s in seen} == {("node", "host0"), ("pod", "a"),
                                        ("pod", "b")}
        assert client.wire == "stream" and \
            server.event_log.stream_subscriber_count() == 1
    finally:
        client.close()
        server.shutdown()


def test_a_cursor_below_the_floor_is_answered_with_relist():
    p = Pair("json")
    try:
        for srv, _ in p.servers:
            srv.event_log.limit = 4
        for i in range(10):
            p.both("POST", "/nodes", {"metadata": {"name": f"n{i}"}})
        got, want = p.both("GET", "/watch?since=1&timeout=0")
        assert got[1]["relist"] is True and got[1]["events"] == []
        assert (got[0], _mask(got[1])) == (want[0], _mask(want[1]))
        # the stream wire pushes the same signal after the SUB
        for _, url in p.servers:
            conn = stream.StreamConn.connect(url, 10.0)
            try:
                ack = conn.subscribe(1, None, 0.0, timeout=10.0)
                push = conn.read_push(timeout=10.0)
                while push is None:
                    push = conn.read_push(timeout=10.0)
                assert push["relist"] and push["seq"] == ack["seq"] == 10
            finally:
                conn.close()
    finally:
        p.close()


def test_without_the_stream_wire_the_client_negotiates_down_to_json():
    server, url = httpapi.serve_api(apiserver.InMemoryAPIServer(),
                                    stream_wire=False)
    client = httpapi.HTTPAPIClient(url, wire="stream")
    try:
        with pytest.raises(stream.StreamUnsupported):
            stream.StreamConn.connect(url, 5.0)
        client.create_node({"metadata": {"name": "n"}})
        assert client.wire == "json"
        assert client.list_nodes()[0]["metadata"]["name"] == "n"
    finally:
        client.close()
        server.shutdown()


def test_the_server_counts_refused_upgrades_and_poisoned_connections():
    """The event log's fault counts: one refused upgrade for each client
    that negotiates down (its latch holds over later calls), and one
    poisoned connection for each torn stream."""
    plain, plain_url = httpapi.serve_api(apiserver.InMemoryAPIServer(),
                                         stream_wire=False)
    wired, wired_url = httpapi.serve_api(apiserver.InMemoryAPIServer())
    clients = [httpapi.HTTPAPIClient(plain_url, wire="stream")
               for _ in range(2)]
    conn = stream.StreamConn.connect(wired_url, 5.0)
    try:
        for i, client in enumerate(clients):
            for _ in range(3):
                client.create_node({"metadata": {"name": f"n{i}-{_}"}})
            assert plain.event_log.upgrades_refused == i + 1
        assert plain.event_log.stream_poisoned == 0
        conn._sock.sendall(b"\xde\xad\xbe\xef" * 8)
        deadline = time.monotonic() + 10
        while wired.event_log.stream_poisoned == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert wired.event_log.stream_poisoned == 1
        assert wired.event_log.upgrades_refused == 0
    finally:
        conn.close()
        for client in clients:
            client.close()
        plain.shutdown()
        wired.shutdown()


def _events(rng) -> list:
    out = []
    for seq in range(1, rng.randint(2, 40)):
        name = rng.choice("abcd")
        obj = {"metadata": {"name": name}, "v": seq} \
            if rng.random() < 0.95 else {"nameless": seq}
        out.append((seq, rng.choice(("pod", "node")),
                    rng.choice(("added", "modified", "modified",
                                "deleted")), obj))
    return out


@pytest.mark.parametrize("seed", range(20))
def test_coalescing_equals_jax(seed):
    events = _events(random.Random(seed))
    assert httpapi.coalesce_events(list(events)) == \
        jax_http.coalesce_events(list(events))


def _requests_total(url: str) -> float:
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith('api_requests_total{server="apiserver"}'):
            return float(line.split()[-1])
    raise AssertionError("no api_requests_total in /metrics")


@pytest.mark.parametrize("wire", WIRES)
def test_api_requests_total_counts_each_request(wire):
    server, url = httpapi.serve_api(apiserver.InMemoryAPIServer())
    client = httpapi.HTTPAPIClient(url, wire=wire)
    try:
        before = _requests_total(url)
        for i in range(7):
            client.create_node({"metadata": {"name": f"n{i}"}})
        with pytest.raises(httpapi.NotFound):
            client.get_node("ghost")
        # the seven creates, the refused GET and this /metrics itself
        assert _requests_total(url) == before + 9
        assert json.loads(urllib.request.urlopen(
            url + "/healthz", timeout=10).read()) == {"ok": True}
    finally:
        client.close()
        server.shutdown()


def test_an_idle_watch_is_severed_by_the_jax_server_and_kept_by_the_port():
    """The JAX server sets a subscribed connection's socket timeout (10 s)
    to bound its pushes' sends, and its reader then times out on the idle
    connection, which leaves the buffered reader unusable: every idle
    watch is severed and redialled each 10 s (ROADMAP Queue 3). The
    port's reader waits for input without the timeout: the watch stays
    on one connection."""
    servers = [jax_http.serve_api(jax_api.InMemoryAPIServer()),
               httpapi.serve_api(apiserver.InMemoryAPIServer())]
    clients = [httpapi.HTTPAPIClient(url, wire="stream")
               for _, url in servers]
    try:
        for client in clients:
            client.add_watcher(lambda k, e, o: None)
        time.sleep(13.0)
        assert clients[0].watch_errors >= 1 and clients[1].watch_errors == 0
        # the port's watch still delivers on its first connection
        seen = []
        clients[1].add_watcher(lambda k, e, o: seen.append(k))
        clients[1].create_node({"metadata": {"name": "n"}})
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.02)
        assert seen == ["node"] and clients[1].watch_errors == 0
    finally:
        for client in clients:
            client.close()
        for server, _ in servers:
            server.shutdown()


def test_the_pump_encodes_a_window_once_for_every_subscriber():
    """Subscribers at one cursor get the same frame bytes from one encode,
    and so does one at another cursor whose kinds filter passes the same
    events."""
    from kubegpu_tpu_torch.core import codec

    api = apiserver.InMemoryAPIServer()
    log = httpapi._EventLog(api)
    got = [[] for _ in range(4)]
    for i in range(3):
        log.add_stream_subscriber(got[i].append, since=0, threaded=False)
    for i in range(4):
        api.create_node({"metadata": {"name": f"n{i}"}})
    assert log.pump_once() == 3
    assert (log.stream_encodes, log.stream_deliveries) == (1, 3)
    assert got[0] == got[1] == got[2] and len(got[0]) == 1
    _, _, payload = stream.read_frame(io.BytesIO(got[0][0]))
    batch = codec.decode_watch_batch(payload)
    assert [e[0] for e in batch["events"]] == [1, 2, 3, 4]
    assert batch["seq"] == 4 and batch["epoch"] == log.epoch
    log.add_stream_subscriber(got[3].append, since=2, kinds=("pod",),
                              threaded=False)
    api.create_pod({"metadata": {"name": "p"}})
    assert log.pump_once() == 4
    # the pod watcher at cursor 2 sees only seq 5, as the three at 4 do
    assert (log.stream_encodes, log.stream_deliveries) == (2, 7)
    assert got[3] == [got[0][1]]
    _, _, payload = stream.read_frame(io.BytesIO(got[3][0]))
    assert [e[:2] for e in codec.decode_watch_batch(payload)["events"]] == \
        [(5, "pod")]
