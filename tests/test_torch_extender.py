"""Scheduler extenders in the port (kubegpu_tpu_torch/scheduler/extender.py):
the port's `HTTPExtender` and the JAX package's call one local HTTP stub
and must send the same requests and return the same results — filter,
prioritize (a malformed reply and a refused connection score nothing),
bind (an error reply raises), an ignorable extender that fails passes
every node, a failing one that is not raises — and `load_extenders` reads
one config alike. Through the port's engine on fake HGX hosts, a node a
filter extender vetoes is never chosen, a prioritize extender steers the
placement, and a bind-verb extender owns the binding."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.scheduler import extender as jax_ext  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler import extender  # noqa: E402
from tests.torch_sched import cluster, placement, pod  # noqa: E402


class Stub:
    """An extender on loopback: ``replies[verb]`` is a function of the
    request body giving ``(status, reply body)``; every request is kept in
    ``calls`` as ``(verb, body)``."""

    def __init__(self, replies):
        self.replies = replies
        self.calls: list = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                verb = self.path.lstrip("/")
                stub.calls.append((verb, body))
                status, reply = stub.replies[verb](body)
                data = reply if isinstance(reply, bytes) else \
                    json.dumps(reply).encode()
                self.send_response(status)
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


def _veto(name):
    def reply(body):
        keep = [n for n in body["nodeNames"] if n != name]
        failed = {name: "vetoed by stub"} if name in body["nodeNames"] \
            else {}
        return 200, {"nodeNames": keep, "failedNodes": failed}
    return reply


def _scores(table):
    return lambda body: (200, [{"host": n, "score": table.get(n, 0)}
                               for n in body["nodeNames"]])


@pytest.fixture
def stub():
    made = []

    def build(replies):
        made.append(Stub(replies))
        return made[-1]
    yield build
    for s in made:
        s.close()


def _both(url, **kw):
    return (extender.HTTPExtender(url, **kw), jax_ext.HTTPExtender(url, **kw))


def _pair_calls(s, port_fn, jax_fn):
    """Run the port's call then the JAX one: both results and both
    requests."""
    n = len(s.calls)
    a = port_fn()
    b = jax_fn()
    return a, b, s.calls[n:]


@pytest.mark.parametrize("nodes", [["host0", "host1", "host2"], ["host1"],
                                   []])
def test_filter_sends_and_reads_what_jax_does(stub, nodes):
    s = stub({"filter": _veto("host1")})
    port, ref = _both(s.url, filter_verb="filter")
    p = pod("p", 2)
    a, b, calls = _pair_calls(s, lambda: port.filter(p, nodes),
                              lambda: ref.filter(p, nodes))
    assert a == b
    assert calls[0] == calls[1] == ("filter", {"pod": p, "nodeNames": nodes})
    assert "host1" not in a[0]


def test_a_filter_reply_without_node_names_keeps_every_node(stub):
    s = stub({"filter": lambda body: (200, {"failedNodes": {"x": "no"}})})
    port, ref = _both(s.url, filter_verb="filter")
    p = pod("p", 1)
    a, b, _ = _pair_calls(s, lambda: port.filter(p, ["a", "b"]),
                          lambda: ref.filter(p, ["a", "b"]))
    assert a == b == (["a", "b"], {"x": "no"})


@pytest.mark.parametrize("reply", [
    lambda body: (200, [{"host": "host0", "score": 7},
                        {"host": "host1", "score": 3}, {"host": "zz"}]),
    lambda body: (200, {"error": "not a list"}),
    lambda body: (200, [1, "x", {"host": "host0"}]),
    lambda body: (500, b"boom")])
def test_prioritize_sends_and_reads_what_jax_does(stub, reply):
    s = stub({"prioritize": reply})
    port, ref = _both(s.url, prioritize_verb="prioritize", weight=2.0)
    p = pod("p", 1)
    nodes = ["host0", "host1"]
    a, b, calls = _pair_calls(s, lambda: port.prioritize(p, nodes),
                              lambda: ref.prioritize(p, nodes))
    assert a == b
    assert calls[0] == calls[1]


@pytest.mark.parametrize("reply,raises", [
    (lambda body: (200, {}), False),
    (lambda body: (200, {"error": "no room"}), True),
    (lambda body: (500, b"down"), True)])
def test_bind_sends_and_reads_what_jax_does(stub, reply, raises):
    s = stub({"bind": reply})
    port, ref = _both(s.url, bind_verb="bind")
    outcomes = []
    for ext, exc in ((port, extender.ExtenderError),
                     (ref, jax_ext.ExtenderError)):
        try:
            ext.bind("p", "host0")
            outcomes.append(None)
        except exc as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == raises
    assert s.calls == [("bind", {"podName": "p", "node": "host0"})] * 2


@pytest.mark.parametrize("ignorable", [True, False])
def test_a_failing_filter_extender(ignorable):
    """A refused connection: ignorable passes every node, otherwise the
    filter raises, in both packages."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{sock.getsockname()[1]}"
    port, ref = _both(url, filter_verb="filter", ignorable=ignorable,
                      timeout_s=2.0)
    p = pod("p", 1)
    if ignorable:
        assert port.filter(p, ["a"]) == ref.filter(p, ["a"]) == (["a"], {})
    else:
        with pytest.raises(extender.ExtenderError):
            port.filter(p, ["a"])
        with pytest.raises(jax_ext.ExtenderError):
            ref.filter(p, ["a"])
    assert port.prioritize(p, ["a"]) == ref.prioritize(p, ["a"]) == {}


def test_load_extenders_reads_a_config_alike():
    config = {"extenders": [
        {"urlPrefix": "http://127.0.0.1:9199/", "filterVerb": "filter",
         "prioritizeVerb": "prio", "weight": 3, "ignorable": True,
         "httpTimeout": 2.5},
        {"urlPrefix": "http://127.0.0.1:9200", "bindVerb": "bind"}]}
    keys = ("url_prefix", "filter_verb", "prioritize_verb", "bind_verb",
            "weight", "ignorable", "timeout_s")
    ours = [{k: getattr(e, k) for k in keys}
            for e in extender.load_extenders(config)]
    ref = [{k: getattr(e, k) for k in keys}
           for e in jax_ext.load_extenders(config)]
    assert ours == ref and len(ours) == 2
    assert extender.load_extenders({}) == []


# ---- through the port's engine ----------------------------------------------


def _hgx(n):
    return [fake.hgx_h100_inventory(host=i) for i in range(n)]


def test_a_vetoed_node_is_never_chosen(stub, monkeypatch):
    """Two HGX hosts, a filter extender vetoing host0: twelve pods of one
    card fill host1's 8 cards and the rest stay pending; none lands on
    host0, and the stub saw every filter pass."""
    s = stub({"filter": _veto("host0")})
    ext = extender.HTTPExtender(s.url, filter_verb="filter")
    api, _, sched = cluster("port", *_hgx(2), monkeypatch=monkeypatch,
                            extenders=[ext])
    try:
        for i in range(12):
            api.create_pod(pod(f"p{i}", 1))
        sched.run_until_idle()
        nodes = [placement(api, f"p{i}")[0] for i in range(12)]
        assert nodes.count("host1") == 8 and nodes.count(None) == 4
        assert "host0" not in nodes
        assert s.calls and all(v == "filter" for v, _ in s.calls)
    finally:
        sched.stop()


def test_a_prioritize_extender_steers_placement(stub, monkeypatch):
    s = stub({"prioritize": _scores({"host1": 10})})
    ext = extender.HTTPExtender(s.url, prioritize_verb="prioritize",
                                weight=100.0)
    api, _, sched = cluster("port", *_hgx(2), monkeypatch=monkeypatch,
                            extenders=[ext])
    try:
        for i in range(3):
            api.create_pod(pod(f"p{i}", 1))
        sched.run_until_idle()
        assert [placement(api, f"p{i}")[0] for i in range(3)] == \
            ["host1"] * 3
    finally:
        sched.stop()


def test_a_bind_verb_extender_owns_the_binding(stub, monkeypatch):
    """The engine asks the extender to bind; the extender binds through
    the API server itself."""
    holder: dict = {}

    def bind(body):
        holder["api"].bind_pod(body["podName"], body["node"])
        return 200, {}
    s = stub({"bind": bind})
    ext = extender.HTTPExtender(s.url, bind_verb="bind")
    api, _, sched = cluster("port", *_hgx(1), monkeypatch=monkeypatch,
                            extenders=[ext])
    holder["api"] = api
    try:
        api.create_pod(pod("p", 2))
        sched.run_until_idle()
        assert placement(api, "p")[0] == "host0"
        assert s.calls == [("bind", {"podName": "p", "node": "host0"})]
    finally:
        sched.stop()
