"""The scheduler's watch in the port: the codec's watch records
(`kubegpu_tpu_torch/core/codec.py`) byte for byte the JAX package's, the
stream wire's subscription (`cluster/stream.py` ``SUB``/``PUSH``), and the
informer of `cluster/httpapi.py` against the JAX API server (`serve_api`)
on each wire: every event once and in order, whole batches to a batch
watcher, resume from the cursor after a dropped connection, a relist after
a server restart, and negotiation down to the JSON long poll."""

import contextlib
import random
import socket
import threading
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.cluster.httpapi import \
    HTTPAPIClient as JaxClient  # noqa: E402
from kubegpu_tpu.cluster.httpapi import serve_api  # noqa: E402
from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu_torch.cluster import stream  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient  # noqa: E402
from kubegpu_tpu_torch.core import codec  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from tests import torch_sched as ts  # noqa: E402

WIRES = ("json", "stream")


def _wait(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---- the codec's watch records ------------------------------------------------


def _seeded_objects(seed: int) -> tuple:
    """Pods before and after the port's engine placed them (the latter
    carry a GPU allocation in ``pod.alpha/DeviceInformation``) and the
    node snapshots two fake hosts advertised, from one seeded stream."""
    rng = random.Random(seed)
    api, _, sched = ts.cluster("port", fake.hgx_h100_inventory(),
                               fake.pcie_h100_inventory())
    pending = []
    for i in range(6):
        pod = ts.pod(f"w{seed}-{i}", rng.choice([1, 2, 4, 8]),
                     auto=rng.random() < 0.3)
        pending.append(pod)
        api.create_pod(pod)
    sched.run_until_idle()
    sched.stop()
    placed = [api.get_pod(p["metadata"]["name"]) for p in pending]
    assert any(p["spec"].get("nodeName") for p in placed)
    return pending, placed, api.list_nodes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watch_records_equal_jax_byte_for_byte_and_round_trip(seed):
    pending, placed, nodes = _seeded_objects(seed)
    alloc = [p for p in placed if codec.POD_ANNOTATION_KEY in
             p["metadata"]["annotations"] and p["spec"].get("nodeName")]
    assert alloc, "no pod carries an allocation"
    for pod in pending + placed:
        data = codec.encode_pod(pod)
        assert data == jax_codec.encode_pod(pod)
        assert codec.decode_pod(data) == jax_codec.decode_pod(data) == pod
    for node in nodes:
        data = codec.encode_node_snapshot(node)
        assert data == jax_codec.encode_node_snapshot(node)
        assert codec.decode_node_snapshot(data) == node
    rng = random.Random(seed)
    objs = [("pod", p) for p in pending + placed] + \
        [("node", n) for n in nodes]
    seq = 0
    for _ in range(5):
        events = []
        for kind, obj in rng.sample(objs, k=rng.randint(0, len(objs))):
            seq += rng.randint(1, 3)
            events.append((seq, kind, rng.choice(["added", "modified",
                                                  "deleted"]), obj))
        kw = dict(coalesced=rng.randint(0, 4), relist=rng.random() < 0.3,
                  epoch=rng.choice([None, f"{rng.getrandbits(64):016x}"]),
                  ts=rng.random() * 1e9)
        data = codec.encode_watch_batch(events, seq, **kw)
        assert data == jax_codec.encode_watch_batch(events, seq, **kw)
        got = codec.decode_watch_batch(data)
        assert got == jax_codec.decode_watch_batch(data)
        assert got == {"events": events, "seq": seq, **kw}


@pytest.mark.parametrize("data", [
    codec.encode_value([1, 2]),                         # a list, not a pod
    codec.encode_value([[], 1, 0, False, None]),        # five fields
    codec.encode_value([[[1, "pod", "added"]], 1, 0, False, None, 0.0]),
    codec.encode_value({"events": []}),
    codec.encode_value({"a": 1})[:-1]])
def test_malformed_records_raise_codec_error_in_both(data):
    for mod in (codec, jax_codec):
        for decode in (mod.decode_watch_batch, mod.decode_pod):
            try:
                decode(data)
            except mod.CodecError:
                continue
            assert decode is mod.decode_pod and isinstance(
                mod.decode_value(data), dict)


# ---- the stream wire's subscription -------------------------------------------


def test_subscribe_acks_then_pushes_the_servers_batches():
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    conn = stream.StreamConn.connect(url, 5.0)
    try:
        api.create_node({"metadata": {"name": "n0"}})
        ack = conn.subscribe(0, ("node",), 0.0, timeout=5.0)
        assert ack == {"seq": 1, "epoch": server.event_log.epoch}
        api.create_pod({"metadata": {"name": "p0"}})      # filtered out
        api.create_node({"metadata": {"name": "n1"}})
        got = []
        while sum(len(b["events"]) for b in got) < 2:
            out = conn.read_push(timeout=5.0)
            if out is not None:
                got.append(out)
        events = [e for b in got for e in b["events"]]
        assert [(e[0], e[1], e[3]["metadata"]["name"]) for e in events] == \
            [(1, "node", "n0"), (3, "node", "n1")]
        assert got[-1]["seq"] == 3 and not got[-1]["relist"]
        assert got[-1]["epoch"] == server.event_log.epoch
    finally:
        conn.close()
        server.shutdown()
    assert conn.closed


# ---- the informer on each wire ------------------------------------------------


@pytest.fixture(params=WIRES)
def watched(request):
    """The JAX API server and the port's client on one wire: ``(api,
    client, server, url)``."""
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    client = HTTPAPIClient(url, wire=request.param)
    yield api, client, server, url
    client.close()
    server.shutdown()
    assert client._watch_thread is None or \
        not client._watch_thread.is_alive()
    assert client.wire == request.param


def test_every_event_arrives_once_and_in_order(watched):
    api, client, _, _ = watched
    seen = []
    client.add_watcher(lambda kind, event, obj: seen.append(
        (kind, event, obj["metadata"]["name"])))
    want = []
    for i in range(8):
        api.create_node({"metadata": {"name": f"n{i}"}})
        want.append(("node", "added", f"n{i}"))
        if i % 3 == 0:
            # a create then a delete in one window may fold away; let the
            # informer see each first
            _wait(lambda: len(seen) == len(want), what="the node")
            api.delete_node(f"n{i}")
            want.append(("node", "deleted", f"n{i}"))
            _wait(lambda: len(seen) == len(want), what="the deletion")
    api.create_pod({"metadata": {"name": "p0"}})
    want.append(("pod", "added", "p0"))
    # events arrive in order, so a duplicate or a stray one would come
    # before the last node
    api.create_node({"metadata": {"name": "last"}})
    want.append(("node", "added", "last"))
    _wait(lambda: ("node", "added", "last") in seen, what="every event")
    assert seen == want
    assert client.relist_count == 0 and client.watch_errors == 0


def test_the_batch_watcher_gets_whole_batches_before_the_watchers(watched):
    api, client, _, _ = watched
    client.watch_batch_s = 0.3
    log = []
    client.add_batch_watcher(lambda batch: log.append(
        ("batch", [obj["metadata"]["name"] for _, _, obj in batch])))
    client.add_watcher(lambda kind, event, obj: log.append(
        ("event", obj["metadata"]["name"])))
    for i in range(6):
        api.create_node({"metadata": {"name": f"n{i}"}})
    names = [f"n{i}" for i in range(6)]
    _wait(lambda: sum(1 for e in log if e[0] == "event") == 6,
          what="six events")
    # the linger folds the burst into one batch, delivered whole, then
    # event by event in its order
    assert log == [("batch", names)] + [("event", n) for n in names]


def _sever_server_side(server):
    """Drop every connection the server holds."""
    with server._conn_lock:
        conns = list(server._client_conns)
    for conn in conns:
        with contextlib.suppress(OSError):
            conn.shutdown(socket.SHUT_RDWR)


def test_a_dropped_connection_resumes_from_the_cursor(watched):
    api, client, server, _ = watched
    seen = []
    client.add_watcher(lambda kind, event, obj: seen.append(
        obj["metadata"]["name"]))
    for i in range(3):
        api.create_node({"metadata": {"name": f"a{i}"}})
    _wait(lambda: len(seen) == 3, what="the first nodes")
    for round_ in range(3):
        _sever_server_side(server)
        for i in range(2):
            api.create_node({"metadata": {"name": f"b{round_}{i}"}})
        _wait(lambda: len(seen) >= 3 + 2 * (round_ + 1),
              what="the nodes after the drop")
    # events arrive in order: a replayed one would come before the last
    api.create_node({"metadata": {"name": "last"}})
    _wait(lambda: "last" in seen, what="the last node")
    assert seen == ["a0", "a1", "a2"] + [f"b{r}{i}" for r in range(3)
                                         for i in range(2)] + ["last"]
    assert client.relist_count == 0


@pytest.mark.parametrize("wire", WIRES)
def test_a_cursor_from_before_a_server_restart_relists(wire):
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    port = server.server_address[1]
    client = HTTPAPIClient(url, wire=wire)
    seen, relists = [], []
    client.add_watcher(lambda kind, event, obj: seen.append(
        obj["metadata"]["name"]))
    client.add_relist_listener(lambda: relists.append(len(seen)))
    server2 = None
    try:
        for i in range(4):
            api.create_node({"metadata": {"name": f"old{i}"}})
        _wait(lambda: len(seen) == 4, what="the first life's nodes")
        server.shutdown()
        # a new life without durable state: its sequence starts over, under
        # a new epoch
        api2 = InMemoryAPIServer()
        api2.create_node({"metadata": {"name": "new0"}})
        server2, _ = serve_api(api2, port=port)
        _wait(lambda: relists, timeout=15.0, what="the relist")
        api2.create_node({"metadata": {"name": "new1"}})
        _wait(lambda: "new1" in seen, what="the new life's next node")
        # the gap is not replayed as deltas: the consumer relists instead
        assert relists == [4] and client.relist_count == 1
        assert seen == [f"old{i}" for i in range(4)] + ["new1"]
    finally:
        client.close()
        if server2 is not None:
            server2.shutdown()


def test_a_stream_client_negotiates_down_once_and_keeps_watching(
        monkeypatch):
    api = InMemoryAPIServer()
    server, url = serve_api(api, stream_wire=False)
    dials = []
    real = stream.StreamConn.connect.__func__

    def connect(cls, *args, **kwargs):
        dials.append(args)
        return real(cls, *args, **kwargs)

    monkeypatch.setattr(stream.StreamConn, "connect", classmethod(connect))
    client = HTTPAPIClient(url, wire="stream")
    seen = []
    try:
        client.add_watcher(lambda kind, event, obj: seen.append(
            obj["metadata"]["name"]))
        for i in range(5):
            api.create_node({"metadata": {"name": f"n{i}"}})
            _wait(lambda: len(seen) == i + 1, what=f"node {i}")
        api.create_pod({"metadata": {"name": "p"}})
        _wait(lambda: "p" in seen, what="the pod")
        assert client.wire == "json" and len(dials) == 1
        assert seen == [f"n{i}" for i in range(5)] + ["p"]
    finally:
        client.close()
        server.shutdown()


def test_close_stops_the_informer_and_its_connections(watched):
    api, client, server, _ = watched
    client.add_batch_watcher(lambda batch: None)
    api.create_node({"metadata": {"name": "n0"}})
    _wait(lambda: client._watch_thread.is_alive(), what="the informer")
    client.close()
    assert not client._watch_thread.is_alive()
    assert not client._stream_conns and not client._conns


# ---- the cursor contract, against the JAX client's ---------------------------


def _cursor_run(cls, outs):
    """Feed ``outs`` to a fresh client's ``_apply_watch_out`` (no
    connection is made) and record what its consumers and cursor saw."""
    client = cls("http://127.0.0.1:1")
    log = []
    client.add_relist_listener(lambda: log.append(("relist",)))
    client._batch_watchers.append(lambda b: log.append(("batch", len(b))))
    client._watchers.append(lambda k, e, o: log.append((k, e, o["n"])))
    st = {"seq": 0, "epoch": None, "failures": 0}
    for out, advance in outs:
        restarted = client._apply_watch_out(st, out, _Quiet(),
                                            advance=advance)
        log.append(("cursor", st["seq"], st["epoch"], restarted))
    return log, client.relist_count


class _Quiet:
    def __getattr__(self, name):
        return lambda *a, **k: None


def test_the_cursor_contract_equals_the_jax_clients():
    rng = random.Random(7)
    outs, seq = [], 0
    epoch = "e0"
    for step in range(60):
        roll = rng.random()
        if roll < 0.1:
            epoch = f"e{step}"                   # a restart, seq kept
        if roll < 0.15:
            seq = rng.randint(0, seq)            # a restart, seq behind
        events = []
        for _ in range(rng.randint(0, 4)):
            seq += rng.randint(1, 2)
            events.append((seq, rng.choice(["pod", "node"]),
                           rng.choice(["added", "modified", "deleted"]),
                           {"n": seq}))
        out = {"events": events, "seq": seq + rng.randint(0, 2),
               "coalesced": rng.randint(0, 2), "epoch": epoch}
        if rng.random() < 0.05:
            out["relist"] = True
        outs.append((out, rng.random() > 0.1))
    ours = _cursor_run(HTTPAPIClient, outs)
    assert ours == _cursor_run(JaxClient, outs)
    assert ours[1] > 0 and any(e[0] == "batch" for e in ours[0])


def test_the_informer_thread_is_named_and_single(watched):
    _, client, _, _ = watched
    client.add_watcher(lambda *a: None)
    first = client._watch_thread
    client.add_batch_watcher(lambda b: None)
    assert client._watch_thread is first and first.name == "api-watch"
    assert sum(1 for t in threading.enumerate() if t is first) == 1
