"""The port's write-ahead log (`kubegpu_tpu_torch/cluster/wal.py`) against
the JAX package's (`kubegpu_tpu/cluster/wal.py`): the same records give
the same bytes; a torn or corrupt tail is dropped alike; snapshot and
compaction recover the state; after a restart a watch resumes seq-exact;
a directory either server wrote, the other recovers to an equal
``dump_state()`` and head sequence; and after recovery the port's arbiter
still refuses a second claim on a bound pod's card."""

import os
import shutil
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import apiserver as jax_api  # noqa: E402
from kubegpu_tpu.cluster import httpapi as jax_http  # noqa: E402
from kubegpu_tpu.cluster import wal as jax_wal  # noqa: E402
from kubegpu_tpu_torch.cluster import apiserver, httpapi, wal  # noqa: E402
from tests import torch_api as ta  # noqa: E402

RECORDS = [(1, "node", "added", {"metadata": {"name": "n"}}),
           (2, "pod", "added", {"metadata": {"name": "p"}, "spec": {}}),
           (3, "pod", "modified", {"metadata": {"name": "p"},
                                   "spec": {"nodeName": "n"}}),
           (4, "event", "added", {"involvedObject": {"name": "p"},
                                  "reason": "Scheduled", "count": 1})]


def _write(mod, path, records=RECORDS):
    log = mod.WriteAheadLog(str(path), fsync=False)
    for rec in records:
        log.append(*rec)
    log.close()
    return os.path.join(str(path), "wal.log")


@pytest.mark.parametrize("damage", ["torn", "corrupt", "garbage"])
def test_a_damaged_tail_is_dropped_as_jax_drops_it(tmp_path, damage):
    port_file = _write(wal, tmp_path / "port")
    jax_file = _write(jax_wal, tmp_path / "jax")
    with open(port_file, "rb") as f:
        data = f.read()
    with open(jax_file, "rb") as f:
        assert f.read() == data
    if damage == "torn":
        data = data[:-5]
    elif damage == "corrupt":
        data = data[:-3] + bytes([data[-3] ^ 0xFF]) + data[-2:]
    else:
        data += b"\x07\x00\x00\x00garbage!"
    for path in (port_file, jax_file):
        with open(path, "wb") as f:
            f.write(data)
    port_log = wal.WriteAheadLog(str(tmp_path / "port"))
    jax_log = jax_wal.WriteAheadLog(str(tmp_path / "jax"))
    got = port_log.read_records()
    assert got == jax_log.read_records()
    assert got == RECORDS[:3 if damage != "garbage" else 4]
    assert port_log.dropped_tail_bytes == jax_log.dropped_tail_bytes > 0
    assert os.path.getsize(port_file) == os.path.getsize(jax_file)


def _served(path, port=0, **kw):
    log = wal.WriteAheadLog(str(path), fsync=False, **kw)
    api = apiserver.InMemoryAPIServer()
    server, url = httpapi.serve_api(api, port=port, wal=log)
    return api, server, url


def test_snapshot_and_compaction_recover_the_state(tmp_path):
    api, server, url = _served(tmp_path, snapshot_every=5)
    client = httpapi.HTTPAPIClient(url)
    try:
        client.create_node(ta.gpu_node("host0"))
        for i in range(6):
            client.create_pod(ta.gpu_pod(f"p{i}", tenant="ta"))
        client.bind_many({"p0": "host0"}, {"p0": ta.gpu_pod(
            "p0", alloc=(0, (1,)))["metadata"]["annotations"]})
        state, head = api.dump_state(), server.event_log.seq()
    finally:
        client.close()
        server.shutdown()
    snap = os.path.join(str(tmp_path), "snapshot.json")
    assert os.path.exists(snap)
    # compaction left only the records after the last snapshot
    assert len(wal.WriteAheadLog(str(tmp_path)).read_records()) < head
    api2, server2, _ = _served(tmp_path)
    try:
        assert api2.dump_state() == state
        assert server2.event_log.seq() == head
        assert api2.list_quotas() == api.list_quotas()
    finally:
        server2.shutdown()


def test_a_watch_resumes_seq_exact_after_a_restart(tmp_path):
    _, server, url = _served(tmp_path)
    port = int(url.rsplit(":", 1)[1])
    client = httpapi.HTTPAPIClient(url, wire="stream")
    seen = []
    try:
        client.add_watcher(lambda k, e, o: seen.append(o["metadata"]["name"]))
        for i in range(3):
            client.create_node({"metadata": {"name": f"a{i}"}})
        _until(lambda: len(seen) == 3)
        server.shutdown()
        # the same directory and port: the sequence space continues
        _, server, _ = _served(tmp_path, port=port)
        writer = httpapi.HTTPAPIClient(url)
        for i in range(3):
            writer.create_node({"metadata": {"name": f"b{i}"}})
        writer.close()
        _until(lambda: len(seen) == 6)
        time.sleep(0.3)
        assert seen == ["a0", "a1", "a2", "b0", "b1", "b2"]
        assert client.relist_count == 0
    finally:
        client.close()
        server.shutdown()


def _until(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def _script_into(server_mod, api, log_mod, path):
    log = log_mod.WriteAheadLog(str(path), fsync=False, snapshot_every=40)
    server, _ = server_mod.serve_api(api, wal=log)
    for verb, args in ta.script(5):
        try:
            getattr(api, verb)(*args)
        except (KeyError, RuntimeError):
            pass
    head = server.event_log.seq()
    server.shutdown()
    return api.dump_state(), head


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_directory_recovers_across_packages(tmp_path, writer):
    """One package's server writes the seeded script (snapshots included),
    the other's recovers it: equal state and head sequence. The JAX side
    writes GPU objects as they come: its store keeps them as given."""
    if writer == "jax":
        state, head = _script_into(jax_http, jax_api.InMemoryAPIServer(),
                                   jax_wal, tmp_path)
        reader = (httpapi, apiserver.InMemoryAPIServer(), wal)
    else:
        state, head = _script_into(httpapi, apiserver.InMemoryAPIServer(),
                                   wal, tmp_path)
        reader = (jax_http, jax_api.InMemoryAPIServer(), jax_wal)
    server_mod, api, log_mod = reader
    assert os.path.exists(os.path.join(str(tmp_path), "snapshot.json"))
    server, _ = server_mod.serve_api(api, wal=log_mod.WriteAheadLog(
        str(tmp_path), fsync=False))
    try:
        assert api.dump_state() == state
        assert server.event_log.seq() == head
    finally:
        server.shutdown()


def test_a_recovered_card_claim_is_still_refused(tmp_path):
    """A pod bound onto a card by the JAX server's WAL (which never
    arbitrated it), recovered by the port's server: a second claim on that
    card is refused with a Conflict naming it."""
    jax_dir = tmp_path / "jax"
    api = jax_api.InMemoryAPIServer()
    server, _ = jax_http.serve_api(api, wal=jax_wal.WriteAheadLog(
        str(jax_dir), fsync=False))
    ann = ta.gpu_pod("x", 1, alloc=(1, (6,)))["metadata"]["annotations"]
    api.create_node(ta.gpu_node("host1", 1))
    for name in ("owner", "thief"):
        api.create_pod(ta.gpu_pod(name))
    api.bind_many({"owner": "host1"}, {"owner": ann})
    server.shutdown()
    port_dir = tmp_path / "port"
    shutil.copytree(jax_dir, port_dir)
    port_api, port_server, _ = _served(port_dir)
    try:
        with pytest.raises(apiserver.Conflict) as err:
            port_api.bind_many({"thief": "host1"}, {"thief": ann})
        uuid = ta.card_path(1, 6).split("/")[-2]
        assert uuid in err.value.per_pod["thief"]
        assert "taken by owner" in err.value.per_pod["thief"]
    finally:
        port_server.shutdown()
