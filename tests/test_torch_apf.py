"""The port's front door (`kubegpu_tpu_torch/cluster/apf.py`) against the JAX
package's (`kubegpu_tpu/cluster/apf.py`): `classify`, `shuffle_shard` and
`default_bands` equal JAX's on seeded requests; a saturated workload band
sheds with ``retry_after_s`` while system-band PATCHes and leases pass,
in both packages alike; and on both wires the 429 (a ``REJECT`` frame on
the stream wire) reaches the port's client as `TooManyRequests`."""

import random
import threading
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import apf as jax_apf  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.cluster import apf, apiserver, httpapi  # noqa: E402
from tests import torch_api as ta  # noqa: E402

SEGMENTS = ("healthz", "watch", "leases", "debug", "metrics", "nodes",
            "pods", "bindmany", "podannotations", "bindvolume", "events",
            "pvcs", "pvs", "pdbs", "quotas", "services", "rcs", "rss",
            "statefulsets", "stream", "")
METHODS = ("GET", "POST", "PUT", "PATCH", "DELETE")


def _request(rng) -> tuple:
    seg = rng.choice(SEGMENTS)
    parts = [seg] if seg else []
    if rng.random() < 0.6:
        parts.append(rng.choice(("p1", "n2", "x")))
        if rng.random() < 0.5:
            parts.append(rng.choice(("bind", "annotations", "metadata")))
    body = None
    if rng.random() < 0.5:
        body = ta.gpu_pod("p", 2, tenant=rng.choice((None, "ta", "tb")))
    return (rng.choice(METHODS), parts, {}, body,
            rng.choice(("", "10.0.0.1", "10.0.0.2")))


@pytest.mark.parametrize("seed", range(4))
def test_classify_and_shuffle_shard_equal_jax(seed):
    rng = random.Random(seed)
    for _ in range(200):
        req = _request(rng)
        assert apf.classify(*req) == jax_apf.classify(*req), req
    for _ in range(200):
        band = rng.choice(("workload", "controller"))
        flow = f"f{rng.randrange(1000)}"
        queues, hand = rng.randint(1, 32), rng.randint(1, 8)
        assert apf.shuffle_shard(band, flow, queues, hand) == \
            jax_apf.shuffle_shard(band, flow, queues, hand)


def test_default_bands_equal_jax():
    ours, ref = apf.default_bands(), jax_apf.default_bands()
    assert ours.keys() == ref.keys()
    for name in ours:
        assert vars(ours[name]) == vars(ref[name]), name


def _saturate(mod):
    """A workload band of one seat and one queue of one: a held seat, one
    waiter queued behind it, and a third request. Returns what each
    request met, and the system-band requests' outcomes meanwhile."""
    door = mod.APFDispatcher({mod.BAND_WORKLOAD: mod.BandConfig(
        seats=1, queues=1, queue_len=1, queue_wait_s=0.5, hand=1)})
    create = ("POST", ["pods"], {}, ta.gpu_pod("p", tenant="ta"), "h")
    held, release = threading.Event(), threading.Event()
    out: dict = {}

    def hold():
        with door.admit(*create):
            held.set()
            release.wait(5)

    def queued():
        try:
            with door.admit(*create):
                out["queued"] = "admitted"
        except mod.TooManyRequests as err:
            out["queued"] = err

    holder = threading.Thread(target=hold)
    holder.start()
    held.wait(5)
    waiter = threading.Thread(target=queued)
    waiter.start()
    deadline = time.monotonic() + 5
    while door.inflight(mod.BAND_WORKLOAD) != (1, 1):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    try:
        with door.admit(*create):
            out["third"] = "admitted"
    except mod.TooManyRequests as err:
        out["third"] = err
    system = []
    for req in (("PATCH", ["nodes", "n", "metadata"], {}, {}, "h"),
                ("POST", ["leases", "l"], {}, {"holder": "a"}, "h"),
                ("GET", ["watch"], {}, None, "h")):
        with door.admit(*req) as band:
            system.append(band)
    release.set()
    holder.join()
    waiter.join()
    return out, system


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_a_saturated_band_sheds_while_the_system_band_passes(impl):
    mod = jax_apf if impl == "jax" else apf
    before = metrics.APF_REJECTS.labels("workload").value
    out, system = _saturate(mod)
    assert isinstance(out["third"], mod.TooManyRequests)
    assert out["third"].retry_after_s == 0.5
    assert "queue full" in str(out["third"])
    # the waiter got the seat the holder released
    assert out["queued"] == "admitted"
    assert system == ["system"] * 3
    if impl == "port":
        assert metrics.APF_REJECTS.labels("workload").value == before + 1


@pytest.mark.parametrize("wire", ["stream", "json"])
def test_a_429_reaches_the_client_as_too_many_requests(wire):
    """A workload band that seats nothing sheds every create: on the JSON
    wire as a 429, on the stream wire as a REJECT frame; the port's client
    raises `TooManyRequests` with the advised backoff either way (POST is
    sent once). A node PATCH and a lease pass; the controller band lists."""
    door = apf.APFDispatcher({apf.BAND_WORKLOAD: apf.BandConfig(
        seats=0, queues=1, queue_len=0, queue_wait_s=0.25, hand=1)})
    api = apiserver.InMemoryAPIServer()
    server, url = httpapi.serve_api(api, apf=door)
    client = httpapi.HTTPAPIClient(url, wire=wire)
    try:
        client.create_node({"metadata": {"name": "n"}})
        with pytest.raises(httpapi.TooManyRequests) as err:
            client.create_pod(ta.gpu_pod("p", tenant="ta"))
        assert err.value.retry_after_s == 0.25
        assert client.throttled_count == 0 and api.list_pods() == []
        client.patch_node_metadata("n", {"labels": {"a": "b"}})
        assert client.acquire_lease("l", "me", 10.0)
        assert [n["metadata"]["name"] for n in client.list_nodes()] == ["n"]
        assert client.wire == wire
    finally:
        client.close()
        server.shutdown()


# ---- the explorer: reject during drain at the queue seams ------------------

def test_explorer_reject_during_drain_never_leaks_a_seat():
    """The twin of the JAX suite's scenario over the port's dispatcher
    (`races.apf_reject_during_drain`): one seat, one queue, a holder
    releasing races a waiter's queue-wait deadline; no schedule leaks a
    seat or a waiter, and the waiter sees exactly one outcome."""
    from kubegpu_tpu_torch.analysis import races, schedules as sch

    res = sch.explore(races.apf_reject_during_drain, max_schedules=400,
                      seed=0)
    assert res.ok, res.failure.render()
    # the seams (apf.admit, apf.enqueue, apf.release) are decision points
    assert res.schedules > 1
