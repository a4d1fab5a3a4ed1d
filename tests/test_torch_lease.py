"""The port's leases (`kubegpu_tpu_torch/cluster/lease.py`) against the JAX
package's (`kubegpu_tpu/cluster/lease.py`): ``shard_of`` equal for every
name, the elector's transport-error grace step for step, and the shard
coordinator's steal and stand-down over the JAX API server, in process and
through the port's client on each wire (a denial is False, not a
`Conflict`)."""

import random
import string
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import lease as jax_lease  # noqa: E402
from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.cluster.httpapi import serve_api  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.cluster import lease  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient  # noqa: E402


def _names(n: int, seed: int) -> list:
    rng = random.Random(seed)
    alphabet = string.ascii_lowercase + string.digits + "-.é"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40)))
            for _ in range(n)]


@pytest.mark.parametrize("replicas", range(1, 9))
def test_shard_of_equals_jax_for_every_name(replicas):
    names = _names(10_000, seed=replicas) + [f"gang:{g}" for g in range(64)]
    ours = [lease.shard_of(n, replicas) for n in names]
    assert ours == [jax_lease.shard_of(n, replicas) for n in names]
    assert set(ours) == set(range(replicas))


def test_lease_names_equal_jax():
    assert (lease.SHARD_LEASE_PREFIX, lease.LIFECYCLE_LEASE,
            lease.REPAIR_LEASE) == (jax_lease.SHARD_LEASE_PREFIX,
                                    jax_lease.LIFECYCLE_LEASE,
                                    jax_lease.REPAIR_LEASE)


def test_lease_table_release_and_steal_on_expiry():
    table = lease.LeaseTable()
    assert table.acquire("s", "a", 0.2)
    assert table.holder("s") == "a"
    assert not table.acquire("s", "b", 0.2)
    assert not table.release("s", "b")
    assert table.release("s", "a")
    assert table.holder("s") is None
    assert table.acquire("s", "b", 0.05)
    deadline = time.monotonic() + 5
    while table.holder("s") is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert table.holder("s") is None              # expired
    assert table.acquire("s", "a", 0.2)           # steal on expiry


def _elector_run(module, script):
    """Drive ``module.Elector`` through ``script`` ([(advance s, reply)],
    reply True/False or an exception) on a fake clock; returns each tick's
    result, leading flag and the callbacks fired."""
    clock = {"t": 100.0}
    replies = list(script)
    fired = []

    def acquire(name, holder, ttl):
        reply = replies[0][1]
        if isinstance(reply, Exception):
            raise reply
        return reply

    el = module.Elector(acquire, "lease", "me", ttl_s=10.0,
                        on_acquire=lambda: fired.append("acquire"),
                        on_lose=lambda: fired.append("lose"),
                        clock=lambda: clock["t"])
    out = []
    while replies:
        clock["t"] += replies[0][0]
        out.append((el.tick(), el.leading, tuple(fired)))
        replies.pop(0)
    el.stop()
    out.append((el.leading, el.transitions, tuple(fired)))
    return out


def test_elector_keeps_the_lease_through_an_error_in_grace_then_demotes():
    down = ConnectionError("transport down")
    script = [(0, True), (5, down), (4.9, down), (0.2, down), (1, True),
              (3, False), (1, down), (1, True), (2, True)]
    ours = _elector_run(lease, script)
    assert ours == _elector_run(jax_lease, script)
    # within the TTL of the last renewal the leader leads on; past it, it
    # demotes; a denial demotes at once; an error while standing by stays
    assert [r[:2] for r in ours[:-1]] == [
        (True, True), (True, True), (True, True), (False, False),
        (True, True), (False, False), (False, False), (True, True),
        (True, True)]
    assert ours[-1] == (False, 6, ("acquire", "lose", "acquire", "lose",
                                   "acquire", "lose"))


@pytest.mark.parametrize("wire", ["json", "stream"])
def test_a_denial_over_the_client_is_false_not_a_conflict(wire):
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    client = HTTPAPIClient(url, wire=wire)
    try:
        assert client.acquire_lease("l", "a", 5.0) is True
        assert client.acquire_lease("l", "b", 5.0) is False
        assert client.lease_holder("l") == "a" == api.lease_holder("l")
        assert client.release_lease("l", "b") and client.lease_holder("l")
        assert client.release_lease("l", "a")
        assert client.lease_holder("l") is None
        el = lease.Elector(client.acquire_lease, "l", "b", 5.0)
        before = metrics.LEASE_TRANSITIONS.value
        assert el.tick() and el.leading
        assert metrics.LEASE_TRANSITIONS.value == before + 1
        assert api.lease_holder("l") == "b"
    finally:
        client.close()
        server.shutdown()


@pytest.fixture(params=["in-memory", "json", "stream"])
def lease_api(request):
    """A lease API: the JAX in-memory server itself, or the port's client
    of it served on one wire."""
    api = InMemoryAPIServer()
    if request.param == "in-memory":
        yield api
        return
    server, url = serve_api(api)
    client = HTTPAPIClient(url, wire=request.param)
    yield client
    client.close()
    server.shutdown()


def test_shard_coordinator_steals_vacant_and_stands_down(lease_api):
    changes = []
    a = lease.ShardCoordinator(lease_api, 0, 2, "r0", ttl_s=0.5)
    b = lease.ShardCoordinator(lease_api, 1, 2, "r1", ttl_s=0.5,
                               on_change=lambda: changes.append(1))
    a.tick()
    b.tick()
    a.tick()            # sees r1's lease now: stands down from shard 1
    assert sorted(a.owned_shards()) == [0]
    assert sorted(b.owned_shards()) == [1]
    # r0 stops (a clean stop releases its lease): r1 takes its work
    a.stop()
    b.tick()
    assert sorted(b.owned_shards()) == [0, 1]
    owned_by_b = [n for n in (f"p{i}" for i in range(50)) if b.owns(n)]
    assert len(owned_by_b) == 50
    # r0 returns and renews: r1 stands down again, without a tug of war
    a2 = lease.ShardCoordinator(lease_api, 0, 2, "r0", ttl_s=0.5)
    a2.tick()
    b.tick()
    assert sorted(b.owned_shards()) == [1]
    assert [b.owns(n) for n in owned_by_b] == \
        [lease.shard_of(n, 2) == 1 for n in owned_by_b]
    assert len(changes) == 3
    a2.stop()
    b.stop()
    assert b.owned_shards() == frozenset()


def test_a_dead_replicas_shard_is_stolen_after_its_ttl(lease_api):
    a = lease.ShardCoordinator(lease_api, 0, 2, "r0", ttl_s=0.3)
    b = lease.ShardCoordinator(lease_api, 1, 2, "r1", ttl_s=0.3)
    a.tick()
    b.tick()
    assert sorted(b.owned_shards()) == [1]
    # r0 dies without releasing: its lease lapses after the TTL
    t0 = time.monotonic()
    while sorted(b.tick()) != [0, 1]:
        assert time.monotonic() - t0 < 5.0
        time.sleep(0.02)
    assert time.monotonic() - t0 >= 0.2
    b.stop()
