"""The port's API server in process (`kubegpu_tpu_torch/cluster/apiserver.py`)
against the JAX package's (`kubegpu_tpu/cluster/apiserver.py`): seeded
scripts of operations (`tests/torch_api.py`) give equal return values,
exception types and per-pod keys, watch streams and ``dump_state()``, the
JAX server running the TPU twin of every object. Then the two GPU faults
of the JAX server, each with its port twin: two pods bound onto one GPU
card (ROADMAP Queue 3), and a tenant's hard cap that never refuses a GPU
pod."""

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import apiserver as jax_api  # noqa: E402
from kubegpu_tpu_torch.cluster import apiserver, httpapi  # noqa: E402
from tests import torch_api as ta  # noqa: E402

SEEDS = range(6)


def _pair(max_events: int = 12):
    port, ref = apiserver.InMemoryAPIServer(), jax_api.InMemoryAPIServer()
    streams: tuple = ([], [])
    for api, out in zip((port, ref), streams):
        api.MAX_EVENTS = max_events
        api.add_watcher(lambda k, e, o, out=out: out.append((k, e, o)))
    return port, ref, streams


def _run(port, ref, ops) -> list:
    """Every op on both servers; the JAX side's answers untwinned. Returns
    the pairs that differ."""
    diffs = []
    for i, (verb, args) in enumerate(ops):
        got = ta.outcome(getattr(port, verb), *args)
        want = ta.untwin(ta.outcome(getattr(ref, verb), *ta.twin(args)))
        if ta.untwin(got) != want:
            diffs.append((i, verb, got, want))
    return diffs


@pytest.mark.parametrize("seed", SEEDS)
def test_a_seeded_script_equals_the_jax_server_on_twins(seed):
    port, ref, (seen, ref_seen) = _pair()
    ops = ta.script(seed)
    assert _run(port, ref, ops) == []
    assert ta.untwin(seen) == ta.untwin(ref_seen) and len(seen) > 40
    assert port.dump_state() == ta.untwin(ref.dump_state())


def test_the_script_covers_refusals_and_the_event_cap():
    """Across the seeds, the script binds pods, refuses binds on a taken
    card and in a batch, refuses creates over a hard cap, and evicts
    events past ``MAX_EVENTS``: the parity above covers each."""
    seen: dict = {}
    capped = []
    for seed in SEEDS:
        port, _, _ = _pair()
        for verb, args in ta.script(seed):
            got = ta.outcome(getattr(port, verb), *args)
            if got[0] == "raise":
                seen.setdefault((verb, got[1]), 0)
                seen[(verb, got[1])] += 1
            elif verb in ("bind_pod", "bind_many"):
                seen.setdefault((verb, "ok"), 0)
                seen[(verb, "ok")] += 1
        capped.append(len(port.list_events()) == port.MAX_EVENTS)
    assert any(capped)
    for key in (("bind_pod", "ok"), ("bind_many", "ok"),
                ("bind_pod", "Conflict"), ("bind_many", "Conflict"),
                ("bind_many", "NotFound"), ("create_pod", "QuotaExceeded"),
                ("create_pod", "Conflict"), ("delete_pod", "NotFound"),
                ("update_pod_annotations_many", "Conflict"),
                ("bind_volume", "Conflict"), ("delete_quota", "NotFound")):
        assert seen.get(key), (key, seen)


def test_one_except_catches_the_in_process_and_the_wire_error():
    assert httpapi.Conflict is apiserver.Conflict
    assert httpapi.NotFound is apiserver.NotFound
    assert httpapi.QuotaExceeded is apiserver.QuotaExceeded


def test_restores_equal_the_jax_servers_and_rebuild_the_claims():
    """`restore_state` of a dump, and `restore_object` of every watch
    record, rebuild the same state as JAX's, and the card claims: a second
    bind on a restored pod's card is refused."""
    port, ref, (seen, _) = _pair(max_events=5000)
    _run(port, ref, ta.script(3))
    state = port.dump_state()
    for how in ("state", "records"):
        again = apiserver.InMemoryAPIServer()
        jax_again = jax_api.InMemoryAPIServer()
        if how == "state":
            again.restore_state(state)
            jax_again.restore_state(ta.twin(state))
        else:
            for kind, event, obj in seen:
                again.restore_object(kind, event, obj)
                jax_again.restore_object(kind, event, ta.twin(obj))
        assert again.dump_state() == state
        assert ta.untwin(jax_again.dump_state()) == state
        assert again._card_claims == port._card_claims != {}
        (node, prefix), owner = sorted(port._card_claims.items())[0]
        thief = ta.gpu_pod("thief", 1)
        uuid = prefix.rsplit("/", 1)[1]
        thief["metadata"]["annotations"] = next(
            p for p in state["pods"].values()
            if p["metadata"]["name"] == owner)["metadata"]["annotations"]
        again.create_pod(thief)
        with pytest.raises(apiserver.Conflict) as err:
            again.bind_pod("thief", node)
        assert set(err.value.per_pod) == {"thief"}
        assert uuid in err.value.per_pod["thief"]


def _two_claims(api, conflict):
    """Pods a and b with one allocation (card 3 of host0), bound there one
    after the other."""
    for name in ("a", "b"):
        api.create_pod(ta.gpu_pod(name))
    ann = ta.gpu_pod("x", 1, alloc=(0, (3,)))["metadata"]["annotations"]
    api.bind_many({"a": "host0"}, {"a": ann})
    try:
        api.bind_many({"b": "host0"}, {"b": ann})
    except conflict as err:
        return err
    return None


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_two_pods_bound_onto_one_gpu_card(impl):
    """[jax] The JAX arbiter keys claims by TPU chip paths only: both pods
    commit on one card (ROADMAP Queue 3). [port] The second is refused
    with a Conflict naming the card; the first keeps it."""
    mod = jax_api if impl == "jax" else apiserver
    api = mod.InMemoryAPIServer()
    err = _two_claims(api, mod.Conflict)
    bound = [(api.get_pod(n)["spec"].get("nodeName")) for n in ("a", "b")]
    if impl == "jax":
        assert err is None and bound == ["host0", "host0"]
        return
    uuid = ta.card_path(0, 3).split("/")[-2]
    assert set(err.per_pod) == {"b"} and uuid in err.per_pod["b"]
    assert "taken by a" in err.per_pod["b"]
    assert bound == ["host0", None]
    # bind_pod refuses alike, and a batch that claims one card twice
    api.update_pod_annotations("b", api.get_pod("a")["metadata"][
        "annotations"])
    with pytest.raises(apiserver.Conflict):
        api.bind_pod("b", "host0")
    ann = ta.gpu_pod("x", 1, alloc=(1, (0,)))["metadata"]["annotations"]
    for name in ("c", "d"):
        api.create_pod(ta.gpu_pod(name))
    with pytest.raises(apiserver.Conflict) as batch:
        api.bind_many({"c": "host1", "d": "host1"}, {"c": ann, "d": ann})
    assert "claimed twice in batch" in batch.value.per_pod["d"]
    # once a is gone its card is free
    api.delete_pod("a")
    api.bind_pod("b", "host0")


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_the_hard_cap_on_a_gpu_pod(impl):
    """[jax] `apf.pod_chip_request` counts no card in a GPU pod, so a
    tenant's ``hard_chips`` never refuses one. [port] The cap counts
    cards: a third 2-card pod over a cap of 5 raises QuotaExceeded, and a
    delete frees its cards."""
    mod = jax_api if impl == "jax" else apiserver
    api = mod.InMemoryAPIServer()
    api.set_quota("t", {"hard_chips": 5})
    made = []
    for i in range(3):
        try:
            api.create_pod(ta.gpu_pod(f"p{i}", 2, tenant="t"))
            made.append(i)
        except mod.QuotaExceeded:
            pass
    used = api.list_quotas()["t"]["chips_created"]
    if impl == "jax":
        assert made == [0, 1, 2] and used == 0
        return
    assert made == [0, 1] and used == 4
    api.delete_pod("p0")
    api.create_pod(ta.gpu_pod("p2", 2, tenant="t"))
    assert api.list_quotas()["t"] == {"hard_chips": 5, "chips_created": 4}
