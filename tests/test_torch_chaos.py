"""The port's fault injectors (`kubegpu_tpu_torch/cluster/chaos.py`)
against the JAX package's: `ChaosNetwork`'s fault sequence for one seed,
`DeviceChaos`'s picks over twin fleets of equal counts, a killed card
leaving the advertisement, a flapping card, the refused ``link-down``, and
`TenantFlood`'s accounting of 429s against the port's server."""

import contextlib
import random
import threading
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import chaos as jax_chaos  # noqa: E402
from kubegpu_tpu.cluster import httpapi as jax_http  # noqa: E402
from kubegpu_tpu.node import fake as jax_fake  # noqa: E402
from kubegpu_tpu_torch.cluster import apiserver, chaos, httpapi  # noqa: E402
from kubegpu_tpu_torch.cluster.apf import TooManyRequests  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser  # noqa: E402
from kubegpu_tpu_torch.node.backend import CHIP_DEGRADED  # noqa: E402
from kubegpu_tpu_torch.node.manager import (DevicesManager,  # noqa: E402
                                            GPUDeviceManager)

VERBS = ("get_pod", "bind_many", "create_pod", "patch_node_metadata",
         "list_pods", "record_event")


class _Stub:
    """Every verb answers its own name."""

    def __getattr__(self, name):
        return lambda *a, **k: name


def _fault_sequence(mod, seed: int) -> list:
    """``(component, verb, fault)`` of a seeded single-threaded call
    sequence through ``mod``'s chaos network, partitions among them."""
    net = mod.ChaosNetwork(seed=seed)
    proxies = {
        "agent": net.proxy(_Stub(), "agent", mod.ChaosConfig(drop=0.2)),
        "scheduler": net.proxy(_Stub(), "scheduler", mod.ChaosConfig(
            drop=0.1, delay=0.3, delay_s=0.0001, duplicate=0.2,
            verbs={"bind_many", "get_pod", "create_pod"})),
        "lifecycle": net.proxy(_Stub(), "lifecycle", mod.ChaosConfig(
            drop=0.15, duplicate=0.1, exempt={"list_pods"})),
    }
    caller = random.Random(1000 + seed)
    out = []
    for i in range(150):
        if i % 40 == 20:
            net.partition("agent")
        if i % 40 == 30:
            net.heal()
        comp = caller.choice(sorted(proxies))
        verb = caller.choice(VERBS)
        before = dict(net.faults)
        try:
            getattr(proxies[comp], verb)()
            fault = "ok"
        except ConnectionError:
            fault = "refused"
        grew = sorted(k for k, n in net.faults.items()
                      if before.get(k, 0) != n)
        out.append((comp, verb, fault, grew))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_the_fault_sequence_equals_jax_verb_for_verb(seed):
    mine = _fault_sequence(chaos, seed)
    assert mine == _fault_sequence(jax_chaos, seed)
    kinds = {k for *_, grew in mine for _, k in grew}
    assert {"drop", "partition", "delay", "duplicate"} <= kinds
    # and it replays identically, three runs in a row
    assert mine == _fault_sequence(chaos, seed) == \
        _fault_sequence(chaos, seed)


def _gpu_fleet(hosts: int) -> dict:
    return {f"n{i}": fake.FakeGPUBackend(fake.hgx_h100_inventory(i))
            for i in range(hosts)}


def _tpu_fleet(hosts: int) -> dict:
    """Fake TPU hosts of eight chips each (two v5p blocks apiece): the GPU
    fleet's counts."""
    out = {}
    for i in range(hosts):
        inv = jax_fake.v5p_host_inventory((0, 4 * i, 0), (4, 4 * hosts, 1))
        inv.chips += jax_fake.v5p_host_inventory((2, 4 * i, 0),
                                                 (4, 4 * hosts, 1)).chips
        out[f"n{i}"] = jax_fake.FakeTPUBackend(inv)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_device_chaos_picks_as_jax_on_twin_fleets(seed):
    gpus, tpus = _gpu_fleet(3), _tpu_fleet(3)
    picks = []
    for mod, fleet, devices in (
            (chaos, gpus, lambda b: [g.uuid for g in b.inventory.gpus]),
            (jax_chaos, tpus, lambda b: [c.chip_id
                                         for c in b.inventory.chips])):
        dc = mod.DeviceChaos(fleet, seed=seed)
        seq = []
        for i in range(12):
            node, dev = dc.kill_chip() if i % 3 else dc.flap_chip(period=3)
            seq.append((sorted(fleet).index(node),
                        devices(fleet[node]).index(dev)))
        picks.append(seq)
        assert [f[0] for f in dc.injected] == \
            ["chip-flap" if i % 3 == 0 else "chip-kill" for i in range(12)]
    assert picks[0] == picks[1]
    assert len(set(picks[0])) > 4


def _advertised_cards(api, node: str) -> set:
    info = codec.annotation_to_node_info(api.get_node(node)["metadata"])
    return {grammar.gpu_id_from_path(r) for r in info.allocatable
            if grammar.gpu_id_from_path(r)}


def test_a_killed_card_leaves_the_next_advertisement():
    api = apiserver.InMemoryAPIServer()
    backends = _gpu_fleet(2)
    advs = {}
    for name, backend in backends.items():
        api.create_node({"metadata": {"name": name}})
        mgr = DevicesManager()
        mgr.add_device(GPUDeviceManager(backend))
        mgr.start()
        advs[name] = DeviceAdvertiser(api, mgr, name)
        advs[name].advertise_once()
    assert all(len(_advertised_cards(api, n)) == 8 for n in backends)
    dc = chaos.DeviceChaos(backends, seed=5)
    node, uuid = dc.kill_chip()
    advs[node].advertise_once()
    assert _advertised_cards(api, node) == \
        {g.uuid for g in backends[node].inventory.gpus} - {uuid}
    health = codec.annotation_to_chip_health(api.get_node(node)["metadata"])
    assert health == {uuid: "failed"}
    # named, on the other host
    other = next(n for n in backends if n != node)
    card = backends[other].inventory.gpus[6].uuid
    assert dc.kill_chip(node=other, chip_id=card) == (other, card)
    advs[other].advertise_once()
    assert card not in _advertised_cards(api, other)
    with pytest.raises(KeyError):
        dc.kill_chip(node=other, chip_id="GPU-none")


def test_a_flapping_card_follows_its_period():
    backend = fake.FakeGPUBackend(fake.hgx_h100_inventory(0))
    dc = chaos.DeviceChaos({"n0": backend}, seed=0)
    node, uuid = dc.flap_chip(period=3)
    reports = [backend.chip_health().get(uuid) for _ in range(9)]
    assert reports == [None, None, CHIP_DEGRADED] * 3
    assert dc.injected == [("chip-flap", "n0", uuid, "period=3")]
    backend.set_chip_flapper(uuid, None)
    assert uuid not in backend.chip_health()


def test_link_down_is_refused_with_the_divergence():
    dc = chaos.DeviceChaos(_gpu_fleet(1), seed=0)
    assert dc.KINDS == ("chip-kill", "chip-flap")
    for call in (lambda: dc.step("link-down"), dc.cut_link):
        with pytest.raises(ValueError, match="deliberate divergence"):
            call()
    with pytest.raises(ValueError, match="unknown device fault"):
        dc.step("meltdown")
    assert dc.injected == []
    # a planned schedule draws only the kinds it can inject
    assert set(dc.plan(20)) == set(dc.KINDS)


class _CountingDoor:
    """A stand-in front door that sheds every other pod create (by the
    index in the flood's pod name) with a 429, and counts both."""

    def __init__(self):
        self.lock = threading.Lock()
        self.admitted = self.shed = 0

    @contextlib.contextmanager
    def admit(self, method, parts, query=None, body=None, peer=""):
        if method == "POST" and parts == ["pods"]:
            name = body["metadata"]["name"]
            with self.lock:
                if int(name.rsplit("-", 1)[1]) % 2:
                    self.shed += 1
                    raise TooManyRequests("shed", retry_after_s=0.5)
                self.admitted += 1
        yield "workload"


@pytest.mark.parametrize("threads", (1, 3))
def test_the_tenant_flood_counts_its_429s_as_jax(threads):
    results = []
    for flood_mod, client_cls in ((chaos, httpapi.HTTPAPIClient),
                                  (jax_chaos, jax_http.HTTPAPIClient)):
        door = _CountingDoor()
        api = apiserver.InMemoryAPIServer()
        server, url = httpapi.serve_api(api, apf=door)
        try:
            flood = flood_mod.TenantFlood(
                lambda: client_cls(url, wire="stream"), tenant="abuser",
                threads=threads, pace_s=0.0).start()
            deadline = time.monotonic() + 10.0
            while door.admitted < 30 and time.monotonic() < deadline:
                time.sleep(0.01)
            counts = flood.stop()
        finally:
            server.shutdown()
        assert counts == {"accepted": door.admitted, "rejected": door.shed,
                          "errored": 0}
        assert len(api.list_pods()) == door.admitted >= 30
        # one pod in two is shed: the two counts differ by at most one a
        # thread
        assert abs(counts["accepted"] - counts["rejected"]) <= threads
        results.append(counts)
    pods = [p for p in api.list_pods()]
    assert all(p["metadata"]["labels"] == {"kgtpu.io/tenant": "abuser"}
               for p in pods)
    # the port's flood asks for cards, the JAX one for chips
    mine = chaos.TenantFlood(lambda: None)._flood_pod("x")
    assert grammar.RESOURCE_NUM_GPU in mine["metadata"]["annotations"][
        codec.POD_ANNOTATION_KEY]
