"""``kgtpu-gpu-simulate`` (`kubegpu_tpu_torch/cmd/simulate.py`) over fake
HGX hosts: each scenario in process, holding the invariants the JAX
package's tests assert of its own (`tests/test_node_lifecycle.py`,
`tests/test_repair.py:608-618`, `tests/test_ha.py:486-492`,
`tests/test_apf.py:685-700`), and the binary's default mix as a
subprocess, as `tests/test_cmd.py:183` runs the JAX one."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.cmd import simulate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(3))
def test_node_loss_rebinds_the_gang_whole_on_survivors(seed):
    r = simulate.run_chaos_scenario(seed=seed)
    assert set(r["first_placement"].values()) != set(
        r["final_placement"].values())
    assert r["victim"] not in r["final_placement"].values()
    assert len(set(r["final_placement"].values())) == 2
    assert r["recovery_ms"] > 0 and r["evicted_pods"] >= 1
    # the scenario itself raises unless 16 distinct cards are held


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(3))
def test_chip_kill_repairs_without_a_relist(seed):
    r = simulate.run_chip_kill_scenario(seed=seed)
    assert r["repairs"] >= 1, r
    assert r["relists"] == 0, r
    assert r["recovery_ms"] > 0.0
    assert r["injected"][0][0] == "chip-kill"
    assert r["injected"][0][1:] == [r["victim"]["node"],
                                    r["victim"]["chip"]]


@pytest.mark.chaos
def test_ha_places_every_pod_once_across_a_kill_and_a_restart():
    r = simulate.run_ha_chaos_scenario()
    assert r["placed"] == 14
    assert r["watch_relists"] == 0
    assert 0 in r["stolen_shards"] and 1 in r["stolen_shards"]
    assert r["wal_recovered_records"] >= 0 and r["ha"]["wal_appends"] > 0


@pytest.mark.chaos
@pytest.mark.parametrize("proxies", (0, 2))
def test_the_tenant_flood_holds_its_invariants(proxies):
    # the JAX test's scale (tests/test_apf.py:693) with the scenario's own
    # 12 pods a tenant and phase: 24 latencies, so the p99 is not the
    # single slowest create of a loaded machine
    metrics.reset_all()
    r = simulate.run_tenant_flood_scenario(
        tenants=2, churn_pods=12, flood_threads=2, p99_ratio_limit=3.0,
        proxies=proxies)
    assert r["flood"]["accepted"] > 0
    assert r["evictions"] == 0 and r["watch_relists"] == 0
    if proxies:
        # a read flood: the DRF gate never sees the abuser, the proxies do
        assert r["abuser_bound_chips"] == 0
        assert set(r["proxies"]["downstream_watchers"]) == {"proxy0",
                                                            "proxy1"}
        assert r["proxies"]["api_requests_total"]["proxy"] > 0
        assert r["proxies"]["upstream_wire_bytes"]["rx"] > 0
    else:
        assert r["quota_parked"] > 0 or r["flood"]["rejected"] > 0
        assert r["abuser_bound_chips"] <= r["abuser_fair_chips"] + 1


def _cli(module: str, *args) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-m", module, *args, "--json"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def test_the_binary_places_the_mix_with_the_jax_documents_keys():
    doc = _cli("kubegpu_tpu_torch.cmd.simulate", "--hosts", "2")
    placed = {r["pod"]: r for r in doc["placements"]}
    assert set(placed) == {"plain-1card", "memory-floored", "auto-4card",
                           "vol-1card", "gang-0", "gang-1"}
    for name, cards in (("plain-1card", 1), ("memory-floored", 1),
                        ("auto-4card", 4), ("vol-1card", 1)):
        assert placed[name]["node"] != "<pending>", name
        assert len(placed[name]["cards"].split(",")) == cards
    assert placed["vol-1card"] == {**placed["vol-1card"], "node": "host1",
                                   "volume": "demo-vol"}
    # two hosts have 16 cards: the 2 x 8-card gang waits, as the JAX
    # two-host run's 2 x 4-chip gang does
    assert placed["gang-0"]["node"] == placed["gang-1"]["node"] == \
        "<pending>"
    jax_doc = _cli("kubegpu_tpu.cmd.simulate", "--hosts", "2")
    assert set(doc) == set(jax_doc)
    for key in ("fit_cache", "batch", "data_plane"):
        assert set(doc[key]) == set(jax_doc[key]), key
    # four hosts take the whole mix, the gang on two whole hosts
    doc = _cli("kubegpu_tpu_torch.cmd.simulate", "--hosts", "4",
               "--schedulers", "2")
    placed = {r["pod"]: r for r in doc["placements"]}
    assert all(r["node"] != "<pending>" for r in placed.values()), placed
    assert {placed[g]["rank"] for g in ("gang-0", "gang-1")} == {"0/2",
                                                                "1/2"}
    assert len({placed[g]["node"] for g in ("gang-0", "gang-1")}) == 2
    cards = [c for r in placed.values() for c in r["cards"].split(",")]
    assert len(cards) == len(set(cards)) == 1 + 1 + 4 + 1 + 16
    assert doc["ha"]["schedulers"] == 2
