"""BENCHMARK.json and the files it names: the contract's shape, the
published widths of each configuration, and its cuts listed."""

import json
import re

import pytest

from perfbench.harness.spec import PERFBENCH, ROOT, load_bench, load_cell

BENCH = load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the published config.json of each source
PUBLISHED = {
    "mistral-7b-pp4": {
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "num_hidden_layers": 32, "vocab_size": 32000,
        "rope_theta": 10000.0, "sliding_window": 4096,
        "max_position_embeddings": 32768, "rms_norm_eps": 1e-05,
        "tie_word_embeddings": False, "hidden_act": "silu"},
    "mixtral-8x7b-pp4": {
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "num_hidden_layers": 32, "vocab_size": 32000,
        "rope_theta": 1e6, "sliding_window": None,
        "max_position_embeddings": 32768, "rms_norm_eps": 1e-05,
        "tie_word_embeddings": False, "hidden_act": "silu",
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "router_aux_loss_coef": 0.02},
}
# keys that name a width, which a cut may never change
WIDTH = re.compile(r"^(hidden_size|.*intermediate_size|head_dim|.*_dim"
                   r"|.*_rank|.*latent.*|.*state_size|.*projection.*"
                   r"|.*expan.*|num_experts_per_tok)$")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_holds_published_widths(entry):
    raw = json.loads((ROOT / entry["file"]).read_text())
    pub = PUBLISHED[entry["name"]]
    changed = {k for k, v in pub.items() if raw.get(k, "absent") != v}
    assert changed == set(entry["reduced"])
    assert not any(WIDTH.search(k) for k in entry["reduced"])
    assert raw["published"] == {k: pub[k] for k in entry["reduced"]}
    assert entry["file"].startswith("perfbench/")


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in BENCH["workloads"])


def test_every_cell_reports_what_its_metrics_move():
    bench = BENCH
    for w in bench["workloads"]:
        cell = load_cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            cell = load_cell(bench, w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_stays_inside_paths():
    assert BENCH["paths"] == ["perfbench"]
    for word in BENCH["command"][1:]:
        assert word.startswith("perfbench/") and ".." not in word
