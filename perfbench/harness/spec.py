"""What a cell is made of, found by name.

A ``BENCHMARK.json`` workload names a configuration and a traffic mix; the
harness reads:

- ``perfbench/configs/<config>.json``: the model's published sizes as
  run (Hugging Face key names), its cuts, and its serving settings;
- ``perfbench/traffic/<traffic>.json``: the parameters the one general
  generator (`traffic`) reads;
- ``perfbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``;
- ``perfbench/metrics/<metric>.py``: one reader a metric (`load_reader`).

Adding a configuration, a mix, a cell or a metric adds files and entries;
nothing here changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


@dataclass(frozen=True)
class Model:
    """A configuration file's sizes, in the names the harness uses."""
    name: str
    vocab: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    n_layers: int
    d_ff: int
    rope_theta: float
    window: int            # 0 = full causal
    n_experts: int         # 0 = dense SwiGLU
    top_k: int
    norm_eps: float
    weights_dtype: str
    compute_dtype: str
    serve: dict

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


def model_from_file(name: str, raw: dict) -> Model:
    """The `Model` of a configuration file (Hugging Face key names)."""
    d = int(raw["hidden_size"])
    heads = int(raw["num_attention_heads"])
    return Model(
        name=name, vocab=int(raw["vocab_size"]), d_model=d, n_heads=heads,
        kv_heads=int(raw.get("num_key_value_heads") or heads),
        head_dim=int(raw.get("head_dim") or d // heads),
        n_layers=int(raw["num_hidden_layers"]),
        d_ff=int(raw["intermediate_size"]),
        rope_theta=float(raw["rope_theta"]),
        window=int(raw.get("sliding_window") or 0),
        n_experts=int(raw.get("num_local_experts") or 0),
        top_k=int(raw.get("num_experts_per_tok") or 1),
        norm_eps=float(raw["rms_norm_eps"]),
        weights_dtype=raw["dtypes"]["weights"],
        compute_dtype=raw["dtypes"]["compute"],
        serve=dict(raw.get("serve", {})))


@dataclass(frozen=True)
class Cell:
    """One ``BENCHMARK.json`` workload with everything it names."""
    name: str
    chips: int
    model: Model
    mix_name: str
    mix: dict
    limits: dict
    end_to_end: list       # the metric entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return _load_json(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(bench: dict, workload: str, base: Path = PERFBENCH) -> Cell:
    """The cell ``workload`` of ``bench``, its files read from ``base``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    model = model_from_file(
        w["config"], _load_json(Path(base).parent / cfg_entry["file"]))
    mix = _load_json(Path(base) / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(Path(base) / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, workload, reported)]
    return Cell(workload, int(w["chips"]), model, w["traffic"], mix, limits,
                e2e, layer)


def load_reader(metric: str, base: Path = PERFBENCH):
    """The ``read(ctx) -> float | None`` of ``metrics/<metric>.py``."""
    path = Path(base) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``weights``, ``traffic``, ...) of a
    run's ``--seed``; distinct tags give unrelated streams."""
    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
