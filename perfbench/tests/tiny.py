"""A tiny copy of the benchmark for CPU tests: the same cells, metrics and
readers, at sizes the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness.spec import PERFBENCH, ROOT

TINY_MODEL = {
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "sliding_window": 48,
    "dtypes": {"weights": "float32", "compute": "bfloat16"},
    "serve": {"slots": 4, "max_seq": 128, "chunk": 4,
              "prefill_buckets": [16, 32, 64, 128]}}
TINY_MOE = dict(TINY_MODEL, num_local_experts=4, num_experts_per_tok=2,
                sliding_window=None)
TINY_MIX = {
    "train4k": {"kind": "train", "batch": 2, "seq": 32, "lr": 3e-4,
                "doc_len": {"dist": "lognormal", "median": 24, "sigma": 1.0,
                            "min": 4, "max": 200},
                "shard_tokens": 20000, "eos_id": 2, "zipf_a": 1.1},
    "chat": {"kind": "open_loop", "rate_per_s": 20.0, "preroll_s": 0.3,
             "drain_s": 20,
             "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.8,
                        "min": 4, "max": 60},
             "output": {"dist": "lognormal", "median": 8, "sigma": 0.7,
                        "min": 2, "max": 30}, "sample": 3},
    "longprompt": {"kind": "backlog", "requests": 40,
                   "prompt": {"dist": "uniform", "min": 40, "max": 90},
                   "output": {"dist": "uniform", "min": 4, "max": 10},
                   "sample": 3},
    "reasoning": {"kind": "backlog", "requests": 40,
                  "prompt": {"dist": "uniform", "min": 8, "max": 24},
                  "output": {"dist": "uniform", "min": 30, "max": 60},
                  "sample": 2},
}


def make(tmp: Path, limits: dict | None = None) -> Path:
    """A benchmark tree under ``tmp`` with BENCHMARK.json's cells, and the
    cells held in ``pending/``, at tiny sizes; returns its ``perfbench``
    directory. ``limits`` replaces a cell's committed limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for pending in sorted((PERFBENCH / "pending").glob("*.json")):
        extra = json.loads(pending.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += extra[key]
    base = Path(tmp) / "perfbench"
    (base / "configs").mkdir(parents=True)
    (base / "traffic").mkdir()
    (base / "limits").mkdir()
    shutil.copytree(PERFBENCH / "metrics", base / "metrics")
    for c in bench["configs"]:
        moe = "mixtral" in c["name"]
        (Path(tmp) / c["file"]).write_text(
            json.dumps(TINY_MOE if moe else TINY_MODEL))
    for name, mix in TINY_MIX.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for w in bench["workloads"]:
        lim = json.loads((PERFBENCH / "limits" / f"{w['name']}.json")
                         .read_text())
        if limits is not None:
            lim = limits.get(w["name"], lim)
        (base / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(bench))
    return base
