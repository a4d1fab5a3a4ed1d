"""Named model-family presets: the port's own copy of
``kubegpu_tpu/workload/presets.py``.

The dictionary is the reference's, entry for entry (a test holds the two
equal). Every family builds a `TransformerConfig`; ``long-ring`` and
``long-ulysses`` name the sequence-parallel strategy over a mesh whose
``seq`` axis is > 1 (`ring`, `ulysses`): on one device they run as
``dense``.
"""

from __future__ import annotations

from typing import Any, Dict

from kubegpu_tpu_torch.workload.model import TransformerConfig

_BASE: Dict[str, Any] = dict(vocab=512, d_model=128, n_heads=8,
                             n_layers=2, d_ff=384, max_seq=512)

PRESETS: Dict[str, Dict[str, Any]] = {
    "dense": dict(_BASE),
    "gqa": dict(_BASE, n_kv_heads=2),
    "windowed": dict(_BASE, attn_window=64),
    "moe": dict(_BASE, n_experts=4, moe_top_k=2),  # Mixtral-style top-2
    "long-ring": dict(_BASE, seq_impl="ring"),
    "long-ulysses": dict(_BASE, seq_impl="ulysses"),
}


def preset_names() -> list[str]:
    return sorted(PRESETS)


def make_config(name: str, **overrides: Any) -> TransformerConfig:
    """Build a preset's config; keyword overrides win (e.g. d_model)."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; known: {', '.join(preset_names())}")
    return TransformerConfig(**{**PRESETS[name], **overrides})
