"""The one place the harness names the program's configuration type."""

from __future__ import annotations

from .spec import Model


def port_config(m: Model, max_seq: int, aux_weight: float = 0.01):
    """``m`` as ``kubegpu_tpu_torch``'s ``TransformerConfig``: the flash
    kernel where the program picks it ("auto"), no rematerialisation."""
    from kubegpu_tpu_torch.workload.model import TransformerConfig

    cfg = TransformerConfig(
        vocab=m.vocab, d_model=m.d_model, n_heads=m.n_heads,
        n_layers=m.n_layers, d_ff=m.d_ff, max_seq=max_seq,
        rope_theta=m.rope_theta, dtype=m.compute_dtype, attn_impl="auto",
        n_experts=m.n_experts, moe_top_k=m.top_k, moe_aux_weight=aux_weight,
        remat="none", attn_window=m.window,
        n_kv_heads=0 if m.kv_heads == m.n_heads else m.kv_heads)
    if cfg.head_dim != m.head_dim:
        raise ValueError(f"{m.name}: head_dim {m.head_dim} is not "
                         f"d_model / n_heads = {cfg.head_dim}")
    return cfg
