"""The yardstick's arithmetic: model FLOPs, the flash kernels' operations
and bytes, and the chip's peaks.

Model FLOPs count the useful work of the architecture, whatever the
program computes: GQA's narrow K/V projections, the sliding window's
visible pairs, SwiGLU's three products, and only the ``top_k`` experts a
token is routed to (the router's product besides). A product of an
``[n, k]`` by a ``[k, m]`` operand is ``2·n·k·m`` FLOPs; attention is
``4·head_dim`` FLOPs a visible (query, key) pair a head (``QK^T`` and
``PV``); the embedding lookup is free; the head's product counts for
every position. Training is three forwards (the backward twice the
forward).
"""

from __future__ import annotations

from .spec import Model

# one NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def linear_params_per_layer(m: Model) -> int:
    """The parameters of one layer's products that a token uses."""
    d, h, kv = m.d_model, m.n_heads * m.head_dim, m.kv_heads * m.head_dim
    attn = d * h + 2 * d * kv + h * d
    ffn = 3 * d * m.d_ff
    if m.moe:
        return attn + m.top_k * ffn + d * m.n_experts
    return attn + ffn


def visible_pairs(n: int, window: int = 0, start: int = 0) -> int:
    """Visible (query, key) pairs of queries at positions ``start ..
    start + n - 1`` under causal attention (each sees itself), with a
    sliding ``window`` > 0 seeing the newest ``window`` keys."""
    total = 0
    if not window:
        # sum over p of (p + 1)
        a, b = start + 1, start + n
        return (a + b) * n // 2
    for p in range(start, start + n):
        total += min(p + 1, window)
    return total


def forward_flops(m: Model, n_tokens: int, pairs: int) -> int:
    """FLOPs of a forward over ``n_tokens`` positions that see ``pairs``
    (query, key) pairs in all, per layer and head summed over the
    positions."""
    linear = 2 * n_tokens * (m.n_layers * linear_params_per_layer(m)
                             + m.d_model * m.vocab)
    attn = 4 * m.head_dim * m.n_heads * m.n_layers * pairs
    return linear + attn


def train_step_flops(m: Model, batch: int, seq: int) -> int:
    """Model FLOPs of one training step on ``batch`` rows of ``seq``
    inputs: forward plus backward, three forwards."""
    return 3 * forward_flops(m, batch * seq,
                             batch * visible_pairs(seq, m.window))


def prefill_flops(m: Model, prompt_len: int) -> int:
    """A prompt's prefill from position 0, unpadded."""
    return forward_flops(m, prompt_len, visible_pairs(prompt_len, m.window))


def decode_flops(m: Model, position: int) -> int:
    """One decoded token at ``position`` (it sees ``position + 1`` keys,
    fewer under a window)."""
    return forward_flops(m, 1, visible_pairs(1, m.window, start=position))


# -- the flash kernels K1 (forward), K2 (dQ), K3 (dK, dV) ------------------

def flash_call(kernel: str, batch: int, seq: int, heads: int, head_dim: int,
               kv_heads: int | None = None, window: int = 0,
               elem_bytes: int = 2) -> tuple:
    """``(flops, bytes)`` of one causal call over ``batch`` rows of ``seq``
    positions, ``heads`` query heads and ``kv_heads`` K/V heads (GQA: the
    attention's own inputs are the narrow K and V, however the program
    widens them), each input byte read once and each output byte written
    once. K1 reads q, k, v and writes o and the float32 lse; K2 reads q,
    k, v, o, dO and the lse and writes dQ and the float32 row term delta;
    K3 reads q, k, v, dO, the lse and delta and writes dK and dV. A
    visible pair costs 4·D FLOPs in K1 (QK^T, PV), 6·D in K2 (S, dP, dQ)
    and 8·D in K3 (S, dP, dV, dK)."""
    kv_heads = kv_heads or heads
    wide = batch * seq * heads * head_dim * elem_bytes
    narrow = batch * seq * kv_heads * head_dim * elem_bytes
    row = batch * heads * seq * 4
    pairs = batch * heads * visible_pairs(seq, window)
    if kernel == "K1":
        return 4 * head_dim * pairs, wide + 2 * narrow + wide + row
    if kernel == "K2":
        return (6 * head_dim * pairs,
                3 * wide + 2 * narrow + row + wide + row)
    if kernel == "K3":
        return (8 * head_dim * pairs,
                2 * wide + 2 * narrow + 2 * row + 2 * narrow)
    raise ValueError(f"unknown flash kernel {kernel!r}")


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over peak FLOP/s and the bytes over peak bytes/s."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
