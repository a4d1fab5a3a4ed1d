"""Autoregressive inference: KV-cache prefill and greedy decode.

The counterpart of ``kubegpu_tpu/workload/decode.py``, single device and
greedy:

- the KV cache is allocated at a fixed length up front and every step
  attends the whole cache under a position mask, so each step has the
  same shapes;
- `make_forward_step` takes a scalar ``start_pos`` (the whole batch at one
  depth) or a ``[B]`` tensor of per-row positions (continuous batching);
- `make_decode_chunk` generates up to ``chunk`` tokens for every row in a
  Python loop of tensor operations with no host synchronisation inside:
  EOS and the per-row budget freeze rows on the device, so the host reads
  the chunk back once.

The reference donates the cache to each jitted call, so XLA updates it in
place; here the step writes the new K/V into the cache tensors in place
for the same reason (one multi-slot cache, never copied per token).
Unlike ``lax.dynamic_update_slice``, a tensor write does not clamp an
out-of-range start: callers refuse such writes up front (`make_generate`,
`serve.DecodeServer.submit`).

Sampling (temperature > 0, top-k, top-p) comes with a later slice and
raises `NotImplementedError`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubegpu_tpu_torch._device import resolve_device
from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                              _check_in_slice, _rmsnorm,
                                              _rope)

NEG_INF = -1e30


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device=None):
    """Zeroed per-layer KV cache: a list of ``{"k", "v"}`` of
    ``[B, max_seq, kv_heads, head_dim]`` in the compute dtype."""
    dev = resolve_device(device)
    shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)
    dt = cfg.compute_dtype()
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


def make_forward_step(cfg: TransformerConfig, mesh=None):
    """Build ``step(params, cache, tokens, start_pos) -> (logits, cache)``:
    process ``tokens [B, T]`` whose first token sits at absolute position
    ``start_pos`` (an int, or a ``[B]`` tensor of per-row positions),
    attending everything cached so far plus the chunk itself. The chunk's
    K/V is written into ``cache`` in place; the same list is returned."""
    _check_in_slice(cfg, mesh)

    def step(params, cache, tokens, start_pos):
        dt = cfg.compute_dtype()
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, t = tokens.shape
        s_max = cache[0]["k"].shape[1]
        scale = cfg.head_dim ** -0.5
        per_row = torch.is_tensor(start_pos) and start_pos.dim() == 1
        ar = torch.arange(t, device=dev)
        if per_row:
            row_start = start_pos.to(dev).long()
        else:
            row_start = torch.full((b,), int(start_pos), device=dev,
                                   dtype=torch.long)
        positions = row_start[:, None] + ar[None, :]        # [B, T]
        # chunk position i attends cache positions <= row_start + i (and,
        # with a sliding window, only the newest window of them)
        kv_pos = torch.arange(s_max, device=dev)
        q_pos = positions[:, :, None]
        mask = kv_pos[None, None, :] <= q_pos                # [B, T, S]
        if cfg.attn_window:
            mask &= kv_pos[None, None, :] > q_pos - cfg.attn_window
        rows = torch.arange(b, device=dev)[:, None]

        def write(buf, new):
            if per_row:
                buf[rows, positions] = new
            else:
                p0 = int(start_pos)
                buf[:, p0:p0 + t] = new

        x = params["embed"].to(dt)[tokens]
        for layer, kv in zip(params["layers"], cache):
            h = _rmsnorm(x, layer["ln1"])
            q = (h @ layer["wq"].to(dt)).reshape(b, t, cfg.n_heads,
                                                 cfg.head_dim)
            k = (h @ layer["wk"].to(dt)).reshape(b, t, cfg.kv_heads,
                                                 cfg.head_dim)
            v = (h @ layer["wv"].to(dt)).reshape(b, t, cfg.kv_heads,
                                                 cfg.head_dim)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            write(kv["k"], k.to(dt))
            write(kv["v"], v.to(dt))
            ck, cv = kv["k"].float(), kv["v"].float()

            # float32 products of the bf16 values (float32 accumulation,
            # as the reference). With GQA the query heads are grouped
            # against the narrow cache (g = kv head, r = query head in the
            # group), so the full-width K/V is never materialized.
            if cfg.kv_heads != cfg.n_heads:
                rep = cfg.n_heads // cfg.kv_heads
                qg = q.reshape(b, t, cfg.kv_heads, rep, cfg.head_dim)
                s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck) * scale
                s = s.masked_fill(~mask[:, None, None], NEG_INF)
                p = torch.softmax(s, dim=-1)
                attn = torch.einsum("bgrqk,bkgd->bqgrd",
                                    p.to(dt).float(), cv)
                attn = attn.reshape(b, t, cfg.n_heads, cfg.head_dim)
            else:
                s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck) * scale
                s = s.masked_fill(~mask[:, None], NEG_INF)
                p = torch.softmax(s, dim=-1)
                attn = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), cv)
            x = x + attn.to(dt).reshape(b, t, -1) @ layer["wo"].to(dt)

            h = _rmsnorm(x, layer["ln2"])
            up = h @ layer["w_up"].to(dt)
            gate = F.silu(h @ layer["w_gate"].to(dt))
            x = x + (up * gate) @ layer["w_down"].to(dt)

        x = _rmsnorm(x, params["final_norm"])
        logits = x @ params["unembed"].to(dt)
        return logits.float(), cache

    return torch.no_grad()(step)


def validate_sampling(cfg: TransformerConfig, temperature: float,
                      top_k: int, top_p: float) -> int:
    """Shared validation for every decode entry point: raises on
    out-of-range values and on truncation flags under greedy; returns
    ``top_k`` clamped to the vocab."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if temperature == 0.0 and (top_k or top_p < 1.0):
        raise ValueError(
            "top_k/top_p truncate SAMPLING and are ignored by greedy "
            "decode — set temperature > 0 to use them")
    return min(top_k, cfg.vocab)


def _greedy_only(temperature: float) -> None:
    if temperature != 0.0:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) comes with the sampling "
            "slice (slice 4); this slice decodes greedily")


def make_decode_chunk(cfg: TransformerConfig, mesh=None, chunk: int = 16,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, eos_id: int | None = None):
    """Build the fused decode chunk the server dispatches:
    ``chunk_step(params, cache, tok, pos, active, budget) -> (cache, toks
    [B, chunk], n_emit [B], tok, pos, active)``.

    ``tok``/``pos`` are each row's last emitted token and its position;
    ``active [B] bool`` masks the rows that emit (inactive rows ride
    along frozen, rewriting the same K/V position with the same values);
    ``budget [B]`` is each row's remaining quota. A row that emits EOS or
    its budget-th token freezes for the rest of the chunk, so its tokens
    are a clean prefix of ``toks[b]`` of length ``n_emit[b]``. The loop
    stays on the device: no value is read back inside it."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    validate_sampling(cfg, temperature, top_k, top_p)
    _greedy_only(temperature)
    step = make_forward_step(cfg, mesh)

    @torch.no_grad()
    def chunk_step(params, cache, tok, pos, active, budget):
        emitted = torch.zeros_like(pos)
        toks = []
        for _ in range(chunk):
            logits, cache = step(params, cache, tok[:, None], pos)
            nxt = logits[:, -1, :].argmax(-1).to(tok.dtype)
            emit = active
            nxt = torch.where(emit, nxt, tok)        # frozen rows hold
            pos = torch.where(emit, pos + 1, pos)
            emitted = emitted + emit.to(emitted.dtype)
            alive = emitted < budget
            if eos_id is not None:
                alive &= nxt != eos_id               # EOS is emitted, THEN
            active = active & alive                  # the row freezes
            toks.append(torch.where(emit, nxt, torch.zeros_like(nxt)))
            tok = nxt
        return cache, torch.stack(toks, 1), emitted, tok, pos, active

    return chunk_step


def make_generate(cfg: TransformerConfig, mesh=None,
                  max_seq: int | None = None, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0):
    """Build ``generate(params, prompt, n_new) -> tokens [B, n_new]``:
    greedy prefill plus ``n_new - 1`` decode steps over a cache sized to
    the call's 128-aligned horizon."""
    max_seq = max_seq or cfg.max_seq
    validate_sampling(cfg, temperature, top_k, top_p)
    _greedy_only(temperature)
    step = make_forward_step(cfg, mesh)

    @torch.no_grad()
    def generate(params, prompt, n_new: int):
        dev = params["embed"].device
        prompt = torch.as_tensor(prompt, device=dev).long()
        b, t0 = prompt.shape
        if t0 + n_new > max_seq:
            # a write past the cache end would fail or corrupt the cache
            # while RoPE positions keep advancing, so refuse
            raise ValueError(
                f"prompt ({t0}) + n_new ({n_new}) exceeds max_seq "
                f"({max_seq}); raise max_seq= on make_generate")
        horizon = min(max_seq, -(-(t0 + n_new) // 128) * 128)
        cache = init_cache(cfg, b, horizon, dev)
        logits, cache = step(params, cache, prompt, 0)
        tok = logits[:, -1, :].argmax(-1)
        out = [tok]
        for i in range(1, n_new):
            logits, cache = step(params, cache, tok[:, None], t0 + i - 1)
            tok = logits[:, -1, :].argmax(-1)
            out.append(tok)
        return torch.stack(out, 1)

    return generate
