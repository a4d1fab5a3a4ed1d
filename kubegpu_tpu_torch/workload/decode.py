"""Autoregressive inference: KV-cache prefill and decode, greedy or
sampled.

The counterpart of ``kubegpu_tpu/workload/decode.py``:

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

Over a mesh (`spmd.make_mesh`) the batch is split over ``data`` and the
heads over ``model``, the KV cache likewise (`cache_pspecs`): each rank
runs the same eager program on its shards and its rows, and calls the
collectives GSPMD would insert (reference ``decode.py:60-160``): the
layer input enters the column-parallel products through `spmd.copy_to`,
``wo`` and ``w_down`` leave through `spmd.reduce_from`, the
vocabulary-split logits are gathered over ``model``. `make_generate` and
`make_decode_chunk` take the global batch and return it, each rank's rows
gathered over ``data`` once a call (a chunk).

Sampling (temperature > 0, truncated by top-k and the top-p nucleus)
has the reference's semantics (`_truncate_logits`); its randomness is the
port's own counter-based keys (`keys`), since threefry's bits cannot be
matched: each draw is Gumbel-max over the truncated logits, keyed by its
lineage alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubegpu_tpu_torch._device import resolve_device
from kubegpu_tpu_torch.obs.trace import device_span
from kubegpu_tpu_torch.workload import keys, spmd
from kubegpu_tpu_torch.workload.model import (TransformerConfig, _ffn,
                                              _rmsnorm, _rope, gather_span,
                                              span_attention, whole_heads)

NEG_INF = -1e30


def cache_pspecs(cfg: TransformerConfig, mesh=None) -> list:
    """The KV cache's layout over a mesh, a tree matching `init_cache`:
    per layer ``{"k", "v"}`` of the mesh axis each of the four dimensions
    ``[B, max_seq, kv_heads, head_dim]`` is split over (None: replicated),
    as the reference's ``PartitionSpec``: the batch over ``data``, the kv
    heads over ``model``, or replicated when ``tp > 1`` does not divide
    them (the reference's rule): then every rank of ``model`` writes every
    kv head, gathered over ``model`` (`make_forward_step`)."""
    head_axis = spmd.AXIS_MODEL
    tp = spmd.axis_size(mesh, spmd.AXIS_MODEL)
    if tp > 1 and cfg.kv_heads % tp:
        head_axis = None
    spec = (spmd.AXIS_DATA, None, head_axis, None)
    return [{"k": spec, "v": spec} for _ in range(cfg.n_layers)]


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device=None, mesh=None, split_rows: bool = True):
    """Zeroed per-layer KV cache: a list of ``{"k", "v"}`` of
    ``[B, max_seq, kv_heads, head_dim]`` in the compute dtype. Over a mesh,
    this rank's block of it by `cache_pspecs`: ``B/dp`` rows and its kv
    heads; ``split_rows=False`` keeps all ``B`` rows on every rank (a
    prefill every rank computes, as the server's admission)."""
    dev = resolve_device(device)
    shape = [batch, max_seq, cfg.kv_heads, cfg.head_dim]
    if mesh is not None:
        for dim, axis in enumerate(cache_pspecs(cfg, mesh)[0]["k"]):
            if axis is None or (dim == 0 and not split_rows):
                continue
            n = spmd.axis_size(mesh, axis)
            if shape[dim] % n:
                raise ValueError(f"cache dimension {dim} ({shape[dim]}) "
                                 f"not divisible by the {axis} axis ({n})")
            shape[dim] //= n
    dt = cfg.compute_dtype()
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


def _data_rows(mesh, batch: int) -> tuple:
    """``(first, count)``: this rank's rows of a global batch of ``batch``
    over ``data`` (all of it without a mesh); raises unless ``dp`` divides
    it."""
    dp = spmd.axis_size(mesh, spmd.AXIS_DATA)
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by dp {dp}")
    rows = batch // dp
    return spmd.axis_rank(mesh, spmd.AXIS_DATA) * rows, rows


def gather_rows(mesh, x):
    """Every ``data`` rank's rows of ``x`` (dimension 0) in rank order, on
    every rank (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    group = mesh.get_group(spmd.AXIS_DATA)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def make_forward_step(cfg: TransformerConfig, mesh=None):
    """Build ``step(params, cache, tokens, start_pos) -> (logits, cache)``:
    process ``tokens [B, T]`` whose first token sits at absolute position
    ``start_pos`` (an int, or a ``[B]`` tensor of per-row positions),
    attending everything cached so far plus the chunk itself. The chunk's
    K/V is written into ``cache`` in place; the same list is returned.

    Over a mesh ``params`` are this rank's shards (`spmd.shard_params`),
    ``cache`` its block (`init_cache` with the mesh), ``tokens`` and
    ``start_pos`` its rows; attention runs on its ``H/tp`` heads and the
    logits come back whole over the vocabulary, for its rows. Where ``tp``
    does not divide the head counts, the rank gathers the new K/V (and,
    for ``n_heads``, Q) over ``model``, writes every kv head into its
    replicated cache block and attends the heads its columns overlap
    (`model.span_attention`).

    While a profiler runs, each layer's cache write and attention (all
    that reads the cache) are a ``kgt.model.attn`` range and its FFN a
    ``kgt.model.ffn`` one, ``kgt.model.moe`` where the layer holds
    experts (`obs.trace.device_span`); the projections, norms and head
    lie outside them."""
    if mesh is not None:
        spmd.check_mesh(mesh)
        spmd.check_tp(cfg, spmd.axis_size(mesh, spmd.AXIS_MODEL))
    tp = spmd.axis_size(mesh, spmd.AXIS_MODEL)
    tp_rank = spmd.axis_rank(mesh, spmd.AXIS_MODEL)
    whole = whole_heads(cfg, tp)
    heads, kv_heads = cfg.n_heads // tp, cfg.kv_heads // tp

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

        def attend(q, ck, cv):
            """float32 products of the bf16 values (float32 accumulation,
            as the reference). With GQA the query heads are grouped
            against the narrow cache (g = kv head, r = query head in the
            group), so the full-width K/V is never materialized."""
            hq, hk = q.shape[2], ck.shape[2]
            if hk != hq:
                rep = hq // hk
                qg = q.reshape(b, t, hk, rep, cfg.head_dim)
                s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck) * scale
                s = s.masked_fill(~mask[:, None, None], NEG_INF)
                p = torch.softmax(s, dim=-1)
                attn = torch.einsum("bgrqk,bkgd->bqgrd",
                                    p.to(dt).float(), cv)
                return attn.reshape(b, t, hq, cfg.head_dim)
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck) * scale
            s = s.masked_fill(~mask[:, None], NEG_INF)
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), cv)

        x = params["embed"].to(dt)[tokens]
        for layer, kv in zip(params["layers"], cache):
            h = spmd.copy_to(mesh, _rmsnorm(x, layer["ln1"]))
            q = h @ layer["wq"].to(dt)
            k, v = h @ layer["wk"].to(dt), h @ layer["wv"].to(dt)
            if whole:
                q = q.reshape(b, t, heads, cfg.head_dim)
                k = k.reshape(b, t, kv_heads, cfg.head_dim)
                v = v.reshape(b, t, kv_heads, cfg.head_dim)
            else:
                # the cache holds every kv head (cache_pspecs)
                q, k, v = gather_span(cfg, mesh, q, k, v)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            with device_span("kgt.model.attn"):     # all that reads the cache
                write(kv["k"], k.to(dt))
                write(kv["v"], v.to(dt))
                ck, cv = kv["k"].float(), kv["v"].float()
                if whole:
                    attn = attend(q, ck, cv).reshape(b, t, -1)
                else:
                    attn = span_attention(cfg, q, ck, cv, tp, tp_rank,
                                          attend)
            x = x + spmd.reduce_from(
                mesh, attn.to(dt) @ layer["wo"].to(dt))

            h = _rmsnorm(x, layer["ln2"])
            with device_span("kgt.model.moe" if "moe" in layer
                             else "kgt.model.ffn"):
                h = _ffn(layer, h, dt, cfg, mesh)[0]
            x = x + h

        x = spmd.copy_to(mesh, _rmsnorm(x, params["final_norm"]))
        logits = spmd.gather_last(mesh, x @ params["unembed"].to(dt))
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


def _truncate_logits(z, top_k: int, top_p: float):
    """Top-k and nucleus truncation of scaled logits ``z [..., V]``
    (masked tokens go to NEG_INF), shared by direct sampling and
    speculative decoding so both see the same support. Ties at the k-th
    largest logit are all kept. The nucleus keeps a token while the mass
    of the strictly better tokens (the exclusive cumulative sum) is below
    ``top_p``, so the token that crosses ``top_p`` stays and the top-1 is
    never dropped."""
    if top_k:
        kth = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = torch.where(z < kth, NEG_INF, z)
    if top_p < 1.0:
        z_sorted = torch.sort(z, dim=-1, descending=True).values
        probs = torch.softmax(z_sorted, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        # the threshold is the smallest kept logit
        thr = torch.where(keep, z_sorted, torch.inf).amin(-1, keepdim=True)
        z = torch.where(z < thr, NEG_INF, z)
    return z


def truncated_probs(logits, temperature: float, top_k: int, top_p: float):
    """The distribution `_select_token_rows` samples from: the
    temperature-scaled softmax truncated to the top-k/nucleus support and
    renormalised, per row. Speculative sampling runs its acceptance rule
    on these for both target and draft."""
    z = _truncate_logits(logits.float() / temperature, top_k, top_p)
    return torch.softmax(z, dim=-1)


def _select_token_rows(logits, rkeys, temperature: float, top_k: int,
                       top_p: float):
    """The next token of each row of ``logits [B, V]``: argmax when
    greedy (the keys unread), else Gumbel-max over the truncated scaled
    logits with row ``i``'s own key ``rkeys[i]``, so a row's draw depends
    on its key alone."""
    if temperature == 0.0:
        return logits.argmax(-1)
    z = _truncate_logits(logits.float() / temperature, top_k, top_p)
    return (z + keys.gumbel(rkeys, z.shape[-1])).argmax(-1)


def _pick_rows(logits, rkeys, temperature: float, top_k: int,
               top_p: float):
    """The speculative paths' selection: the next token of each row of
    ``logits [B, V]`` and, when sampling, the truncated row
    (`truncated_probs`) it was drawn from, by Gumbel-max over its log with
    ``rkeys`` (None when greedy)."""
    if temperature == 0.0:
        return logits.argmax(-1), None
    p = truncated_probs(logits, temperature, top_k, top_p)
    return (torch.log(p.clamp_min(1e-30))
            + keys.gumbel(rkeys, p.shape[-1])).argmax(-1), p


def _select_token(logits, key, temperature: float, top_k: int,
                  top_p: float, row0: int = 0):
    """`_select_token_rows` with one key for the whole batch: row ``i``
    draws with ``fold(key, row0 + i)``, ``row0`` being the first row's
    index in the global batch."""
    if temperature == 0.0:
        return logits.argmax(-1)
    rows = row0 + torch.arange(logits.shape[0], device=logits.device)
    return _select_token_rows(logits, keys.fold(key, rows), temperature,
                              top_k, top_p)


def make_decode_chunk(cfg: TransformerConfig, mesh=None, chunk: int = 16,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, eos_id: int | None = None):
    """Build the fused decode chunk the server dispatches:
    ``chunk_step(params, cache, tok, pos, active, budget, skeys=None) ->
    (cache, toks [B, chunk], n_emit [B], tok, pos, active)``.

    ``tok``/``pos`` are each row's last emitted token and its position;
    ``active [B] bool`` masks the rows that emit (inactive rows ride
    along frozen, rewriting the same K/V position with the same values);
    ``budget [B]`` is each row's remaining quota. A row that emits EOS or
    its budget-th token freezes for the rest of the chunk, so its tokens
    are a clean prefix of ``toks[b]`` of length ``n_emit[b]``. When
    sampling, ``skeys [B]`` are the rows' key roots: the selection fed by
    the token at position ``p`` uses ``keys.fold(skeys[b], p)``, so the
    fused chunk and the server's per-token oracle draw the same tokens.
    The loop stays on the device: no value is read back inside it.

    Over a mesh ``cache`` is this rank's block, and ``tok``, ``pos``,
    ``active``, ``budget`` and ``skeys`` are the global ``[B]`` vectors:
    the rank decodes its rows and the five outputs come back global,
    gathered over ``data`` in one collective a chunk."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    top_k = validate_sampling(cfg, temperature, top_k, top_p)
    sampling = temperature != 0.0
    step = make_forward_step(cfg, mesh)

    @torch.no_grad()
    def chunk_step(params, cache, tok, pos, active, budget, skeys=None):
        if sampling and skeys is None:
            raise ValueError("a sampling decode chunk needs skeys")
        if mesh is not None:
            r0, n = _data_rows(mesh, tok.shape[0])
            tok, pos, active, budget = (x[r0:r0 + n] for x in
                                        (tok, pos, active, budget))
            skeys = skeys[r0:r0 + n] if sampling else None
        emitted = torch.zeros_like(pos)
        toks = []
        for _ in range(chunk):
            logits, cache = step(params, cache, tok[:, None], pos)
            rkeys = keys.fold(skeys, pos) if sampling else None
            nxt = _select_token_rows(logits[:, -1, :], rkeys, temperature,
                                     top_k, top_p).to(tok.dtype)
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
        toks = torch.stack(toks, 1)
        if mesh is None:
            return cache, toks, emitted, tok, pos, active
        # every rank's rows of the five outputs, in one gather
        got = gather_rows(mesh, torch.cat(
            [toks, torch.stack([emitted, tok, pos, active.to(tok.dtype)],
                               1)], 1))
        return (cache, got[:, :chunk], got[:, chunk], got[:, chunk + 1],
                got[:, chunk + 2], got[:, chunk + 3].bool())

    return chunk_step


def make_generate(cfg: TransformerConfig, mesh=None,
                  max_seq: int | None = None, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0):
    """Build ``generate(params, prompt, n_new, rng=None) -> tokens [B,
    n_new]``: prefill plus ``n_new - 1`` decode steps over a cache sized to
    the call's 128-aligned horizon. ``temperature`` 0 is greedy; above 0 it
    samples, truncated by ``top_k``/``top_p``, and ``generate`` then needs
    ``rng``, an integer seed: selection ``i`` (0 after the prefill) draws
    with ``keys.fold(rng, i)``, row ``b`` with ``fold(fold(rng, i), b)``.

    Over a mesh ``params`` are this rank's shards and ``prompt`` the
    global batch, as the reference's global program takes it: the rank
    decodes its ``B/dp`` rows (``dp`` must divide ``B``) and returns the
    global ``[B, n_new]``, gathered over ``data``, on every rank."""
    max_seq = max_seq or cfg.max_seq
    top_k = validate_sampling(cfg, temperature, top_k, top_p)
    sampling = temperature != 0.0
    step = make_forward_step(cfg, mesh)

    @torch.no_grad()
    def generate(params, prompt, n_new: int, rng=None):
        if sampling and rng is None:
            raise ValueError("sampling decode needs an rng key")
        dev = params["embed"].device
        root = keys.as_key(0 if rng is None else rng, dev)

        prompt = torch.as_tensor(prompt, device=dev).long()
        r0, b = _data_rows(mesh, prompt.shape[0])
        prompt = prompt[r0:r0 + b]
        t0 = prompt.shape[1]

        def select(logits, i):
            return _select_token(logits[:, -1, :], keys.fold(root, i),
                                 temperature, top_k, top_p, row0=r0)

        if t0 + n_new > max_seq:
            # a write past the cache end would fail or corrupt the cache
            # while RoPE positions keep advancing, so refuse
            raise ValueError(
                f"prompt ({t0}) + n_new ({n_new}) exceeds max_seq "
                f"({max_seq}); raise max_seq= on make_generate")
        horizon = min(max_seq, -(-(t0 + n_new) // 128) * 128)
        # its b rows are this rank's already: split only the kv heads
        cache = init_cache(cfg, b, horizon, dev, mesh, split_rows=False)
        logits, cache = step(params, cache, prompt, 0)
        tok = select(logits, 0)
        out = [tok]
        for i in range(1, n_new):
            logits, cache = step(params, cache, tok[:, None], t0 + i - 1)
            tok = select(logits, i)
            out.append(tok)
        return gather_rows(mesh, torch.stack(out, 1))

    return generate
