"""Speculative decoding: the draft proposes, the target verifies, exactly.

The counterpart of ``kubegpu_tpu/workload/speculative.py``. A small draft
model proposes ``k`` tokens with cheap sequential steps, the target scores
all of them in one forward pass over the ``k + 1``-token chunk, and the
longest accepted prefix is emitted plus one more token:

- greedy (``temperature == 0``): accept while the draft token equals the
  target's argmax; the output is the target's greedy sequence;
- sampled (``temperature > 0``): the rejection-resampling rule
  (`accept_resample`): accept draft ``d`` with probability
  ``min(1, p(d)/q(d))``, resample the first rejection from
  ``normalize(max(p - q, 0))``, so every emitted token is distributed as
  sampling the target. With ``top_k``/``top_p`` both distributions are
  truncated and renormalised (`decode.truncated_probs`) first, and the
  emitted tokens follow the truncated target, what `make_generate`
  samples.

Rejected positions leave stale K/V in both caches, which is safe: position
``p`` is rewritten exactly when the real token at ``p`` is processed, and
queries only attend positions that have been rewritten. Randomness comes
from the port's counter-based keys (`keys`), not threefry.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.workload import keys
from kubegpu_tpu_torch.workload.decode import (_pick_rows, _select_token,
                                               init_cache,
                                               make_forward_step,
                                               truncated_probs,
                                               validate_sampling)
from kubegpu_tpu_torch.workload.model import TransformerConfig


def accept_resample(p_rows, q_rows, drafts, key):
    """The rejection-resampling acceptance rule of speculative sampling.

    ``p_rows [..., k+1, V]``: the target's distribution after each chunk
    position; ``q_rows [..., k, V]``: the draft distribution each proposal
    was sampled from; ``drafts [..., k]``; ``key [...]``: one key per row
    (the leading dimensions are optional and batch independent rounds).
    Draft ``i`` is accepted with probability ``min(1, p_i(d_i) /
    q_i(d_i))``, drawn as ``u_i * q < p`` with ``u = uniform(fold(key,
    0))``; at the first rejection the extra token is drawn from
    ``normalize(max(p_i - q_i, 0))``, after ``k`` acceptances from
    ``p_k``, by Gumbel-max with ``fold(key, 1)``. Returns ``(n_acc,
    extra)``: the round emits ``drafts[:n_acc] + [extra]``."""
    single = drafts.dim() == 1
    if single:
        p_rows, q_rows, drafts = p_rows[None], q_rows[None], drafts[None]
    key = keys.as_key(key, drafts.device).reshape(-1)
    k, v = drafts.shape[1], p_rows.shape[-1]
    u = keys.uniform(keys.fold(key, 0), k)                   # [S, k]
    p_d = p_rows[:, :k].gather(-1, drafts[..., None])[..., 0]
    q_d = q_rows.gather(-1, drafts[..., None])[..., 0]
    n_acc = (u * q_d < p_d).long().cumprod(1).sum(1)        # first reject
    # the residual at the rejection; plain p for the bonus position
    q_pad = torch.cat([q_rows, torch.zeros_like(p_rows[:, :1])], 1)
    at = n_acc[:, None, None].expand(-1, 1, v)
    p_n, q_n = p_rows.gather(1, at)[:, 0], q_pad.gather(1, at)[:, 0]
    resid = (p_n - q_n).clamp_min(0.0)
    mass = resid.sum(-1, keepdim=True)
    # p == q exactly cannot reject (u < 1), so mass > 0 on the reject path;
    # guard the float edge by falling back to p
    resid = torch.where(mass > 1e-9, resid / mass.clamp_min(1e-9), p_n)
    extra = (torch.log(resid.clamp_min(1e-30))
             + keys.gumbel(keys.fold(key, 1), v)).argmax(-1)
    if single:
        return n_acc[0], extra[0]
    return n_acc, extra


def make_speculative_generate(target_cfg: TransformerConfig,
                              draft_cfg: TransformerConfig,
                              k: int = 4, mesh=None,
                              max_seq: int | None = None,
                              temperature: float = 0.0,
                              top_k: int = 0, top_p: float = 1.0):
    """Build ``generate(target_params, draft_params, prompt, n_new,
    rng=None) -> (tokens list, target_calls)`` for one prompt.

    ``temperature == 0`` is greedy speculative decoding: exactly the
    target's greedy sequence. Above 0 it is speculative sampling with
    `accept_resample` on the truncated-and-renormalised target and draft
    rows, and ``generate`` needs ``rng``, an integer seed: the target's
    first token draws with ``fold(rng, 0)``, round ``r`` (from 1) has the
    key ``fold(rng, 1 + r)``, its draft step ``i`` draws with ``fold(round,
    i)`` and its acceptance with ``fold(round, 10000)``, as the
    reference's lineage. ``k`` is the draft lookahead a round; both models
    share the vocab. The draft catches up at ``pos - 1`` each round: after
    a fully accepted round it never processed its own last proposal.

    Over a mesh both parameter trees are this rank's shards: the one
    stream runs tensor parallel within each ``model`` group, and every
    ``data`` group computes the same stream (batch 1 does not split)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError("draft and target must share a vocabulary")
    top_k = validate_sampling(target_cfg, temperature, top_k, top_p)
    sampling = temperature != 0.0
    max_seq = max_seq or min(target_cfg.max_seq, draft_cfg.max_seq)
    t_step = make_forward_step(target_cfg, mesh)
    d_step = make_forward_step(draft_cfg, mesh)

    def pick(logits, key):
        """Next token ``[1]`` and, when sampling, its truncated row."""
        return _pick_rows(logits, key, temperature, top_k, top_p)

    def draft_propose(params, cache, prev, token, pos, key):
        """``k`` proposals from ``token`` at ``pos`` (and, when sampling,
        their ``[k, V]`` rows). The first step processes ``[prev, token]``
        at ``pos - 1``, which fills the K/V hole a fully accepted round
        leaves and rewrites the same values otherwise."""
        logits, cache = d_step(params, cache, torch.stack([prev, token], 1),
                               pos - 1)
        tok, q = pick(logits[:, -1, :], keys.fold(key, 0))
        drafts, rows = [tok], [q]
        for i in range(1, k):
            logits, cache = d_step(params, cache, tok[:, None], pos + i)
            tok, q = pick(logits[:, -1, :], keys.fold(key, i))
            drafts.append(tok)
            rows.append(q)
        q_rows = torch.cat(rows) if sampling else None
        return cache, torch.cat(drafts), q_rows

    def verify(params, cache, chunk, pos):
        """One target forward over ``chunk [1, k+1]`` at ``pos``: the
        target's ``[k+1, V]`` rows when sampling; else its greedy token
        after each position and the agreeing prefix length."""
        logits, cache = t_step(params, cache, chunk, pos)
        if sampling:
            return cache, truncated_probs(logits[0], temperature, top_k,
                                          top_p), None
        greedy = logits[0].argmax(-1)                     # [k+1]
        n_acc = (chunk[0, 1:] == greedy[:-1]).long().cumprod(0).sum()
        return cache, greedy, n_acc

    @torch.no_grad()
    def generate(target_params, draft_params, prompt, n_new: int,
                 rng=None):
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if sampling and rng is None:
            raise ValueError("sampled speculative decode needs an rng key")
        dev = target_params["embed"].device
        root = keys.as_key(0 if rng is None else rng, dev)
        prompt = torch.as_tensor(prompt, device=dev).long().reshape(1, -1)
        t0 = prompt.shape[1]
        if t0 + n_new + k + 1 > max_seq:
            raise ValueError(
                f"prompt ({t0}) + n_new ({n_new}) + lookahead ({k + 1}) "
                f"exceeds max_seq ({max_seq})")
        # verify writes up to k + 1 positions past the last emitted token
        horizon = min(max_seq, -(-(t0 + n_new + k + 1) // 128) * 128)
        t_cache = init_cache(target_cfg, 1, horizon, dev, mesh,
                             split_rows=False)
        d_cache = init_cache(draft_cfg, 1, horizon, dev, mesh,
                             split_rows=False)
        logits, t_cache = t_step(target_params, t_cache, prompt, 0)
        first = _select_token(logits[:, -1, :], keys.fold(root, 0),
                              temperature, top_k, top_p)
        _, d_cache = d_step(draft_params, d_cache, prompt, 0)

        out = [int(first[0])]
        pos = t0            # both caches hold [0, t0); `first` unprocessed
        target_calls = 1
        last = first        # [1] last accepted, not yet processed token
        prev = prompt[:, -1]  # the token at pos - 1 (draft catch-up)
        rounds = 0
        while len(out) < n_new:
            rounds += 1
            rkey = keys.fold(root, 1 + rounds)
            d_cache, drafts, q_rows = draft_propose(
                draft_params, d_cache, prev, last, pos, rkey)
            chunk = torch.cat([last, drafts]).reshape(1, k + 1)
            t_cache, tout, n_acc = verify(target_params, t_cache, chunk,
                                          pos)
            target_calls += 1
            if sampling:
                n_acc, extra = accept_resample(tout, q_rows, drafts,
                                               keys.fold(rkey, 10_000))
            else:
                extra = tout[n_acc]
            # one readback a round: the acceptance length bounds the loop
            got = torch.cat([n_acc[None], extra[None], drafts]).tolist()
            n, new = got[0], got[2:2 + got[0]] + [got[1]]
            out.extend(new)
            pos += n + 1
            last = torch.tensor([out[-1]], device=dev)
            # the next anchor, the token at the new pos - 1, is chunk[n]
            prev = chunk[:, n]
        return out[:n_new], target_calls

    return generate
