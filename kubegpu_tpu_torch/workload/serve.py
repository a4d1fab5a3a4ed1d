"""Continuous-batching decode server: slot-based serving, greedy or
sampled, plain or speculative, with a prefix cache.

The counterpart of ``kubegpu_tpu/workload/serve.py``'s `DecodeServer`. A
fixed number of ``slots`` each own one row of a static KV cache:

- **admit**: a free slot prefills the request's prompt padded to a bucket
  length. Padded positions write garbage K/V beyond the true length,
  which is safe: decode overwrites position ``p`` exactly when the token
  at ``p`` is generated, and a query at position ``q`` only attends
  ``kv <= q``, so every attended entry was overwritten by a real write
  first.
- **fused chunk** (the default): one `decode.make_decode_chunk` call
  generates up to ``chunk`` tokens for all slots with EOS and ``max_new``
  decided on the device, and the host reads the chunk back once.
  Continuous batching happens at chunk boundaries.
- **finish**: on EOS or ``max_new`` the slot returns to the free list and
  the next queued request is admitted.

``KGTPU_FUSED_SERVE=0`` (the switch the reference reads) runs the
per-token host loop instead: one forward step and one readback per token
(per round when speculative), kept as the differential oracle of the
fused path.

Sampling keys are position-keyed per request (`keys`): the selection at
absolute position ``p`` of request ``rid`` uses ``fold(fold(rng, rid),
p)``, so a request's sampled stream depends on nothing but its lineage:
not on its slot, the batch it shares, when it was admitted, the chunk
size, or which data plane emitted it.

With ``draft_params``/``draft_cfg`` the server decodes speculatively:
each round proposes ``lookahead`` draft tokens a slot, verifies every
slot in one target forward and emits each slot's accepted prefix plus one
token, greedy-exact and distribution-exact under sampling
(`speculative.accept_resample` over the slots). On the fused path
``spec_rounds`` rounds (propose, verify, accept, commit and freezing) run
as one Python loop of tensor operations with one readback.

``prefix_cache_size > 0`` keeps the K/V of served prompts and of their
bucket-aligned prefixes (LRU, that many entries); a request whose prompt
extends a stored one copies the stored rows in and prefills only the
remainder. A stored prefix is a copy of the admission prefill's own
one-row cache, never a view of the big cache, which is written in place.

Over a mesh (``mesh=``, reference ``serve.py:125-300``) the slots split
over ``data``: rank ``d`` owns slots ``[d·S/dp, (d+1)·S/dp)`` and its
cache block holds their rows, its kv heads of them (`decode.cache_pspecs`).
Every rank runs the same host program on the same submissions. A decode
dispatch runs each rank's rows and gathers them over ``data`` before the
host reads anything back, so the queue, slots and positions stay equal on
every rank and every rank enters the same collectives in the same order.
Admission prefills one request with batch 1 on every rank (tensor
parallel within its ``model`` group), so the first token is the same
everywhere; only the slot's owner writes its K/V rows.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.workload import keys, spmd
from kubegpu_tpu_torch.workload.decode import (_pick_rows,
                                               _select_token_rows,
                                               gather_rows, init_cache,
                                               make_decode_chunk,
                                               make_forward_step,
                                               truncated_probs,
                                               validate_sampling)
from kubegpu_tpu_torch.workload.model import TransformerConfig
from kubegpu_tpu_torch.workload.speculative import accept_resample


@dataclass
class _Request:
    rid: int
    prompt: list
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0


def _bucket_for(n: int, buckets: tuple) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket "
                     f"{buckets[-1]}")


class DecodeServer:
    """Slot-based continuous-batching decode engine.

    ``submit()`` enqueues a request; ``run()`` (or repeated ``step()``)
    drives admission and decoding until done. The device is the one the
    parameters live on. Greedy by default; ``temperature > 0`` samples
    (truncated by ``top_k``/``top_p``) from the integer seed ``rng``.
    ``prefix_hits``/``prefix_misses`` count prefix reuse;
    ``spec_accepted``/``spec_proposed`` the drafts' acceptance.

    Over a ``mesh`` (a `spmd.make_mesh` mesh; ``dp`` must divide
    ``slots``) ``params`` and ``draft_params`` are this rank's shards
    (`spmd.shard_params`, the draft with its own config)."""

    def __init__(self, cfg: TransformerConfig, params, slots: int = 4,
                 max_seq: int | None = None, mesh=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: int | None = None,
                 prefill_buckets: tuple = (32, 128, 512), rng: int = 0,
                 draft_params=None, draft_cfg: TransformerConfig | None = None,
                 lookahead: int = 4, prefix_cache_size: int = 0,
                 chunk: int = 16, spec_rounds: int = 4):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if spec_rounds < 1:
            raise ValueError(f"spec_rounds must be >= 1, got {spec_rounds}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg go together")
        if prefix_cache_size < 0:
            raise ValueError(
                f"prefix_cache_size must be >= 0, got {prefix_cache_size}")
        if mesh is not None:
            spmd.check_mesh(mesh)
        self.mesh = mesh
        dp = spmd.axis_size(mesh, spmd.AXIS_DATA)
        if slots % dp:
            raise ValueError(f"slots {slots} not divisible by dp {dp}")
        # this rank's slots: [row0, row0 + rows)
        self.rows = slots // dp
        self.row0 = spmd.axis_rank(mesh, spmd.AXIS_DATA) * self.rows
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_seq = max_seq or cfg.max_seq
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = validate_sampling(cfg, self.temperature, top_k, top_p)
        self.top_p = float(top_p)
        self.sampling = self.temperature != 0.0
        self.rng = int(rng)
        self.chunk = int(chunk)
        self.fused = os.environ.get("KGTPU_FUSED_SERVE", "1") != "0"
        # max_seq is always the terminal bucket: any prompt that fits the
        # cache must be admissible, just at the coarsest padding
        self.buckets = tuple(sorted(
            {b for b in prefill_buckets if b < self.max_seq}
            | {self.max_seq}))
        self._fstep = make_forward_step(cfg, mesh)
        self._chunk_step = make_decode_chunk(
            cfg, mesh, chunk=self.chunk, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, eos_id=eos_id)
        self.cache = init_cache(cfg, slots, self.max_seq, self.device, mesh)
        self.pos = np.zeros(slots, np.int64)        # next position per slot
        self.tok = np.zeros(slots, np.int64)        # last emitted token
        # per-slot key root fold(rng, rid) of the resident request; zero
        # while idle (greedy never reads them)
        self.slot_key = np.zeros(slots, np.int64)
        self.slot_req: list = [None] * slots        # _Request or None
        self._free = list(range(slots))
        self._queue: list = []
        self._requests: dict = {}
        self._next_rid = 0

        self.prefix_cache_size = int(prefix_cache_size)
        self._prefix_cache: OrderedDict = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0

        self.spec = draft_params is not None
        self.spec_rounds = int(spec_rounds)
        self.spec_accepted = 0   # drafts the target accepted
        self.spec_proposed = 0   # drafts proposed (k per active slot)
        if self.spec:
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError("draft and target must share a vocabulary")
            if lookahead < 1 or lookahead + 2 > min(self.buckets):
                # idle slots ride along writing garbage K/V at positions
                # 0..k; the admit prefill overwrites [0, bucket), so the
                # smallest bucket bounds the lookahead (a tensor write
                # does not clamp, so nothing else would catch it)
                raise ValueError(
                    f"lookahead must be in [1, {min(self.buckets) - 2}] "
                    f"(smallest prefill bucket {min(self.buckets)})")
            self.k = lookahead
            self.draft_cfg = draft_cfg
            self.draft_params = draft_params
            self._dstep = make_forward_step(draft_cfg, mesh)
            self.dcache = init_cache(draft_cfg, slots, self.max_seq,
                                     self.device, mesh)
            self.prev = np.zeros(slots, np.int64)   # token at pos - 1

    # -- public API ----------------------------------------------------------

    def submit(self, prompt, max_new: int) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        # a cache write past max_seq would fail (tensor writes do not
        # clamp), so refuse up front; speculative verify writes k + 1
        # positions past the last emitted token before truncation
        headroom = (self.k + 1) if self.spec else 0
        if len(prompt) + max_new + headroom > self.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new}"
                + (f" + lookahead headroom {headroom}" if headroom else "")
                + f" exceeds max_seq {self.max_seq}")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, list(prompt), max_new,
                       t_submit=time.perf_counter())
        self._requests[rid] = req
        self._queue.append(req)
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        return rid

    def result(self, rid: int) -> list | None:
        """Tokens of a finished request (None while in flight). Reading a
        finished result EVICTS it; re-reading a consumed rid raises."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(
                f"unknown request id {rid} (never submitted, or its "
                "result was already read)")
        if not req.done:
            return None
        del self._requests[rid]
        return list(req.out)

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self.slot_req)

    @property
    def spec_acceptance(self) -> float:
        """Live draft-acceptance rate (accepted / proposed)."""
        return self.spec_accepted / max(1, self.spec_proposed)

    @torch.no_grad()
    def step(self) -> int:
        """Admit what fits, then decode for every active slot: one fused
        chunk (or ``spec_rounds`` speculative rounds), or a single token
        (one round) on the oracle path (``KGTPU_FUSED_SERVE=0``). Returns
        the number of slots stepped."""
        while self._free and self._queue:
            self._admit(self._free.pop(0), self._queue.pop(0))
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        active = [s for s in range(self.slots)
                  if self.slot_req[s] is not None]
        metrics.SERVE_SLOT_UTILIZATION.set(len(active) / self.slots)
        if not active:
            return 0
        if self.spec:
            return self._spec_fused_step(active) if self.fused \
                else self._spec_step(active)
        if self.fused:
            return self._fused_step(active)
        t0 = time.perf_counter()
        # one upload per step: tok, pos and the keys ride one [3, S]
        # transfer
        up = self._local(self._upload(self.tok, self.pos, self.slot_key))
        logits, self.cache = self._fstep(self.params, self.cache,
                                         up[0][:, None], up[1])
        rkeys = keys.fold(up[2], up[1]) if self.sampling else None
        nxt = _select_token_rows(logits[:, -1, :], rkeys, self.temperature,
                                 self.top_k, self.top_p)
        # host-sync: allowed -- one batched [S] readback per step (every
        # rank's rows): the token is the product here
        nxt = gather_rows(self.mesh, nxt).cpu().numpy()
        itl_ms = (time.perf_counter() - t0) * 1e3
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.tok[s] = tok
            self.pos[s] += 1
            metrics.SERVE_ITL_MS.observe(itl_ms)
            if (self.eos_id is not None and tok == self.eos_id) or \
                    len(req.out) >= req.max_new:
                self._finish(s)
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until every submitted request finishes."""
        for _ in range(max_steps):
            if not self.pending:
                return
            self.step()
        raise RuntimeError(f"not drained after {max_steps} steps")

    # -- internals -----------------------------------------------------------

    def _upload(self, *rows):
        """Host int64 vectors as one ``[len(rows), S]`` device tensor."""
        return torch.from_numpy(np.stack(rows)).to(self.device)

    def _local(self, x):
        """This rank's slots of ``x [..., S]`` (all of them without a
        mesh)."""
        return x[..., self.row0:self.row0 + self.rows]

    def _budget_mask(self, active: list):
        """Per-slot remaining ``max_new`` quota and active mask (idle
        slots: zero budget, masked off)."""
        budget = np.zeros(self.slots, np.int64)
        amask = np.zeros(self.slots, bool)
        for s in active:
            budget[s] = self.slot_req[s].max_new - len(self.slot_req[s].out)
            amask[s] = True
        return budget, amask

    def _fused_step(self, active: list) -> int:
        """One fused decode chunk for the whole batch, one batched
        readback at the chunk boundary."""
        t0 = time.perf_counter()
        budget, amask = self._budget_mask(active)
        up = self._upload(self.tok, self.pos, budget, self.slot_key)
        amask_t = torch.from_numpy(amask).to(self.device)
        self.cache, toks, n_emit, tok_n, pos_n, _ = self._chunk_step(
            self.params, self.cache, up[0], up[1], amask_t, up[2], up[3])
        # host-sync: allowed -- one readback per chunk: emitted tokens,
        # counts and carry state
        got = torch.cat([toks, n_emit[:, None], tok_n[:, None],
                         pos_n[:, None]], dim=1).cpu().numpy()
        toks, n_emit = got[:, :self.chunk], got[:, self.chunk]
        tok_n, pos_n = got[:, self.chunk + 1], got[:, self.chunk + 2]
        wall_ms = (time.perf_counter() - t0) * 1e3
        for s in active:
            req = self.slot_req[s]
            new = [int(x) for x in toks[s, :int(n_emit[s])]]
            req.out.extend(new)
            self.tok[s] = int(tok_n[s])
            self.pos[s] = int(pos_n[s])
            if new:
                metrics.SERVE_ITL_MS.observe(wall_ms / len(new))
            if (self.eos_id is not None and new
                    and new[-1] == self.eos_id) or \
                    len(req.out) >= req.max_new:
                self._finish(s)
        return len(active)

    # -- speculative rounds: device-side pieces -------------------------------

    def _pick_rows(self, logits, rkeys):
        """Next token a slot and, when sampling, its truncated row."""
        return _pick_rows(logits, rkeys, self.temperature, self.top_k,
                          self.top_p)

    def _spec_propose(self, prev, tok, pos, skeys):
        """``k`` draft tokens a slot (and their ``[S, k, V]`` rows when
        sampling). The first step reprocesses ``[prev, tok]`` at ``pos -
        1``, which fills the K/V hole a fully accepted round leaves (the
        catch-up of `speculative.make_speculative_generate`); draft step
        ``i`` draws with ``fold(round key, i)``, the round key being
        ``fold(skeys, pos)``."""
        rkeys = keys.fold(skeys, pos)
        logits, self.dcache = self._dstep(
            self.draft_params, self.dcache, torch.stack([prev, tok], 1),
            (pos - 1).clamp_min(0))
        t, q = self._pick_rows(logits[:, -1, :], keys.fold(rkeys, 0))
        drafts, rows = [t], [q]
        for i in range(1, self.k):
            logits, self.dcache = self._dstep(self.draft_params, self.dcache,
                                              t[:, None], pos + i)
            t, q = self._pick_rows(logits[:, -1, :], keys.fold(rkeys, i))
            drafts.append(t)
            rows.append(q)
        return (torch.stack(drafts, 1),
                torch.stack(rows, 1) if self.sampling else None)

    def _spec_verify(self, chunk, pos, skeys, q_rows):
        """One target forward over every slot's ``[last, d1..dk]`` chunk
        and each slot's ``(n_acc, extra)``. The accept/resample key is
        ``fold(round key, k)``, apart from the draft steps' ``0..k-1``."""
        logits, self.cache = self._fstep(self.params, self.cache, chunk,
                                         pos)
        if self.sampling:
            p_rows = truncated_probs(logits, self.temperature, self.top_k,
                                     self.top_p)
            akeys = keys.fold(keys.fold(skeys, pos), self.k)
            return accept_resample(p_rows, q_rows, chunk[:, 1:], akeys)
        greedy = logits.argmax(-1)                          # [S, k+1]
        n_acc = (chunk[:, 1:] == greedy[:, :-1]).long().cumprod(1).sum(1)
        return n_acc, greedy.gather(1, n_acc[:, None])[:, 0]

    def _spec_commit(self, chunk, n_acc, extra, prev, tok, pos, active,
                     budget):
        """A round's emission and freezing on the device: the emitted
        tokens are ``drafts[:n_acc] + [extra]``, cut at the first EOS or
        the budget, as the oracle's host commit. Returns the masked
        candidates ``[S, k+1]`` (a valid prefix of length ``n_emit``),
        ``n_emit`` and the carry state: continuing rows advance ``n_acc +
        1`` positions with the catch-up anchor; finished or frozen rows
        hold."""
        s, k = chunk.shape[0], self.k
        idx = torch.arange(k + 1, device=chunk.device)[None, :]
        drafts_pad = torch.cat([chunk[:, 1:], torch.zeros_like(chunk[:, :1])],
                               1)
        cand = torch.where(idx == n_acc[:, None], extra[:, None], drafts_pad)
        emit = (idx <= n_acc[:, None]) & (idx < budget[:, None]) \
            & active[:, None]
        if self.eos_id is not None:
            is_eos = (cand == self.eos_id).long()
            emit &= torch.cumsum(is_eos, 1) - is_eos == 0   # EOS is
            hit_eos = (emit & (is_eos == 1)).any(1)         # emitted, THEN
        else:                                               # the row stops
            hit_eos = torch.zeros(s, dtype=torch.bool, device=chunk.device)
        n_emit = emit.long().sum(1)
        cont = active & ~(hit_eos | (n_emit >= budget))
        anchor = chunk.gather(1, n_acc[:, None])[:, 0]
        return (torch.where(emit, cand, 0), n_emit,
                torch.where(cont, anchor, prev),
                torch.where(cont, extra, tok),
                torch.where(cont, pos + n_acc + 1, pos), cont,
                budget - n_emit)

    def _spec_rounds(self, prev, tok, pos, active, budget, skeys):
        """``spec_rounds`` speculative rounds with no readback inside: each
        round is propose -> verify -> accept/resample -> commit. A round
        writes its ``k + 1`` candidates at the slot's running offset into
        one output buffer and advances the offset by its ``n_emit``, so
        later rounds overwrite the invalid tail and the valid tokens stay
        a clean prefix. Finished slots freeze and ride along masked."""
        k, rounds = self.k, self.spec_rounds
        s = tok.shape[0]
        rows = torch.arange(s, device=tok.device)[:, None]
        cols = torch.arange(k + 1, device=tok.device)[None, :]
        buf = torch.zeros((s, rounds * (k + 1)), dtype=torch.long,
                          device=tok.device)
        off = torch.zeros_like(tok)
        acc_n = torch.zeros_like(tok)
        acc_d = torch.zeros_like(tok)
        for _ in range(rounds):
            was_active = active
            drafts, q_rows = self._spec_propose(prev, tok, pos, skeys)
            chunk = torch.cat([tok[:, None], drafts], 1)
            n_acc, extra = self._spec_verify(chunk, pos, skeys, q_rows)
            cand, n_emit, prev, tok, pos, active, budget = \
                self._spec_commit(chunk, n_acc, extra, prev, tok, pos,
                                  active, budget)
            buf[rows, off[:, None] + cols] = cand
            off = off + n_emit
            acc_n = acc_n + torch.where(was_active, n_acc, 0)
            acc_d = acc_d + was_active.long() * k
        return buf, off, prev, tok, pos, active, acc_n, acc_d

    # -- speculative rounds: host side ----------------------------------------

    def _spec_fused_step(self, active: list) -> int:
        """``spec_rounds`` speculative rounds for the whole batch, one
        batched readback of every slot's emissions, carry state and
        acceptance tallies."""
        t0 = time.perf_counter()
        budget, amask = self._budget_mask(active)
        up = self._local(self._upload(self.prev, self.tok, self.pos, budget,
                                      self.slot_key))
        amask_t = self._local(torch.from_numpy(amask).to(self.device))
        buf, n_tot, *state = self._spec_rounds(up[0], up[1], up[2], amask_t,
                                               up[3], up[4])
        # host-sync: allowed -- one readback per dispatch of rounds, of
        # every rank's rows, so the tallies and commits agree everywhere
        got = gather_rows(self.mesh, torch.cat(
            [buf] + [x.long()[:, None] for x in [n_tot, *state]],
            1)).cpu().numpy()
        w = buf.shape[1]
        buf, (n_tot, prev_n, tok_n, pos_n, act_n, acc_n, acc_d) = \
            got[:, :w], got[:, w:].T
        wall_ms = (time.perf_counter() - t0) * 1e3
        self.spec_accepted += int(acc_n.sum())
        self.spec_proposed += int(acc_d.sum())
        for s in active:
            req = self.slot_req[s]
            new = [int(x) for x in buf[s, :int(n_tot[s])]]
            req.out.extend(new)
            if new:
                metrics.SERVE_ITL_MS.observe(wall_ms / len(new))
            if not act_n[s]:
                self._finish(s)
            else:
                self.prev[s] = int(prev_n[s])
                self.tok[s] = int(tok_n[s])
                self.pos[s] = int(pos_n[s])
        return len(active)

    def _spec_step(self, active: list) -> int:
        """One speculative round for the whole batch on the oracle path:
        ``k`` proposals a slot, one batched verify, per-slot acceptance,
        the commit on the host."""
        t0 = time.perf_counter()
        up = self._local(self._upload(self.prev, self.tok, self.pos,
                                      self.slot_key))
        drafts, q_rows = self._spec_propose(up[0], up[1], up[2], up[3])
        chunk = torch.cat([up[1][:, None], drafts], 1)
        n_acc, extra = self._spec_verify(chunk, up[2], up[3], q_rows)
        # host-sync: allowed -- one batched readback per round, of every
        # rank's rows
        got = gather_rows(self.mesh, torch.cat(
            [n_acc[:, None], extra[:, None], chunk], 1)).cpu().numpy()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for s in active:
            req = self.slot_req[s]
            n, chunk_s = int(got[s, 0]), got[s, 2:]
            self.spec_accepted += n
            self.spec_proposed += self.k
            # the round's tokens: n accepted drafts + correction/bonus
            emitted = []
            for t in [int(x) for x in chunk_s[1:n + 1]] + [int(got[s, 1])]:
                emitted.append(t)
                if (self.eos_id is not None and t == self.eos_id) or \
                        len(req.out) + len(emitted) >= req.max_new:
                    break
            req.out.extend(emitted)
            metrics.SERVE_ITL_MS.observe(wall_ms / len(emitted))
            if (self.eos_id is not None and self.eos_id in emitted) or \
                    len(req.out) >= req.max_new:
                self._finish(s)
            else:
                # a full round: advance exactly n + 1 positions
                self.pos[s] += n + 1
                self.prev[s] = int(chunk_s[n])
                self.tok[s] = emitted[-1]
        return len(active)

    # -- admission and the prefix cache ---------------------------------------

    def _prefix_lookup(self, prompt: list):
        """The longest stored entry that is a proper prefix of ``prompt``
        (LRU-refreshed), or None."""
        best = None
        for key in self._prefix_cache:
            if len(key) < len(prompt) and \
                    (best is None or len(key) > len(best)) and \
                    tuple(prompt[:len(key)]) == key:
                best = key
        if best is None:
            return None
        self._prefix_cache.move_to_end(best)
        return best, self._prefix_cache[best]

    def _prefix_store(self, prompt: list, row: list) -> None:
        """Store the full prompt's K/V and its bucket-aligned prefixes: a
        shared system prompt with different user suffixes only ever
        matches an intermediate prefix. Each entry is a copy of the first
        ``b`` positions of ``row``, the admission prefill's one-row cache,
        which every rank holds (over a mesh the slot's rows live on one
        ``data`` rank only), so a hit can splice into any slot."""
        entries = [(tuple(prompt[:b]), b)
                   for b in self.buckets if b < len(prompt)]
        entries.append((tuple(prompt),
                        _bucket_for(len(prompt), self.buckets)))
        for key, b in entries:
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            self._prefix_cache[key] = [
                {kv: layer[kv][:, :b].clone() for kv in ("k", "v")}
                for layer in row]
        while len(self._prefix_cache) > self.prefix_cache_size:
            self._prefix_cache.popitem(last=False)

    def _first_token(self, logits, at: int, pos: int, req_key: int):
        """The request's first token from ``logits [1, T, V]`` at row
        ``at``, keyed at the prompt's last position ``pos`` like every
        later selection."""
        rkey = keys.fold(keys.as_key([req_key], self.device), pos)
        return _select_token_rows(logits[:, at, :], rkey, self.temperature,
                                  self.top_k, self.top_p)[0]

    def _row_cache(self, cfg: TransformerConfig, length: int) -> list:
        """A one-row cache for an admission prefill: every rank computes
        it, over a mesh with its own kv heads."""
        return init_cache(cfg, 1, length, self.device, self.mesh,
                          split_rows=False)

    def _install(self, big: list, row: list, slot: int, length: int) -> None:
        """Copy the first ``length`` positions of the one-row cache ``row``
        into ``slot``'s row of ``big``, on the rank that owns the slot."""
        if not self.row0 <= slot < self.row0 + self.rows:
            return
        for b, r in zip(big, row):
            for kv in ("k", "v"):
                b[kv][slot - self.row0, :length] = r[kv][0, :length]

    def _admit(self, slot: int, req: _Request) -> None:
        """Prefill one request into ``slot``: the bucket-padded prompt
        through a fresh one-row cache copied into the slot's rows, or, on
        a prefix hit, the stored prefix copied in and the remainder run at
        position ``plen``."""
        n = len(req.prompt)
        bucket = _bucket_for(n, self.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt
        hit = self._prefix_lookup(req.prompt) if self.prefix_cache_size \
            else None
        if hit is not None:
            pkey, stored = hit
            plen = len(pkey)
            rem = req.prompt[plen:]
            rb = _bucket_for(len(rem), self.buckets)
            if plen + rb > self.max_seq:
                # the padded remainder would write past the cache end:
                # full prefill instead
                hit = None
        # the request's key root: every selection of this request, on
        # every path, folds its position into this key
        req_key = keys.fold_int(self.rng, req.rid)
        if hit is not None:
            row = self._row_cache(self.cfg, self.max_seq)
            for rw, st in zip(row, stored):
                for kv in ("k", "v"):
                    rw[kv][:, :st[kv].shape[1]] = st[kv]
            rem_padded = np.zeros((1, rb), np.int64)
            rem_padded[0, :len(rem)] = rem
            logits, row = self._fstep(self.params, row,
                                      torch.from_numpy(rem_padded), plen)
            self._install(self.cache, row, slot, self.max_seq)
            first_t = self._first_token(logits, len(rem) - 1, n - 1, req_key)
            self.prefix_hits += 1
        else:
            row = self._row_cache(self.cfg, bucket)
            logits, row = self._fstep(self.params, row,
                                      torch.from_numpy(padded), 0)
            self._install(self.cache, row, slot, bucket)
            first_t = self._first_token(logits, n - 1, n - 1, req_key)
            if self.prefix_cache_size:
                self.prefix_misses += 1
        if self.prefix_cache_size:
            self._prefix_store(req.prompt, row)
        if self.spec:
            small = self._row_cache(self.draft_cfg, bucket)
            _, small = self._dstep(self.draft_params, small,
                                   torch.from_numpy(padded), 0)
            self._install(self.dcache, small, slot, bucket)
            self.prev[slot] = req.prompt[-1]        # draft catch-up anchor
        # host-sync: allowed -- one scalar readback per admitted request:
        # the host needs the first token for EOS and the output (from
        # logits gathered over model, the same on every rank)
        first = int(first_t)
        metrics.SERVE_TTFT_MS.observe(
            (time.perf_counter() - req.t_submit) * 1e3)
        req.out.append(first)
        self.slot_req[slot] = req
        self.tok[slot] = first
        self.pos[slot] = n
        self.slot_key[slot] = req_key
        if (self.eos_id is not None and first == self.eos_id) or \
                len(req.out) >= req.max_new:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.done = True
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self.tok[slot] = 0
        self.slot_key[slot] = 0
        if self.spec:
            self.prev[slot] = 0
        self._free.append(slot)
