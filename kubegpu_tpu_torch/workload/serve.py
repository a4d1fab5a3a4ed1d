"""Continuous-batching decode server: slot-based greedy serving.

The counterpart of ``kubegpu_tpu/workload/serve.py``'s `DecodeServer`,
greedy and non-speculative. A fixed number of ``slots`` each own one row
of a static KV cache:

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
per-token host loop instead: one forward step and one readback per
token, kept as the differential oracle of the fused path.

Sampling, speculative decoding and the prefix cache come with a later
slice and raise `NotImplementedError`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.workload.decode import (_greedy_only, init_cache,
                                               make_decode_chunk,
                                               make_forward_step,
                                               validate_sampling)
from kubegpu_tpu_torch.workload.model import TransformerConfig


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
    """Slot-based continuous-batching greedy decode engine.

    ``submit()`` enqueues a request; ``run()`` (or repeated ``step()``)
    drives admission and decoding until done. The device is the one the
    parameters live on."""

    def __init__(self, cfg: TransformerConfig, params, slots: int = 4,
                 max_seq: int | None = None, mesh=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: int | None = None,
                 prefill_buckets: tuple = (32, 128, 512),
                 draft_params=None, draft_cfg: TransformerConfig | None = None,
                 prefix_cache_size: int = 0, chunk: int = 16,
                 spec_rounds: int = 4):
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
        validate_sampling(cfg, float(temperature), top_k, top_p)
        _greedy_only(float(temperature))
        if draft_params is not None:
            raise NotImplementedError(
                "speculative serving comes with the sampling and "
                "speculation slice (slice 4)")
        if prefix_cache_size:
            raise NotImplementedError(
                "the prefix cache comes with the sampling and speculation "
                "slice (slice 4)")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_seq = max_seq or cfg.max_seq
        self.eos_id = eos_id
        self.chunk = int(chunk)
        self.fused = os.environ.get("KGTPU_FUSED_SERVE", "1") != "0"
        # max_seq is always the terminal bucket: any prompt that fits the
        # cache must be admissible, just at the coarsest padding
        self.buckets = tuple(sorted(
            {b for b in prefill_buckets if b < self.max_seq}
            | {self.max_seq}))
        self._fstep = make_forward_step(cfg, mesh)
        self._chunk_step = make_decode_chunk(cfg, mesh, chunk=self.chunk,
                                             eos_id=eos_id)
        self.cache = init_cache(cfg, slots, self.max_seq, self.device)
        self.pos = np.zeros(slots, np.int64)        # next position per slot
        self.tok = np.zeros(slots, np.int64)        # last emitted token
        self.slot_req: list = [None] * slots        # _Request or None
        self._free = list(range(slots))
        self._queue: list = []
        self._requests: dict = {}
        self._next_rid = 0

    # -- public API ----------------------------------------------------------

    def submit(self, prompt, max_new: int) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.max_seq:
            # a cache write past max_seq would fail (tensor writes do not
            # clamp), so refuse up front
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds max_seq "
                f"{self.max_seq}")
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

    def step(self) -> int:
        """Admit what fits, then decode for every active slot: one fused
        chunk, or a single token on the per-token oracle path
        (``KGTPU_FUSED_SERVE=0``). Returns the number of slots stepped."""
        while self._free and self._queue:
            self._admit(self._free.pop(0), self._queue.pop(0))
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        active = [s for s in range(self.slots)
                  if self.slot_req[s] is not None]
        metrics.SERVE_SLOT_UTILIZATION.set(len(active) / self.slots)
        if not active:
            return 0
        if self.fused:
            return self._fused_step(active)
        t0 = time.perf_counter()
        # one upload per step: tok and pos ride a single [2, S] transfer
        tp = torch.from_numpy(np.stack([self.tok, self.pos])).to(
            self.device)
        with torch.no_grad():
            logits, self.cache = self._fstep(self.params, self.cache,
                                             tp[0][:, None], tp[1])
            nxt = logits[:, -1, :].argmax(-1)
        # one batched [S] readback per step: the token is the product here
        nxt = nxt.cpu().numpy()
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
        # one upload per chunk: tok/pos/budget ride a single [3, S] transfer
        up = torch.from_numpy(np.stack([self.tok, self.pos, budget])).to(
            self.device)
        amask_t = torch.from_numpy(amask).to(self.device)
        self.cache, toks, n_emit, tok_n, pos_n, _ = self._chunk_step(
            self.params, self.cache, up[0], up[1], amask_t, up[2])
        # one readback per chunk: emitted tokens, counts and carry state
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

    def _admit(self, slot: int, req: _Request) -> None:
        """Bucketed prefill of one request into ``slot``: the prompt runs
        through a fresh one-row cache of the bucket's length, whose K/V is
        then copied into the slot's row of the big cache."""
        n = len(req.prompt)
        bucket = _bucket_for(n, self.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt
        small = init_cache(self.cfg, 1, bucket, self.device)
        logits, small = self._fstep(self.params, small,
                                    torch.from_numpy(padded), 0)
        for big, sm in zip(self.cache, small):
            for k in ("k", "v"):
                big[k][slot, :bucket] = sm[k][0]
        # one scalar readback per admitted request: the host needs the
        # first token for EOS and the output
        first = int(logits[0, n - 1].argmax())
        metrics.SERVE_TTFT_MS.observe(
            (time.perf_counter() - req.t_submit) * 1e3)
        req.out.append(first)
        self.slot_req[slot] = req
        self.tok[slot] = first
        self.pos[slot] = n
        if (self.eos_id is not None and first == self.eos_id) or \
                len(req.out) >= req.max_new:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.done = True
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self.tok[slot] = 0
        self._free.append(slot)
