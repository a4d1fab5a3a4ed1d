"""A serving cell: ``DecodeServer.submit`` and ``step`` under a mix's
requests, greedy.

Set-up builds the server over the seed's weights and warms every prefill
bucket the mix's prompts fall into, and the decode chunk, once. Then:

- an open loop (``open_loop``) submits each request when it falls due,
  steps the server whenever it holds work, and opens the window after
  ``preroll_s``; the requests due inside the window count, and each is
  followed to its last token after the window closes, for up to
  ``drain_s``; one that has not finished with exactly its ``max_new``
  tokens by then failed (the server runs without an end-of-sequence
  token, so every request is owed all of them);
- a backlog (``backlog``) queues every request at once; the window opens
  when the first ``step()`` has filled every slot, and closes after
  ``seconds``. The requests that got a token or finished by then count,
  and one that finished with other than ``max_new`` tokens, or with none,
  failed.

After each ``step()`` the harness reads how many tokens each request
holds (the server keeps a request's emitted tokens on the host until its
result is read), so a token reaches the caller at the end of the step
that produced it. Once the window has closed and the peak memory is
read, the server and its weights are freed and the reference reads a
sample of the served requests, drawn from the seed with the longest
among them: for each, one forward over the prompt and the served tokens.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from . import compare, traffic, weights
from .common import TRACE_SECONDS, Tracer, clock, free, span, sync
from .port import port_config
from .spec import Cell, derive_seed


class _Rec:
    __slots__ = ("req", "rid", "submit", "first", "last", "n", "counted",
                 "done", "tokens")

    def __init__(self, req):
        self.req = req
        self.rid = None
        self.submit = self.first = self.last = None
        self.n = 0
        self.counted = False
        self.done = False
        self.tokens = None


def _warm(server, reqs: list, buckets: tuple, chunk: int) -> None:
    """One admission per bucket the traffic uses, and a decode chunk."""
    used = sorted({next(b for b in buckets if len(r.prompt) <= b)
                   for r in reqs})
    # the shortest prompt of each bucket (it pads to the bucket)
    lens = [1 + max([0] + [c for c in buckets if c < b]) for b in used]
    rids = [server.submit([3] * n, chunk + 1) for n in lens]
    while server.pending:
        server.step()
    for rid in rids:
        server.result(rid)


def _whole(rec: _Rec, open_loop: bool) -> bool:
    """Whether ``rec`` got what it was owed: finished with exactly its
    ``max_new`` tokens (a backlog's request still decoding when the window
    closed is owed nothing yet, as long as it holds no more than that)."""
    if rec.done:
        return rec.n == rec.req.max_new and rec.tokens is not None and \
            len(rec.tokens) == rec.req.max_new
    return not open_loop and rec.first is not None and \
        rec.n <= rec.req.max_new


def _sample(recs: list, k: int, seed: int) -> list:
    """``k`` of ``recs`` drawn from the seed, the one with the most served
    tokens always among them."""
    if len(recs) <= k:
        return list(recs)
    longest = max(range(len(recs)), key=lambda i: recs[i].n)
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    rest = [i for i in range(len(recs)) if i != longest]
    pick = rng.choice(len(rest), size=k - 1, replace=False)
    return [recs[longest]] + [recs[rest[i]] for i in sorted(pick)]


def _gaps(cell: Cell, seed: int, served: list, device,
          control: bool) -> dict:
    """The reference's reading of the served tokens: per request the
    widest gap of a served token's logit below the best; with ``control``
    also the gap of the token the fp8 control puts first."""
    from perfbench.reference import Ref, strict_float32

    strict_float32()
    m = cell.model
    params = weights.make_params(m, seed, device)
    ref = Ref(m)
    ctl = Ref(m, quant="fp8") if control else None
    gaps, gaps_ctl = [], []
    with torch.no_grad():
        for prompt, toks in served:
            seq = torch.tensor([prompt + toks[:-1]], device=device)
            at = slice(len(prompt) - 1, None)
            lg = ref.logits(params, seq)[0, at]
            best = lg.max(-1).values
            got = lg.gather(1, torch.tensor(toks, device=device)[:, None])
            gaps.append((best - got[:, 0]).cpu())
            if ctl is not None:
                c = ctl.logits(params, seq)[0, at].argmax(-1)
                gaps_ctl.append((best - lg.gather(1, c[:, None])[:, 0])
                                .cpu())
            del lg
    del params
    free()
    allg = torch.cat(gaps) if gaps else torch.zeros(0)
    stats = compare.gap_stats(allg.numpy())
    out = dict(compare.serve_numbers(stats),
               tokens_checked=int(allg.numel()))
    if control:
        out["program"] = stats
        out["control_fp8"] = compare.gap_stats(torch.cat(gaps_ctl).numpy())
        out["control_numbers"] = compare.serve_numbers(out["control_fp8"])
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    m, mix, sv = cell.model, cell.mix, cell.model.serve
    cfg = port_config(m, max_seq=int(sv["max_seq"]))
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    reqs = traffic.requests(mix, seed, m.vocab, seconds)
    params = weights.make_params(m, seed, device)
    server = DecodeServer(cfg, params, slots=int(sv["slots"]),
                          max_seq=int(sv["max_seq"]),
                          prefill_buckets=tuple(sv["prefill_buckets"]),
                          chunk=int(sv["chunk"]))
    _warm(server, reqs, server.buckets, server.chunk)
    sync(device)

    recs = [_Rec(r) for r in reqs]
    open_loop = mix["kind"] == "open_loop"
    live: dict = {}                 # rid -> _Rec, submitted and not done
    nxt = 0                         # next request to submit
    window = [math.inf, math.inf]   # [start, end] on the clock
    delivered = 0                   # tokens delivered by steps in window
    prefills, decode_pos = [], []   # the window's prompt lengths, and
    #                                 the positions of its decode tokens

    def submit_due(now):
        nonlocal nxt
        while nxt < len(recs) and t_traffic + recs[nxt].req.due <= now:
            rec = recs[nxt]
            with span("submit"):
                rec.rid = server.submit(rec.req.prompt, rec.req.max_new)
            rec.submit = clock()
            rec.counted = open_loop and \
                window[0] <= t_traffic + rec.req.due < window[1]
            live[rec.rid] = rec
            nxt += 1

    def observe(t, in_win):
        """Tokens each live request holds after the step ending at ``t``."""
        nonlocal delivered
        for rid, rec in list(live.items()):
            held = server._requests[rid]
            n = len(held.out)
            if n > rec.n:
                if rec.n == 0:
                    rec.first = t
                    if in_win:
                        prefills.append(len(rec.req.prompt))
                if in_win:
                    delivered += n - rec.n
                    p0 = len(rec.req.prompt)
                    decode_pos.extend(range(p0 + max(rec.n, 1) - 1,
                                            p0 + n - 1))
                rec.n = n
                rec.last = t
            if held.done:
                rec.done = True
                rec.tokens = server.result(rid)
                del live[rid]

    win_state = 0                   # 0 before the window, 1 in, 2 after
    with Tracer(trace, device) as tracer:
        tracer.warm()
        t_traffic = clock()
        if open_loop:
            window = [t_traffic + float(mix["preroll_s"]), 0.0]
            window[1] = window[0] + seconds
        while True:
            now = clock()
            # submit first: a profile's start or stop must not delay what
            # falls due
            submit_due(now)
            if open_loop:
                if win_state == 0 and now >= window[0]:
                    tracer.start()
                    win_state = 1
                if win_state == 1 and now >= window[1]:
                    tracer.stop()
                    win_state = 2
            if open_loop and now >= window[1]:
                waiting = any(r.counted and not r.done for r in recs[:nxt])
                due_left = nxt < len(recs) and \
                    t_traffic + recs[nxt].req.due < window[1]
                if not (waiting or due_left) or \
                        now >= window[1] + float(mix["drain_s"]):
                    break
            if not server.pending:
                if nxt < len(recs):
                    time.sleep(max(0.0, min(
                        0.002, t_traffic + recs[nxt].req.due - clock())))
                    continue
                break
            with span("serve_step"):
                server.step()
            t = clock()
            if open_loop:
                observe(t, window[0] <= t <= window[1])
                continue
            observe(t, win_state == 1)
            if win_state == 0:
                # the backlog's first step filled every slot: the window
                # opens at its end and closes at the end of the first step
                # that ends ``seconds`` later
                tracer.start()
                window[0] = clock()
                win_state = 1
            elif t >= window[0] + seconds:
                window[1] = t
                tracer.stop()
                win_state = 2
                break
        if win_state == 1 and not open_loop:
            # the backlog ran dry before ``seconds``: its window ends
            # with its last step
            window[1] = t
            tracer.stop()
    setup_s = window[0] - t_start
    sync(device)
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if torch.device(device).type == "cuda" else 0

    if open_loop:
        counted = [r for r in recs if r.counted]
    else:
        counted = [r for r in recs if r.done or
                   (r.first is not None and r.first <= window[1])]
    # served tokens of every request that has some: finished ones from
    # their result, the rest as the server holds them
    for rid, rec in live.items():
        rec.tokens = list(server._requests[rid].out)
    with_tokens = [r for r in counted if r.tokens]
    if open_loop:
        with_tokens = [r for r in with_tokens if r.done]
    pick = _sample(with_tokens, int(mix.get("sample", 6)), seed)
    served = [(r.req.prompt, list(r.tokens)) for r in pick]
    del server, params, live
    free()
    numbers = _gaps(cell, seed, served, device, control)

    # every counted request is owed its ``max_new`` tokens: in an open
    # loop by the drain's end, in a backlog by its finish
    bad = [r for r in counted if not _whole(r, open_loop)]
    for r in bad[:8]:
        print(f"perfbench: request {r.req.idx} failed: {r.n} of "
              f"{r.req.max_new} tokens, done {r.done}, "
              f"result {None if r.tokens is None else len(r.tokens)}",
              file=sys.stderr)
    end = clock()
    return {"kind": "serve", "open_loop": open_loop, "setup_s": setup_s,
            "window_s": window[1] - window[0], "delivered": delivered,
            "prefills": prefills, "decode_positions": decode_pos,
            "requests": [{"due": t_traffic + r.req.due, "submit": r.submit,
                          "first": r.first, "last": r.last, "n": r.n,
                          "done": r.done, "whole": _whole(r, open_loop)}
                         for r in counted],
            "end": end,
            "attempted": len(counted), "failed": len(bad),
            "memory_peak_bytes": peak, "numbers": numbers,
            "trace": tracer.summary, "trace_seconds": tracer.seconds,
            "readings": numbers if control else None}
