"""The one general traffic generator: a mix file's parameters in, requests
or a token corpus out.

Every seed gets the same multiset of sizes and gaps, in another order:
lengths and inter-arrival gaps are the quantiles ``F^-1((i + 0.5) / n)``
of the mix's distributions, permuted by the run's seed, and only the
order and the token ids depend on the seed. So two seeds do the same
work, and runs differ by where the work falls, not by how much there is.
An open loop draws its pre-roll, its window and its drain each as such a
multiset of its own, so the requests due inside the window are the same
sizes for every seed, and not the share of a longer draw that happens
to fall there.

Mix kinds (``"kind"``):

- ``train``: a token corpus of packed documents (lengths from
  ``doc_len``, an ``eos_id`` after each) for the loader, and the step's
  ``batch``, ``seq`` and ``lr``;
- ``open_loop``: Poisson arrivals at ``rate_per_s`` from time 0, the
  window opening after ``preroll_s``; prompts and outputs from
  ``prompt`` and ``output``. Each of the pre-roll, the window and the
  drain holds ``ceil(rate_per_s * its seconds)`` arrivals, their
  exponential gaps scaled to span it;
- ``backlog``: ``requests`` requests queued at time 0.

A distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` (clamped) or ``{"dist": "uniform", "min", "max"}`` (whole
numbers, both ends included).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from .spec import derive_seed

_NORMAL = NormalDist()


def quantile_sizes(dist: dict, n: int) -> np.ndarray:
    """``n`` whole sizes at the mid-quantiles of ``dist``, ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(x)) for x in u])
        vals = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif kind == "uniform":
        vals = lo + u * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` exponential inter-arrival gaps of mean ``1/rate`` (s), at the
    mid-quantiles, ascending."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


@dataclass
class Request:
    idx: int
    due: float             # seconds after the traffic's start
    prompt: list
    max_new: int


def requests(mix: dict, seed: int, vocab: int, seconds: float) -> list:
    """The requests of a serving mix for a window of ``seconds``, in due
    order. An open loop covers ``preroll_s + seconds + drain_s`` of
    arrivals, so the load stays on while the window's requests drain."""
    rng = np.random.default_rng(derive_seed(seed, "traffic"))
    if mix["kind"] == "open_loop":
        rate = mix["rate_per_s"]
        due, plen, olen = [], [], []
        t0 = 0.0
        for span_s in (mix["preroll_s"], seconds, mix["drain_s"]):
            n = int(math.ceil(rate * span_s))
            if n == 0:
                continue
            gaps = rng.permutation(exp_gaps(rate, n))
            # arrivals from the segment's start, the gaps scaled so that
            # the last one falls inside it
            at = np.cumsum(gaps) - gaps[0]
            due.append(t0 + at * (span_s / gaps.sum()))
            plen.append(rng.permutation(quantile_sizes(mix["prompt"], n)))
            olen.append(rng.permutation(quantile_sizes(mix["output"], n)))
            t0 += span_s
        due, plen, olen = (np.concatenate(x) for x in (due, plen, olen))
    elif mix["kind"] == "backlog":
        n = int(mix["requests"])
        due = np.zeros(n)
        plen = rng.permutation(quantile_sizes(mix["prompt"], n))
        olen = rng.permutation(quantile_sizes(mix["output"], n))
    else:
        raise ValueError(f"not a serving mix: {mix['kind']!r}")
    lo = int(mix.get("first_token_id", 3))
    out = []
    for i in range(len(due)):
        toks = rng.integers(lo, vocab, size=int(plen[i]))
        out.append(Request(i, float(due[i]), toks.tolist(), int(olen[i])))
    return out


def corpus(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """A train mix's token corpus: documents of the mix's lengths in seed
    order, each followed by ``eos_id``, ``shard_tokens`` long (uint32).
    Token ids are Zipf-like over ``[first_token_id, vocab)`` with exponent
    ``zipf_a``, drawn from the seed."""
    rng = np.random.default_rng(derive_seed(seed, "corpus"))
    n_tok = int(mix["shard_tokens"])
    eos = int(mix["eos_id"])
    lo = int(mix.get("first_token_id", 3))
    n_docs_guess = max(16, 4 * n_tok // int(mix["doc_len"]["median"]))
    lens = rng.permutation(quantile_sizes(mix["doc_len"], n_docs_guess))
    # Zipf-like ids: ranks drawn by inverse CDF over a finite support,
    # then a seeded permutation of the id space
    ranks = np.arange(1, vocab - lo + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -float(mix["zipf_a"]))
    cdf /= cdf[-1]
    ids = rng.permutation(np.arange(lo, vocab)).astype(np.uint32)
    body = ids[np.searchsorted(cdf, rng.random(n_tok), side="right")
               .clip(0, vocab - lo - 1)]
    out = body.copy()
    pos = np.cumsum(lens + 1) - 1
    pos = pos[pos < n_tok]
    out[pos] = eos
    return out
