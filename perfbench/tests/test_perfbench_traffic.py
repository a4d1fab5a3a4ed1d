"""The traffic generator: deterministic per seed, the same work for every
seed, and the stated distributions."""

import math
import statistics

import numpy as np
import pytest

from perfbench.harness import traffic

CHAT = {"kind": "open_loop", "rate_per_s": 8.0, "preroll_s": 5,
        "drain_s": 10,
        "prompt": {"dist": "lognormal", "median": 768, "sigma": 0.8,
                   "min": 32, "max": 3072},
        "output": {"dist": "lognormal", "median": 192, "sigma": 0.7,
                   "min": 16, "max": 1024}}
BACKLOG = {"kind": "backlog", "requests": 300,
           "prompt": {"dist": "uniform", "min": 2048, "max": 3840},
           "output": {"dist": "uniform", "min": 64, "max": 160}}


@pytest.mark.parametrize("mix", [CHAT, BACKLOG], ids=["open", "backlog"])
def test_same_seed_same_requests(mix):
    a = traffic.requests(mix, 2**31 + 5, 32000, 10)
    b = traffic.requests(mix, 2**31 + 5, 32000, 10)
    assert [(r.due, r.prompt, r.max_new) for r in a] == \
        [(r.due, r.prompt, r.max_new) for r in b]


@pytest.mark.parametrize("mix", [CHAT, BACKLOG], ids=["open", "backlog"])
def test_every_seed_same_work(mix):
    a = traffic.requests(mix, 1, 32000, 10)
    b = traffic.requests(mix, 2**32 + 77, 32000, 10)
    assert sorted(len(r.prompt) for r in a) == \
        sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    if mix["kind"] == "open_loop":
        # the multiset of gaps inside each segment is fixed; only the
        # first gap of each is dropped
        gaps = lambda rs: set(np.round(np.diff([r.due for r in rs]), 9))
        for lo, hi in ((0, 5), (5, 15), (15, 25)):
            seg = [[r for r in x if lo <= r.due < hi] for x in (a, b)]
            assert len(gaps(seg[0]) ^ gaps(seg[1])) <= 2


def test_window_same_work_every_seed():
    """The requests due inside the window are the same sizes for every
    seed, whatever the order they come in."""
    def window(seed):
        reqs = traffic.requests(CHAT, seed, 32000, 10)
        return [r for r in reqs if 5 <= r.due < 15]

    a, b = window(1), window(2**33 + 3)
    assert len(a) == len(b) == math.ceil(CHAT["rate_per_s"] * 10)
    assert sorted(len(r.prompt) for r in a) == \
        sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert [r.max_new for r in a] != [r.max_new for r in b]
    assert sorted(r.max_new for r in a) == sorted(
        traffic.quantile_sizes(CHAT["output"], len(a)).tolist())


def test_open_loop_rate_and_horizon():
    reqs = traffic.requests(CHAT, 9, 32000, 10)
    spans = (CHAT["preroll_s"], 10, CHAT["drain_s"])
    assert len(reqs) == sum(math.ceil(CHAT["rate_per_s"] * t)
                            for t in spans)
    due = [r.due for r in reqs]
    assert due == sorted(due) and due[0] == 0.0
    assert due[-1] < sum(spans)
    mean_gap = statistics.mean(np.diff(due))
    assert mean_gap == pytest.approx(1 / CHAT["rate_per_s"], rel=0.1)


def test_lognormal_quantiles():
    d = CHAT["prompt"]
    sizes = traffic.quantile_sizes(d, 2001)
    assert sizes.min() >= d["min"] and sizes.max() <= d["max"]
    assert np.median(sizes) == d["median"]
    # log-sizes spread by sigma (the clamp trims the far tails only)
    logs = np.log(sizes[200:-200])
    ref = np.log(d["median"]) + d["sigma"] * np.array(
        [statistics.NormalDist().inv_cdf((i + 0.5) / 2001)
         for i in range(200, 1801)])
    assert np.abs(logs - ref).max() < 0.01


def test_uniform_quantiles():
    d = BACKLOG["prompt"]
    sizes = traffic.quantile_sizes(d, 1793)
    assert sizes.min() == d["min"] and sizes.max() == d["max"]
    counts = np.bincount(sizes - d["min"])
    assert counts.min() >= 0 and counts.max() <= 2


def test_token_ids_in_range():
    reqs = traffic.requests(BACKLOG, 4, 32000, 10)
    toks = np.concatenate([np.asarray(r.prompt) for r in reqs[:20]])
    assert toks.min() >= 3 and toks.max() < 32000


def test_corpus_documents():
    mix = {"kind": "train", "shard_tokens": 200_000, "eos_id": 2,
           "zipf_a": 1.1,
           "doc_len": {"dist": "lognormal", "median": 1024, "sigma": 1.0,
                       "min": 64, "max": 16384}}
    a = traffic.corpus(mix, 7, 32000)
    assert np.array_equal(a, traffic.corpus(mix, 7, 32000))
    assert not np.array_equal(a, traffic.corpus(mix, 8, 32000))
    assert a.size == mix["shard_tokens"] and a.dtype == np.uint32
    eos = np.flatnonzero(a == 2)
    lens = np.diff(eos) - 1
    assert lens.min() >= 64 and lens.max() <= 16384
    assert 500 < np.median(lens) < 2000
    body = a[a != 2]
    assert body.min() >= 3 and body.max() < 32000
    # Zipf-like: the commonest id is far commoner than the median id
    counts = np.sort(np.bincount(body))[::-1]
    assert counts[0] > 50 * counts[len(counts) // 2]
