"""ttft_p95_ms (ms, host clock): the 95th percentile over every request
due in the window of the time from its due time (open loop) to the end
of the ``step()`` that returned its first token. A request that failed
(it did not get all its tokens by the drain's end) counts as missing
every limit (infinite)."""

import math

from perfbench.harness.stats import nearest_rank


def read(ctx):
    obs = ctx["obs"]
    if obs["kind"] != "serve" or not obs["open_loop"]:
        return None
    vals = [(r["first"] - r["due"]) * 1e3 if r["whole"] else math.inf
            for r in obs["requests"]]
    v = nearest_rank(vals, 0.95)
    return None if v is None or math.isinf(v) else v
