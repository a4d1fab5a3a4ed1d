"""tpot_p95_ms (ms, host clock): the 95th percentile over every request
due in the window of (last token's time - first token's time) /
(tokens - 1), each time the end of the ``step()`` that returned the
token. A request that failed (it did not get all its tokens by the
drain's end) counts as missing every limit (infinite)."""

import math

from perfbench.harness.stats import nearest_rank


def read(ctx):
    obs = ctx["obs"]
    if obs["kind"] != "serve" or not obs["open_loop"]:
        return None
    vals = []
    for r in obs["requests"]:
        if not r["whole"]:
            vals.append(math.inf)
        elif r["n"] > 1:
            vals.append((r["last"] - r["first"]) * 1e3 / (r["n"] - 1))
    v = nearest_rank(vals, 0.95)
    return None if v is None or math.isinf(v) else v
