"""gen_late_p95_ms.chat (ms, host clock): the 95th percentile over the
requests due in the window of submit time - due time: how long a
blocking ``step()`` held the open loop back."""

from perfbench.harness.stats import nearest_rank


def read(ctx):
    obs = ctx["obs"]
    if obs["kind"] != "serve" or not obs["open_loop"]:
        return None
    return nearest_rank([(r["submit"] - r["due"]) * 1e3
                         for r in obs["requests"]], 0.95)
