"""The numbers that decide ``correct``, each against its limit.

Training (three steps of the program against three of the reference from
the same weights and rows):

- ``loss_rel``: the largest ``|L - L_ref| / L_ref`` of the three losses;
- ``grad1_leaf``: the first step's gradient, as the optimizer got it
  (AdamW's first moment after one step over ``1 - beta1``), by the worst
  leaf: ``| |g| - |g_ref| | / max(|g_ref|, median leaf's |g_ref|)``;
- ``change3_leaf``: the parameters' change after the three steps, by the
  worst leaf alike. Leaves whose reference gradient is under a thousandth
  of the median leaf's move by round-off alone under Adam and are left
  out.

Serving, over a sample of served requests: ``max_logit_gap``, the widest
gap by which a served token's reference logit lies below the reference's
best at its position; ``p90_logit_gap``, the 90th percentile of those
gaps (nearest rank); ``mean_logit_gap``, their mean. A cell's limits
file names the numbers it compares: under top-2 routing a near-tie
between experts flips with the rounding of bf16 activations, and a
flipped token's FFN output changes wholesale, so a few positions read
gaps as wide as the fp8 control's widest while nearly all read none;
there the 90th percentile and the mean separate the program from the
control and the widest gap does not. The 90th percentile fails a fault
that touches a tenth of the tokens; the mean also fails one confined to
a few positions or one slot, since a token that is wrong there lies
logits below the best.

With ``--control 1`` the control's gaps are judged by the same limits
(``control_numbers``, ``judge``): the control has to come out as not
correct.
"""

from __future__ import annotations

import statistics


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, against the larger of its reference
    norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def worst_leaves(prog: dict, ref: dict, n: int = 5) -> list:
    """The ``n`` leaves with the widest gaps of norms (for the readings)."""
    med = statistics.median(ref.values())
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k,
                    prog[k], ref[k]) for k in ref), reverse=True)
    return [[k, g, p, r] for g, k, p, r in gaps[:n]]


def moving_leaves(g_ref: dict) -> set:
    med = statistics.median(g_ref.values())
    return {k for k, v in g_ref.items() if v >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (three floats), ``grad1`` and
    ``change3`` (leaf name to norm)."""
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_rel": loss_rel,
            "grad1_leaf": worst_leaf(prog["grad1"], ref["grad1"]),
            "change3_leaf": worst_leaf(prog["change3"], ref["change3"],
                                       moving_leaves(ref["grad1"]))}


def gap_stats(gaps) -> dict:
    """Quantiles of the per-token logit gaps (for the readings)."""
    import numpy as np

    g = np.sort(np.asarray(gaps, dtype=np.float64))
    if g.size == 0:
        return {}
    q = lambda x: float(g[min(g.size - 1, int(np.ceil(x * g.size)) - 1)])
    return {"n": int(g.size), "mean": float(g.mean()), "p50": q(0.5),
            "p90": q(0.9), "p99": q(0.99), "max": float(g[-1]),
            "nonzero": float((g > 0).mean()),
            "over_0.5": float((g > 0.5).mean())}


def serve_numbers(stats: dict) -> dict:
    """The serving numbers compared, from ``gap_stats`` of one side."""
    return {"max_logit_gap": stats.get("max"),
            "p90_logit_gap": stats.get("p90"),
            "mean_logit_gap": stats.get("mean")}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, check)``: every number at or under its limit, and the
    result line's ``check`` entry (each number beside its limit). A number
    that is missing or not finite fails."""
    check = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= good
        check[name] = {"value": value, "limit": limit}
    return ok, check
