"""mfu.serve (%, host clock over the harness's FLOP count): the model
FLOPs of every prompt prefilled and every token decoded in the window
(unpadded prompts, each decoded token at its own position; GQA, the
window, the top-k experts) over the window's seconds, as a share of one
H100's 989 TFLOP/s in bf16."""

import numpy as np


def read(ctx):
    obs, fl, m = ctx["obs"], ctx["flops"], ctx["model"]
    if obs["kind"] != "serve":
        return None
    work = sum(fl.prefill_flops(m, n) for n in obs["prefills"])
    pos = np.asarray(obs["decode_positions"], dtype=np.int64)
    if pos.size:
        seen = pos + 1 if not m.window else np.minimum(pos + 1, m.window)
        work += fl.forward_flops(m, int(pos.size), int(seen.sum()))
    return 100.0 * work / obs["window_s"] / fl.PEAK_BF16_FLOPS
