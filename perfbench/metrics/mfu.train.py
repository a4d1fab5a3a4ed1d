"""mfu.train (%, host clock over the harness's FLOP count): the model FLOPs
of the window's training steps (`flops.train_step_flops`: GQA, the
window, SwiGLU, the top-k experts) over the window's seconds, as a share
of one H100's 989 TFLOP/s in bf16."""


def read(ctx):
    obs, fl = ctx["obs"], ctx["flops"]
    if obs["kind"] != "train":
        return None
    work = fl.train_step_flops(ctx["model"], obs["batch"], obs["seq"])
    return 100.0 * work * obs["steps"] / obs["window_s"] / fl.PEAK_BF16_FLOPS
