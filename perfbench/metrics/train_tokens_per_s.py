"""train_tokens_per_s (tokens/s, host clock): every token of every step
the window ran, over the window's seconds (its last step finished on the
device)."""


def read(ctx):
    obs = ctx["obs"]
    if obs["kind"] != "train":
        return None
    return obs["tokens"] / obs["window_s"]
