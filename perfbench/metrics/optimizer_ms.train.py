"""optimizer_ms.train (ms, device trace): device milliseconds a training
step in the optimizer's kernels (AdamW's foreach updates,
``multi_tensor_apply`` kernels), over the window's steps."""

KEYS = ("multi_tensor_apply", "adam", "Adam")


def read(ctx):
    obs, tr = ctx["obs"], ctx["trace"]
    if obs["kind"] != "train" or tr is None:
        return None
    secs = sum(v for k, v in tr["device_s"].items()
               if any(x in k for x in KEYS))
    if secs == 0:
        return None
    return 1e3 * secs / obs["steps"]
