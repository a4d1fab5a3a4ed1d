"""flash_roofline.train (%, device trace): the least time the chip could
take for the window's flash kernels (K1 forward, K2 dQ, K3 dK/dV, each
call at the training shape, `flops.flash_call`) over their summed device
time, found by kernel name."""

KERNELS = (("K1", "flash_fwd"), ("K2", "flash_bwd_dq"),
           ("K3", "flash_bwd_dkv"))


def read(ctx):
    obs, tr, fl, m = ctx["obs"], ctx["trace"], ctx["flops"], ctx["model"]
    if obs["kind"] != "train" or tr is None:
        return None
    least = spent = 0.0
    for k, key in KERNELS:
        for name, secs in tr["device_s"].items():
            if key in name and (k != "K2" or "dkv" not in name):
                calls = tr["device_calls"][name]
                f, b = fl.flash_call(k, obs["batch"], obs["seq"], m.n_heads,
                                     m.head_dim, m.kv_heads, m.window)
                least += calls * fl.least_seconds(f, b)
                spent += secs
    if spent == 0:
        return None
    return 100.0 * least / spent
