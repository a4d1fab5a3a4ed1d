"""device_idle.train (%, device trace): the share of the traced window
in which no operation ran on the device."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["obs"]["kind"] != "train" or tr is None:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
