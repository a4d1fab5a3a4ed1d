"""device_idle.backlog (%, device trace): the share of the traced window
in which no operation ran on the device, in a backlog's serving cell."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["mix"]["kind"] != "backlog" or tr is None:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
