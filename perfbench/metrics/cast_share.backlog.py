"""cast_share.backlog (%, device trace): the share of the window's device
time in dtype casts (operations launched inside ``aten::_to_copy``), in
a backlog's serving cell: the decode step's per-call weight and cache
casts."""

from perfbench.harness.castshare import cast_share


def read(ctx):
    if ctx["mix"]["kind"] != "backlog":
        return None
    return cast_share(ctx["trace"])
