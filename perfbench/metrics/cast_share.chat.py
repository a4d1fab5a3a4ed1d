"""cast_share.chat (%, device trace): the share of the window's device
time in dtype casts (operations launched inside ``aten::_to_copy``), in
an open-loop serving cell."""

from perfbench.harness.castshare import cast_share


def read(ctx):
    if ctx["mix"]["kind"] != "open_loop":
        return None
    return cast_share(ctx["trace"])
