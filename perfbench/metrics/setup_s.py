"""setup_s (s, host clock): from the process's start to the window's
opening: imports, weights drawn, kernels built or loaded, every shape
warmed, and the set-up the traffic needs (the checked training steps,
an open loop's pre-roll, a backlog's first filling of the slots)."""


def read(ctx):
    return ctx["obs"]["setup_s"]
