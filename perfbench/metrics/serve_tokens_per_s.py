"""serve_tokens_per_s (tokens/s, host clock): the output tokens that
reached the caller in the window, counted after the ``step()`` that
delivered them, over the window's seconds."""


def read(ctx):
    obs = ctx["obs"]
    if obs["kind"] != "serve":
        return None
    return obs["delivered"] / obs["window_s"]
