"""The share of device time in dtype casts, for the cast_share readers."""


def cast_share(trace) -> float | None:
    """Device seconds of the operations launched inside
    ``aten::_to_copy`` (``.to(dtype)``, ``.float()``) over all device
    seconds in the window, in %; None when the trace links no launch."""
    if trace is None or trace["cast_s"] is None or \
            not trace["device_total_s"]:
        return None
    return 100.0 * trace["cast_s"] / trace["device_total_s"]
