"""device_idle_frac: the share of the traced interval in which no
operation ran on the card (kernels, copies and sets, merged over
streams)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 1.0 - r.trace.busy_s / r.trace.window_s
