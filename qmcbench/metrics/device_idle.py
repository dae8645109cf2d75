"""device_idle (%): the share of the traced window in which no kernel,
copy or set ran on the card (the union of the device's intervals)."""


def read(ctx):
    s = ctx["summary"]
    if s.device_events == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / ctx["window_s"])
