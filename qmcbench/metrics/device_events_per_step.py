"""device_events_per_step (events/step): device activities (kernels,
copies, sets) of the traced window per method step: the host's launches."""


def read(ctx):
    s = ctx["summary"]
    if s.device_events == 0:
        return None
    return s.device_events / ctx["steps"]
