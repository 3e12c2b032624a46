"""device.idle.serve: the share of the traced slice of the window in which
no operation ran on the device (profiler's device events)."""


def read(obs):
    t = obs.get("tracer")
    if obs.get("path") != "serve" or t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
