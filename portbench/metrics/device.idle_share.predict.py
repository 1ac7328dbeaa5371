"""Share (%) of the profiled sub-window in which no kernel or copy ran on
the device (from the profiler's trace)."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
