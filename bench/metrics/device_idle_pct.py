"""device_idle_pct (device_idle_pct.serve, device_idle_pct.train): the
share of the traced window in which no device operation ran (the union
of the profiler's device intervals), in percent."""


def read(rec):
    tr = getattr(rec, "trace", None)
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
