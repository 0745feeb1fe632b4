"""idle_pct: share of the traced span in which no operation ran on the
device (the union of the device's activity intervals, from the trace)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
