"""The device's idle share of the traced window: 1 - the union of the
device records' intervals over the window's length, in %."""


def read(r):
    t = r.trace
    if t.records == 0 or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
