"""device_idle_share (%, layer: device): the share of the traced window in
which no kernel, copy or set ran on the card, from the union of their
intervals (overlapping streams count once)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
