"""Share (%) of the lean traced window (the device's activity alone, no
probes) in which no operation ran on the device: 1 - busy / window."""


def read(t):
    if not t.lean_units or t.lean_busy_s <= 0 or t.lean_window_s <= 0:
        return None
    return 100.0 * (1.0 - t.lean_busy_s / t.lean_window_s)
