"""Share (%) of the device's busy time spent in kernels launched under
the sweep's ``separable_splat`` (the rotated ligand's splat)."""


def read(t):
    if t.busy_s <= 0 or t.range_s.get("splat", 0.0) <= 0:
        return None
    return 100.0 * t.range_s["splat"] / t.busy_s
