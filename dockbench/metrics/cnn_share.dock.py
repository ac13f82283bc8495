"""Share (%) of the device's busy time spent in kernels launched under
the sweep's ``rep_fn`` (the ligand CNN: cuDNN convolutions, their layout
transposes, ELU and the shape channels)."""


def read(t):
    if t.busy_s <= 0 or t.range_s.get("rep_fn", 0.0) <= 0:
        return None
    return 100.0 * t.range_s["rep_fn"] / t.busy_s
