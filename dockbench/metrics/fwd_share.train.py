"""Share (%) of the device's busy time spent under the program's
``dlpd::train.forward`` spans: the loss's forward (both complexes'
splats, CNNs and decoy scores).  The backward runs on autograd's own
thread, outside the span's range, so it has no share of its own."""


def read(t):
    s = t.op_s(["dlpd::train.forward"])
    if t.busy_s <= 0 or s <= 0:
        return None
    return 100.0 * s / t.busy_s
