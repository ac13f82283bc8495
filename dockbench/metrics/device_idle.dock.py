"""Share (%) of the lean traced window (the device's activity alone, no
probes) in which no operation ran on the device: 1 - busy / window; on
a mesh, the highest over the ranks.  Read only where that window's
requests take within a few percent of an untraced request's host time
(PERF.md section 3)."""


def read(t):
    if not t.lean_units:
        return None
    ranks = getattr(t, "ranks", None) or [t.device_window()]
    if min(b for b, _ in ranks) <= 0 or min(w for _, w in ranks) <= 0:
        return None
    return 100.0 * max(1.0 - b / w for b, w in ranks)
