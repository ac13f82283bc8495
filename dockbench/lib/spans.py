"""The program's own span records (``deeplocalproteindocking_torch.
utils.profiling.request_log``) of the traced run's untraced units."""
from __future__ import annotations


def untraced_records(t, name: str, match_seconds: bool = False):
    """The root records named ``name`` of ``t.untraced``: the
    ``len(t.untraced)`` of them that opened with no profiler recording,
    immediately before the first that opened with one.  None where the
    program keeps no such records, where there are not exactly that
    many, or (``match_seconds``) where their mean host duration is not
    within 2% of the units' mean ``seconds``: a wrong selection reads as
    no value."""
    try:
        from deeplocalproteindocking_torch.utils.profiling import (
            request_log)
    except ImportError:
        return None
    n = len(t.untraced or [])
    recs = [r for r in request_log() if r.name == name]
    first = next((i for i, r in enumerate(recs) if r.profiled), None)
    if not n or first is None or first < n:
        return None
    picked = recs[first - n:first]
    if match_seconds:
        rec_s = sum(r.end_ns - r.start_ns for r in picked) / n / 1e9
        unit_s = sum(u["seconds"] for u in t.untraced) / n
        if abs(rec_s - unit_s) > 0.02 * unit_s:
            return None
    return picked


def unlinked_program_kernels_s(t) -> float:
    """Device seconds of the program's own kernels (``dlpd::`` in their
    names: K1, K2, K3, built from ``csrc/``) that the profiler linked to
    no host operation, so that ``t.op_s`` finds them under no span.  On
    the H100 every K1 launch from the program's ctypes library comes out
    unlinked (PERF.md section 3)."""
    own = sum(s for name, (_, s) in t.kernels.items() if "dlpd::" in name)
    linked = sum(k.duration for e in t._cpu for k in e.kernels
                 if "dlpd::" in k.name)
    return own - linked / 1e6
