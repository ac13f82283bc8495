"""Host microseconds per sweep chunk of the traced run's untraced
requests: the program's ``sweep.chunk`` span, summed over their
``dock`` records and divided by its count (no profiler running, no
synchronization)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.spans import untraced_records  # noqa: E402


def read(t):
    recs = untraced_records(t, "dock", match_seconds=True)
    if not recs:
        return None
    ns = sum(r.host_ns.get("sweep.chunk", 0) for r in recs)
    count = sum(r.count.get("sweep.chunk", 0) for r in recs)
    if not count:
        return None
    return ns / count / 1e3
