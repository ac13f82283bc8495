"""Host milliseconds per training step of the traced run's untraced
steps: the mean duration of the program's ``train.step`` records
(forward, backward and optimizer; no profiler running)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.spans import untraced_records  # noqa: E402


def read(t):
    recs = untraced_records(t, "train.step")
    if not recs:
        return None
    return sum(r.end_ns - r.start_ns for r in recs) / len(recs) / 1e6
