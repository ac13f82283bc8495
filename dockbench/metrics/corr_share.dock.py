"""Share (%) of the device's busy time spent in each chunk's correlation
(the z-DFT, K1, K2 and ``drill_topk`` on ``dft_fused``): the device time
under the program's ``dlpd::sweep.correlate`` spans, plus that of the
program's own kernels the profiler linked to no host operation.  In a
docking request those kernels run only in the correlation."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.spans import unlinked_program_kernels_s  # noqa: E402


def read(t):
    s = t.op_s(["dlpd::sweep.correlate"])
    if t.busy_s <= 0 or s <= 0:
        return None
    return 100.0 * (s + unlinked_program_kernels_s(t)) / t.busy_s
