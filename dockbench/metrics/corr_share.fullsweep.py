"""Share (%) of the device's busy time spent in each chunk's correlation
(the z-DFT, K1, K2 and ``drill_topk`` on ``dft_fused``): the kernels
linked to torch's operators under the program's
``dlpd::sweep.correlate`` spans (``lib/linked.py``, not ``op_s``, which
counts a kernel more than once in this cell's long requests), plus the
program's own kernels (``dlpd::`` in their names: K1 and K2, which the
profiler links to no host operation and which in a docking request run
only in the correlation), the splat kernel left out."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.linked import linked_s  # noqa: E402

OWN, SPLAT = "dlpd::", "separable_splat"


def read(t):
    s = linked_s(t, {"dlpd::sweep.correlate"}, skip=OWN)
    own = sum(sec for name, (_, sec) in t.kernels.items()
              if OWN in name and SPLAT not in name)
    if t.busy_s <= 0 or s <= 0:
        return None
    return 100.0 * (s + own) / t.busy_s
