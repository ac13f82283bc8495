"""K2 (``invz_blockmax``) as a share (%) of its roofline: the sum over
its launches of each launch's least time, over the sum of their device
times.

A launch's least time (``chip_smoke.py`` phase 2's rule, frozen): ``D``
(two float32 ``[b, K, L, L]``) and the bias read once and the block
maxima (``b L^3 / 32`` float32) written once at HBM speed, or the c2r
FFT's operations along kz per (rotation, x, y) column at the float32
peak, whichever is longer.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.peaks import bound_s  # noqa: E402

KERNEL = "invz_blockmax"


def k2_fft_flops(L: int) -> float:
    """Operations per column: the packing (12 per k), the radix-8 pass
    with its twiddles, the radix-Q pass, the 1/L scale, the bias add and
    the max."""
    M = L // 2
    Q = M // 8
    radix = {2: 4, 4: 16, 6: 56, 8: 56}
    return 12 * M + Q * radix[8] + 6 * Q * 7 + 8 * radix[Q] + 3 * L


def launch_bound_s(shapes) -> float:
    """Least seconds of one launch from its tensor arguments' ``(shape,
    dtype)`` in call order (Dre, Dim, MzRe, MzIm, bias)."""
    (b, K, X, Y), _ = shapes[0]
    L = shapes[2][0][1]                     # Mz [K, L]
    bias = 1
    for d in shapes[4][0]:
        bias *= d
    nbytes = (2 * b * K * X * Y + bias + b * L ** 3 // 32) * 4
    return bound_s(nbytes, k2_fft_flops(L) * b * L * L, "float32")


def read(t):
    calls = t.records.get("k2", [])
    runs = [v for n, v in t.kernels.items() if KERNEL in n]
    count = sum(c for c, _ in runs)
    dev_s = sum(s for _, s in runs)
    if not calls or count != len(calls) or dev_s <= 0:
        return None
    return 100.0 * sum(launch_bound_s(c) for c in calls) / dev_s
