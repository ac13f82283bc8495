"""K1 (``fused_correlate``) as a share (%) of its roofline: the sum over
its launches of each launch's least time, over the sum of their device
times.

A launch's least time (``chip_smoke.py`` phase 2's rule, frozen): its
twelve inputs read once and ``D`` (two float32 ``[b, K, X', Y']``)
written once at HBM speed, or its function's operations as FFTs at the
peak of its precision (bf16 on the tensor cores; float32 as 3xTF32),
whichever is longer.  Per (rotation, kz): a forward FFT along y for
each of the box's X rows and along x for each of L columns, per
channel; the product with the receptor summed over channels (8 C L^2);
the inverse along x and y (2 L FFTs).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.peaks import bound_s, fft_flops  # noqa: E402

KERNEL = "fused_correlate"


def launch_bound_s(shapes) -> float:
    """Least seconds of one launch from its tensor arguments' ``(shape,
    dtype)`` in call order (Are, Aim, Hre, Him, Wy.., Wx.., Ux.., Uy..)."""
    size = {"bfloat16": 2, "float32": 4}
    nbytes = sum(size[dt] * _numel(s) for s, dt in shapes[:12])
    b, K, C, X, Y = shapes[0][0]
    L = shapes[8][0][1]                     # Ux [I, X']
    Xp, Yp = shapes[8][0][1], shapes[10][0][1]
    nbytes += 2 * b * K * Xp * Yp * 4
    flops = (C * (X + L) * fft_flops(L) + 8 * C * L * L
             + 2 * L * fft_flops(L)) * K * b
    peak = "bfloat16" if shapes[0][1] == "bfloat16" else "3xtf32"
    return bound_s(nbytes, flops, peak)


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def read(t):
    calls = t.records.get("k1", [])
    runs = [v for n, v in t.kernels.items() if KERNEL in n]
    count = sum(c for c, _ in runs)
    dev_s = sum(s for _, s in runs)
    if not calls or count != len(calls) or dev_s <= 0:
        return None
    return 100.0 * sum(launch_bound_s(c) for c in calls) / dev_s
