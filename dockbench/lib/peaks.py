"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W) and the roofline rule, frozen.

The rule: a kernel's least time is the larger of its bytes (each input
read once, each output written once) over the HBM bandwidth and its
operations over the peak of the precision it runs in.  Float32 work on
the tensor cores runs as 3xTF32, a third of the TF32 rate.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
# The precision whose peak a dtype's model FLOPs are held against: bf16
# on the tensor cores, float32 as 3xTF32 (the port's float32 K1).
MFU_PEAK = {"bfloat16": PEAK_FLOPS["bfloat16"],
            "float32": PEAK_FLOPS["3xtf32"]}


def fft_flops(n: int) -> float:
    """Operations of one complex FFT of length n: 5 n log2 n."""
    return 5 * n * math.log2(n)


def bound_s(nbytes: float, flops: float, peak: str) -> float:
    """The least time in seconds: bytes at HBM speed or operations at
    ``PEAK_FLOPS[peak]``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak])
