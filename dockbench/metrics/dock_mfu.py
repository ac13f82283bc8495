"""Model FLOPs of the traced run's untraced requests (those before the
profiled ones) over (their host seconds x peak), %.

Per rotation: the CNN's convolutions on the rotated ligand's box (the
last layer at ``coupling_rank`` outputs when the rank-r coupling is
folded into it), and the translational correlation counted as FFTs: a
real-to-complex transform of each correlated channel on the L^3 grid
at 2.5 N log2 N, the coupling's complex multiply-adds over the half
spectrum (8 per channel and frequency), one complex-to-real transform.
Per request: the receptor's CNN on the L^3 grid.  The splat is not
model FLOPs.  The count is the same whatever implements it.  Peak:
bf16 989 TFLOP/s; float32 165 TFLOP/s (3xTF32), per card of the run.
"""
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.peaks import MFU_PEAK  # noqa: E402


def conv_flops(cfg, voxels, last_out=None):
    widths = [cfg["num_atom_types"]] + list(cfg["rep_features"])
    if last_out is not None:
        widths[-1] = last_out
    k3 = cfg["rep_kernel"] ** 3
    return sum(2 * k3 * a * b * voxels for a, b in zip(widths[:-1],
                                                       widths[1:]))


def request_flops(cfg, rotations, box):
    L = cfg["grid_size"]
    C = cfg["rep_features"][-1] + (2 if cfg["shape_prior"] else 0)
    r = cfg["coupling_rank"]
    ch = C if r is None or r >= C else r
    lig = conv_flops(cfg, box ** 3, None if ch == C else r)
    N = L ** 3
    half = L * L * (L // 2 + 1)
    fft = 2.5 * N * math.log2(N)
    corr = ch * fft + 8 * ch * half + fft
    return rotations * (lig + corr) + conv_flops(cfg, N)


def read(t):
    if not t.untraced:
        return None
    flops = sum(request_flops(t.cfg, u["rotations"], u["lig_box"])
                for u in t.untraced if u["done"])
    cards = len(getattr(t, "ranks", None) or [1])
    return 100.0 * flops / (sum(u["seconds"] for u in t.untraced) * cards
                            * MFU_PEAK[t.cfg["compute_dtype"]])
