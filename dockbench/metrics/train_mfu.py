"""Model FLOPs of the traced run's untraced steps (those before the
profiled ones) over (their host seconds x 165 TFLOP/s), %.

Per complex of a step: the CNN forward and backward on the receptor's
L^3 grid and on each decoy's ligand box (forward, weight gradients, and
data gradients for every layer but the first, whose input is the
splat); the receptor's transform (C channels at 2.5 N log2 N) and per
decoy the ligand's transform, the coupling's multiply-adds over the
half spectrum (8 C per frequency) and the phase contraction (8 per
frequency), each three times for forward and backward.
"""
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.peaks import MFU_PEAK  # noqa: E402


def conv_train_flops(cfg, voxels):
    widths = [cfg["num_atom_types"]] + list(cfg["rep_features"])
    k3 = cfg["rep_kernel"] ** 3
    per = [2 * k3 * a * b * voxels for a, b in zip(widths[:-1],
                                                   widths[1:])]
    return 3 * sum(per) - per[0]


def step_flops(cfg, complexes, decoys):
    L = cfg["grid_size"]
    Ls = cfg["lig_grid_size"] or max(16, L // 2)
    C = cfg["rep_features"][-1] + (2 if cfg["shape_prior"] else 0)
    N = L ** 3
    half = L * L * (L // 2 + 1)
    fft = 2.5 * N * math.log2(N)
    per_decoy = conv_train_flops(cfg, Ls ** 3) + 3 * (
        C * fft + 8 * C * half + 8 * half)
    per_complex = conv_train_flops(cfg, N) + 3 * C * fft
    return complexes * (per_complex + decoys * per_decoy)


def read(t):
    if not t.untraced:
        return None
    flops = sum(step_flops(t.cfg, u["complexes"], u["decoys"])
                for u in t.untraced if u["done"])
    return 100.0 * flops / (sum(u["seconds"] for u in t.untraced)
                            * MFU_PEAK["float32"])
