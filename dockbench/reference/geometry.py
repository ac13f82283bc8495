"""Plain geometry of rigid docking: centering, the ligand box, the
rotation set, the translation mask and pose RMSD.

Written from the published definitions the program implements (the
Super-Fibonacci spiral of Alexa, CVPR 2022; greedy NMS over closed-form
rigid-pose RMSD), in numpy and torch.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

_PHI = float(np.sqrt(2.0))
_PSI = 1.533751168755204288118041      # positive root of x^4 = x + 4


def centered(coords: np.ndarray) -> np.ndarray:
    """Coordinates minus their mean over every atom (typed or not), in
    the coordinates' own dtype."""
    c = np.asarray(coords)
    return c - c.mean(axis=0, keepdims=True)


def receptive_field(features, kernel: int, shape_prior: bool) -> int:
    rf = len(features) * (kernel // 2) + 1
    return max(rf, 3) if shape_prior else rf


def ligand_box(typed_coords: np.ndarray, resolution: float, sigma: float,
               rf: int, grid_size: int) -> int:
    """Smallest box (multiple of 8, at least 16, at most the grid) that
    holds the atoms, their 3-sigma tails and the receptive field, and
    the rotation-invariant radius (without the receptive field)."""
    xyz = np.asarray(typed_coords, np.float64)
    extent = 2.0 * (np.abs(xyz).max() + 3.0 * sigma)
    ls = int(np.ceil(extent / resolution)) + 2 * rf
    radius = float(np.sqrt((xyz * xyz).sum(axis=1).max()))
    ls_contain = int(np.ceil(2.0 * (radius + 3.0 * sigma) / resolution))
    ls = min(grid_size, ((max(ls, ls_contain) + 7) // 8) * 8)
    return max(ls, 16)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions ``[..., 4]`` (w, x, y, z), normalized, to rotations
    ``[..., 3, 3]``."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def super_fibonacci(n: int, device=None):
    """``[n, 3, 3]``: the Super-Fibonacci spiral on SO(3) from float64
    quaternions: float64 numpy, or (``device``) float32 torch rotations
    made from the float32 quaternions on that device."""
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r, big_r = np.sqrt(t), np.sqrt(1.0 - t)
    q = np.stack([r * np.sin(d / _PHI), r * np.cos(d / _PHI),
                  big_r * np.sin(d / _PSI), big_r * np.cos(d / _PSI)], -1)
    if device is None:
        return quat_to_matrix(torch.as_tensor(q)).numpy()
    return quat_to_matrix(torch.as_tensor(q, dtype=torch.float32,
                                          device=device))


def padded(n: int, bucket) -> int:
    """Rows of an atom array of n atoms padded up to a multiple of
    ``bucket`` (at least one bucket); n without a bucket."""
    if not bucket:
        return n
    return max(bucket, -(-n // bucket) * bucket)


def wrap_cap(lig_typed: np.ndarray, grid_size: int, resolution: float,
             sigma: float):
    """Largest |shift| per axis (voxels) whose ligand stays clear of the
    circular wrap, or None when every shift is allowed."""
    half = int(np.ceil((np.abs(lig_typed).max() + 3.0 * sigma)
                       / resolution))
    cap = max(1, grid_size // 2 - half)
    return cap if cap < grid_size // 2 else None


def signed(idx: np.ndarray, L: int) -> np.ndarray:
    idx = np.asarray(idx)
    return np.where(idx <= L // 2, idx, idx - L)


def in_mask(shifts: np.ndarray, cap, L: int) -> np.ndarray:
    """Whether signed voxel shifts ``[..., 3]`` lie inside the mask."""
    if cap is None:
        return np.ones(np.shape(shifts)[:-1], bool)
    s = np.abs(signed(np.mod(shifts, L), L))
    return (np.minimum(s, L - s) <= cap).all(-1)


def pose_rmsd(lig_all: np.ndarray, Ra, ta, Rb, tb) -> np.ndarray:
    """RMSD between rigid poses ``(Ra [n,3,3], ta [n,3])`` and ``(Rb [m,
    3,3], tb [m,3])`` of the centered ligand ``lig_all [N, 3]`` (every
    atom), ``[n, m]``: ``sqrt(tr(dR C dR^T) + |dt|^2)``, C the gyration
    tensor."""
    X = np.asarray(lig_all, np.float64)
    X = X - X.mean(0)
    C = X.T @ X / len(X)
    dR = np.asarray(Ra, np.float64)[:, None] - np.asarray(Rb,
                                                          np.float64)[None]
    quad = np.einsum("abij,jk,abik->ab", dR, C, dR)
    dt = np.asarray(ta, np.float64)[:, None] - np.asarray(tb,
                                                          np.float64)[None]
    return np.sqrt(np.maximum(quad + (dt * dt).sum(-1), 0.0))
