"""Pose clustering: closed-form pairwise RMSD of rigid poses + greedy NMS.

Port of ``deeplocalproteindocking_tpu/sweep/cluster.py``.  For rigid
poses of one ligand with centered coords X and gyration ``C = X^T X/N``:

    RMSD^2(i, j) = tr((R_i - R_j) C (R_i - R_j)^T) + ||t_i - t_j||^2
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pose_pairwise_rmsd(lig_coords: torch.Tensor, Rs: torch.Tensor,
                       ts: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Pairwise RMSD matrix ``[K, K]`` of poses ``Rs [K, 3, 3]``,
    ``ts [K, 3]`` of ``lig_coords [N, 3]`` (centered internally)."""
    if mask is None:
        mask = torch.ones(lig_coords.shape[0], dtype=lig_coords.dtype,
                          device=lig_coords.device)
    w = mask.to(lig_coords.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mu = (lig_coords * w[:, None]).sum(0) / n
    X = (lig_coords - mu) * w[:, None] ** 0.5
    C = (X.T @ X) / n                                   # [3, 3] gyration
    dR = Rs[:, None] - Rs[None, :]                      # [K, K, 3, 3]
    quad = torch.einsum("abij,jk,abik->ab", dR, C, dR)
    dt = ts[:, None] - ts[None, :]
    return torch.sqrt(torch.clamp(quad + (dt * dt).sum(-1), min=0.0))


def nms_cluster(scores, rmsd_matrix, radius: float,
                max_out: Optional[int] = None) -> np.ndarray:
    """Greedy NMS: accept the best-scoring pose, drop all within
    ``radius``; returns the accepted indices (ranked, int64)."""
    scores = np.asarray(scores)
    D = np.asarray(rmsd_matrix)
    keep, suppressed = [], np.zeros(len(scores), dtype=bool)
    for i in np.argsort(-scores):
        if suppressed[i] or not np.isfinite(scores[i]):
            continue
        keep.append(int(i))
        suppressed |= D[i] < radius
        if max_out is not None and len(keep) >= max_out:
            break
    return np.asarray(keep, dtype=np.int64)


def cluster_pose_set(lig_coords, poses, radius: float):
    """NMS-cluster a ``pipeline.PoseSet`` (host numpy arrays)."""
    if len(poses.scores) <= 1:
        return poses
    D = pose_pairwise_rmsd(torch.as_tensor(np.asarray(lig_coords)),
                           torch.as_tensor(poses.rotations),
                           torch.as_tensor(poses.translations))
    keep = nms_cluster(poses.scores, D.numpy(), radius)
    return type(poses)(scores=poses.scores[keep],
                       rotations=poses.rotations[keep],
                       translations=poses.translations[keep],
                       rot_idx=poses.rot_idx[keep],
                       shifts=poses.shifts[keep])
