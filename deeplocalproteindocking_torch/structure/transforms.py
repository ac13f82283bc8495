"""Rigid-body transforms on coordinate tensors.

Port of ``deeplocalproteindocking_tpu/structure/transforms.py``.
Conventions: coordinates are ``[..., N, 3]`` float32 row vectors; a
rotation ``R`` acts as ``x -> x @ R.T``; ``apply_pose(x, R, t) = x @ R.T
+ t`` about the (already centered) ligand center.
"""
from __future__ import annotations

import torch


def rotate(coords: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotate ``[..., N, 3]`` coords by ``[..., 3, 3]`` rotations."""
    return torch.einsum("...ij,...nj->...ni", R, coords)


def apply_pose(coords: torch.Tensor, R: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Rigid pose: rotate about the origin then translate."""
    return rotate(coords, R) + t[..., None, :]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) ``[..., 4]`` (w, x, y, z) -> ``[..., 3, 3]``."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def axis_angle_to_matrix(axis: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula; ``axis [..., 3]`` need not be normalized."""
    a = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = angle / 2.0
    q = torch.cat([torch.cos(half)[..., None],
                   torch.sin(half)[..., None] * a], dim=-1)
    return quat_to_matrix(q)
