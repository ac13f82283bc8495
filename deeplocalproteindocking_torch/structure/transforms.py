"""Rigid-body transforms on coordinate tensors.

Port of ``deeplocalproteindocking_tpu/structure/transforms.py``.
Conventions: coordinates are ``[..., N, 3]`` float32 row vectors; a
rotation ``R`` acts as ``x -> x @ R.T``; ``apply_pose(x, R, t) = x @ R.T
+ t`` about the (already centered) ligand center.
"""
from __future__ import annotations

from typing import Optional

import torch


def rotate(coords: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotate ``[..., N, 3]`` coords by ``[..., 3, 3]`` rotations."""
    return torch.einsum("...ij,...nj->...ni", R, coords)


def translate(coords: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Shift ``[..., N, 3]`` coords by ``[..., 3]``."""
    return coords + t[..., None, :]


def center_of_mass(coords: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean position over real atoms; ``mask`` is ``[..., N]`` bool or
    float."""
    if mask is None:
        return coords.mean(dim=-2)
    w = mask.to(coords.dtype)[..., None]
    return (coords * w).sum(dim=-2) / torch.clamp(w.sum(dim=-2), min=1.0)


def bounding_box(coords: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
    """``(min, max)`` corners over real atoms (``+inf, -inf`` where no
    atom is real)."""
    if mask is None:
        return coords.amin(dim=-2), coords.amax(dim=-2)
    m = mask.to(torch.bool)[..., None]
    inf = torch.tensor(torch.inf, dtype=coords.dtype, device=coords.device)
    lo = torch.where(m, coords, inf).amin(dim=-2)
    hi = torch.where(m, coords, -inf).amax(dim=-2)
    return lo, hi


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


def random_rotations(n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` rotations uniform on SO(3) via Gaussian quaternions, drawn
    from ``generator`` on its device."""
    q = torch.randn((n, 4), generator=generator, device=generator.device)
    return quat_to_matrix(q)


def axis_angle_to_matrix(axis: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula; ``axis [..., 3]`` need not be normalized."""
    a = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = angle / 2.0
    q = torch.cat([torch.cos(half)[..., None],
                   torch.sin(half)[..., None] * a], dim=-1)
    return quat_to_matrix(q)
