"""Decoy poses for local-docking representation training.

Port of ``deeplocalproteindocking_tpu/train/decoys.py``.  A pose ``(R,
s)`` places the centered ligand at ``R x + s * resolution``, ``s`` an
integer voxel shift; the native pose is ``(I, native_shift)``.  Decoys
are drawn from a ``torch.Generator`` (the JAX package's PRNG streams
cannot be reproduced) and labelled by :func:`label_decoys`, which takes
any samples, so a test can label the JAX package's own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from deeplocalproteindocking_torch.structure.so3 import local_rotations
from deeplocalproteindocking_torch.structure.transforms import (
    apply_pose, random_rotations)
from deeplocalproteindocking_torch.utils.rmsd import rmsd


class DecoySet(NamedTuple):
    rotations: torch.Tensor   # [D, 3, 3]
    shifts: torch.Tensor      # [D, 3] voxel shifts
    lrmsd: torch.Tensor       # [D] float32 quality labels (Angstrom)


def label_decoys(lig_coords: torch.Tensor, lig_mask: torch.Tensor,
                 native_shift: torch.Tensor, rotations: torch.Tensor,
                 shifts: torch.Tensor, resolution: float) -> DecoySet:
    """Each pose's ligand RMSD to the native pose ``(I, native_shift)``,
    no superposition; ``lig_coords [N, 3]`` centered, ``lig_mask [N]``."""
    native = lig_coords + native_shift.to(torch.float32) * resolution
    posed = apply_pose(lig_coords[None], rotations,
                       shifts.to(torch.float32) * resolution)
    lrmsd = rmsd(posed, native[None], lig_mask[None].expand(
        posed.shape[:-1]))
    return DecoySet(rotations=rotations, shifts=shifts, lrmsd=lrmsd)


def generate_decoys(generator: torch.Generator,
                    lig_coords: torch.Tensor,
                    lig_mask: torch.Tensor,
                    native_shift: torch.Tensor,
                    *,
                    n: int,
                    resolution: float,
                    max_angle: float,
                    max_shift: float,
                    include_native: bool = True) -> DecoySet:
    """``n`` decoys around the native pose: rotations in a cone of
    ``max_angle`` radians, shifts within ``max_shift`` Angstrom (rounded
    to voxels, at least 1).  With ``include_native`` decoy 0 is the
    native pose itself (the ranking loss needs a near-native)."""
    eye = torch.eye(3, dtype=torch.float32)
    Rs = local_rotations(eye, max_angle, n, generator=generator)
    max_vox = max(1, int(round(max_shift / resolution)))
    dt = torch.randint(-max_vox, max_vox + 1, (n, 3), generator=generator,
                       device=generator.device)
    shifts = native_shift[None].to(torch.int32) + dt.to(torch.int32)
    if include_native:
        Rs[0] = eye
        shifts[0] = native_shift.to(torch.int32)
    return label_decoys(lig_coords, lig_mask, native_shift, Rs, shifts,
                        resolution)


def generate_global_decoys(generator: torch.Generator,
                           lig_coords: torch.Tensor,
                           lig_mask: torch.Tensor,
                           native_shift: torch.Tensor,
                           *,
                           n: int,
                           resolution: float,
                           max_shift_vox: int) -> DecoySet:
    """Uniform GLOBAL decoys: full SO(3) rotations x box-wide shifts in
    ``[-max_shift_vox, max_shift_vox]^3`` (which should keep the shifted
    ligand inside the box, so no label is wrap-aliased)."""
    Rs = random_rotations(n, generator)
    shifts = torch.randint(-max_shift_vox, max_shift_vox + 1, (n, 3),
                           generator=generator,
                           device=generator.device).to(torch.int32)
    return label_decoys(lig_coords, lig_mask, native_shift, Rs, shifts,
                        resolution)
