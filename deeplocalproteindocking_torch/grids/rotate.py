"""Volume rotation about the grid centre by resampling.

Port of ``deeplocalproteindocking_tpu/grids/rotate.py``: the
``resample`` sweep rotates the ligand's *representation* volume (the
reference's formulation) instead of re-splatting rotated atoms.  Output
voxel x reads the input at ``R^T (x - c) + c``, ``c = (L-1)/2``.

Order 1 is trilinear, as the JAX package computes it: eight row gathers
over the flattened ``[L^3, C]`` volume, one per corner, summed in the
same corner order (indices int32, as JAX's).  Order 0 is nearest-neighbour with
``map_coordinates``' rule: round half away from zero, and an index
outside ``[0, L)`` reads 0 (mode ``"constant"``).  Rotations batch:
``R [..., 3, 3]`` gives ``[..., L, L, L, C]``.
"""
from __future__ import annotations

import torch


def _source_lattice(R: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse-mapped sample coordinates ``[..., 3, L^3]`` for rotations
    ``R [..., 3, 3]``: ``src_j = sum_i R[i, j] (x_i - c) + c``."""
    c = (L - 1) / 2.0
    ax = torch.arange(L, dtype=torch.float32, device=R.device) - c
    pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij")
                      ).reshape(3, -1)                  # [3, L^3]
    # A matmul, as the JAX einsum lowers to on the CPU (bit-equal there).
    return R.to(torch.float32).transpose(-1, -2) @ pts + c


def _round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``'s default: ties go away from zero (``torch.round``
    sends them to even).  ``x - trunc(x)`` is exact in float."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), 0.0)


def _flat_index(ix, iy, iz, L):
    clip = (lambda i: i.clamp(0, L - 1))
    return (clip(ix) * L + clip(iy)) * L + clip(iz)


def _in_range(i, L):
    return (i >= 0) & (i < L)


def rotate_volumes(vol: torch.Tensor, R: torch.Tensor, *,
                   order: int = 1) -> torch.Tensor:
    """Rotate ``vol [L, L, L, C]`` by each rotation of ``R [..., 3, 3]``
    about the grid centre -> ``[..., L, L, L, C]``."""
    L, C = vol.shape[0], vol.shape[-1]
    lead = R.shape[:-2]
    src = _source_lattice(R, L).reshape(-1, 3, L ** 3)  # [B, 3, L^3]
    vol_flat = vol.reshape(L ** 3, C)

    def rows(idx):
        return vol_flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (C,))

    if order == 0:
        i = _round_half_away_from_zero(src).to(torch.int32)
        ok = (_in_range(i[:, 0], L) & _in_range(i[:, 1], L)
              & _in_range(i[:, 2], L))
        out = torch.where(ok[..., None],
                          rows(_flat_index(i[:, 0], i[:, 1], i[:, 2], L)),
                          torch.zeros((), dtype=vol.dtype,
                                      device=vol.device))
    elif order == 1:
        f = torch.floor(src)
        frac = src - f
        i0 = f.to(torch.int32)
        out = torch.zeros((src.shape[0], L ** 3, C), dtype=vol.dtype,
                          device=vol.device)
        for dx in (0, 1):
            wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
            ix = i0[:, 0] + dx
            for dy in (0, 1):
                wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
                iy = i0[:, 1] + dy
                for dz in (0, 1):
                    wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                    iz = i0[:, 2] + dz
                    ok = _in_range(ix, L) & _in_range(iy, L) & _in_range(
                        iz, L)
                    w = torch.where(ok, wx * wy * wz, 0.0)
                    # out + w * row, in place (autograd keeps w and row).
                    out.addcmul_(w[..., None],
                                 rows(_flat_index(ix, iy, iz, L)))
    else:
        raise ValueError(f"order={order}: only 0 and 1 are supported")
    return out.reshape(lead + (L, L, L, C))


def rotate_volume(vol: torch.Tensor, R: torch.Tensor, *,
                  order: int = 1) -> torch.Tensor:
    """Rotate ``vol [L, L, L, C]`` by ``R [3, 3]`` about the grid
    centre."""
    return rotate_volumes(vol, R, order=order)
