"""Matmul-form separable Gaussian splat (atoms -> typed density grid).

Port of ``separable_splat`` in ``deeplocalproteindocking_tpu/grids/
voxelize.py``.  The Gaussian factorizes per axis, so

    D[x, y, z, t] = sum_a Px[a, x] * Py[a, y] * Pz[a, z] * 1[type_a = t]

is one batched matrix product ``U^T @ W`` with ``U[a, (y, z)] = Py Pz``
and ``W[a, (x, t)] = Px onehot``: no scatter, deterministic, exact (no
window truncation).  Volumes are channels-last ``[..., L, L, L, T]``.
"""
from __future__ import annotations

from typing import Optional

import torch


def _contract(coords, tsafe, mask, L, T, resolution, sigma, origin):
    """Density of atom sets ``coords [B, n, 3]`` -> ``[B, L, L, L, T]``;
    ``tsafe``/``mask`` are ``[n]`` (shared) or ``[B, n]`` (per row)."""
    g = (coords - origin) / resolution - 0.5          # voxel-unit centers
    centers = torch.arange(L, dtype=coords.dtype, device=coords.device)
    d = (g[..., None] - centers) * resolution           # [B, n, 3, L]
    prof = torch.exp(-(d * d) / (2.0 * sigma * sigma))
    px, py, pz = prof[..., 0, :], prof[..., 1, :], prof[..., 2, :]
    px = px * mask[..., None]
    onehot = torch.nn.functional.one_hot(tsafe, T).to(coords.dtype)
    W = px[..., :, None] * onehot[..., None, :]        # [B, n, L, T]
    U = py[..., :, None] * pz[..., None, :]            # [B, n, L, L]
    B, n = coords.shape[:2]
    out = torch.bmm(U.reshape(B, n, L * L).transpose(1, 2),
                    W.reshape(B, n, L * T))            # [B, (y z), (x t)]
    return out.reshape(B, L, L, L, T).permute(0, 3, 1, 2, 4)


def separable_splat(coords: torch.Tensor,
                    types: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    *,
                    grid_size: int = 64,
                    resolution: float = 1.25,
                    sigma: float = 1.0,
                    num_types: int = 11,
                    atom_chunk: Optional[int] = None) -> torch.Tensor:
    """Splat ``coords [..., n, 3]`` (one atom set, or a batch of rotated
    copies of it) with shared ``types [n]`` / ``mask [n]``, or per-row
    ``types [..., n]`` / ``mask [..., n]`` broadcast against the leading
    axes of ``coords`` (a batch of different atom sets), into
    ``[..., L, L, L, T]`` float32 on a box centered on coordinate 0.

    ``atom_chunk`` bounds the ``[n, L^2]`` intermediate on big grids by
    accumulating the density over chunks of atoms.
    """
    L, T = grid_size, num_types
    lead = coords.shape[:-2]
    n = coords.shape[-2]
    coords = coords.reshape(-1, n, 3)
    half = 0.5 * L * resolution
    origin = torch.full((3,), -half, dtype=torch.float32,
                        device=coords.device)
    if mask is None:
        mask = torch.ones(types.shape, dtype=coords.dtype,
                          device=coords.device)
    mask = mask.to(coords.dtype) * (types >= 0).to(coords.dtype)
    tsafe = types.clamp(0, T - 1).long()
    if tsafe.ndim > 1:                                 # per-row atom sets
        tsafe = tsafe.broadcast_to(lead + (n,)).reshape(-1, n)
    if mask.ndim > 1:
        mask = mask.broadcast_to(lead + (n,)).reshape(-1, n)
    if atom_chunk is None or n <= atom_chunk:
        out = _contract(coords, tsafe, mask, L, T, resolution, sigma,
                        origin)
    else:
        out = None
        for a0 in range(0, n, atom_chunk):
            part = _contract(coords[:, a0:a0 + atom_chunk],
                             tsafe[..., a0:a0 + atom_chunk],
                             mask[..., a0:a0 + atom_chunk], L, T,
                             resolution, sigma, origin)
            out = part if out is None else out + part
    return out.reshape(lead + (L, L, L, T))
