"""Gaussian splats (atoms -> typed density grid).

Port of ``deeplocalproteindocking_tpu/grids/voxelize.py``: ``splat``,
the dense reference voxelizer (a window of ``window`` voxels per axis
around each atom, scatter-added), and ``separable_splat``, the main
path's matmul form.  The Gaussian factorizes per axis, so

    D[x, y, z, t] = sum_a Px[a, x] * Py[a, y] * Pz[a, z] * 1[type_a = t]

is one batched matrix product ``U^T @ W`` with ``U[a, (y, z)] = Py Pz``
and ``W[a, (x, t)] = Px onehot``: no scatter, deterministic, exact (no
window truncation).  Volumes are channels-last ``[..., L, L, L, T]``.

``separable_splat`` computes that product with its plain version
:func:`_contract` for CPU tensors, and for CUDA tensors with the
hand-written kernel ``csrc/separable_splat.cu``, which sums each atom
into its own type only (no product with a zero of the one-hot, no masked
atom) and never writes ``U``, ``W`` or the profiles to device memory; it
returns the same values in the same strides, the float32 sum taken in
another order.  A CUDA call whose coordinates need a gradient (only
``refine_poses`` asks for one) takes the plain version on the card: the
kernel has no backward.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate.fused import SMEM_OPTIN_BYTES

_MICRO = (2, 4, 8)     # the kernel's y, z, x a thread
_KC = 64               # its atoms per profile chunk
_MAX_THREADS = 256     # its threads per block, at most
_MAX_SEG = 4096        # its atoms listed at once
_MAX_TYPES = 16
_MAX_ROWS = 65535      # rows per launch (the grid's y)
_SMEM_STATIC = 1024    # kept for the kernel's static shared memory

# The route each separable_splat call took since the last reset (a run's
# proof of which one the main path used): kernel launches, and calls of
# the plain version (CPU tensors, or coordinates that need a gradient).
launches = 0
plain_calls = 0


def default_origin(grid_size: int, resolution: float) -> torch.Tensor:
    """Origin (corner of voxel 0) that centers the box on coordinate 0."""
    half = 0.5 * grid_size * resolution
    return torch.tensor([-half, -half, -half], dtype=torch.float32)


def splat(coords: torch.Tensor,
          types: torch.Tensor,
          mask: Optional[torch.Tensor] = None,
          *,
          grid_size: int = 128,
          resolution: float = 1.25,
          sigma: float = 1.0,
          window: int = 6,
          num_types: int = 11,
          origin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Splat ``coords [N, 3]`` with ``types [N]`` into ``[L, L, L, T]``.

    ``mask`` marks real atoms (padding rows excluded); atoms with type
    ``< 0`` are excluded as well.  Each atom adds its Gaussian to the
    ``window`` voxels per axis around it that lie inside the box.
    Differentiable w.r.t. ``coords``.  Voxel ``i`` is centered at
    ``origin + (i + 0.5) * resolution``.
    """
    L, W, T = grid_size, window, num_types
    if origin is None:
        origin = default_origin(L, resolution)
    origin = origin.to(device=coords.device, dtype=coords.dtype)
    if mask is None:
        mask = torch.ones(coords.shape[:-1], dtype=coords.dtype,
                          device=coords.device)
    mask = mask.to(coords.dtype) * (types >= 0).to(coords.dtype)
    tsafe = types.clamp(0, T - 1).long()
    g = (coords - origin) / resolution - 0.5          # [N, 3]
    base = torch.floor(g.detach()).long() - (W // 2 - 1)
    offs = torch.arange(W, device=coords.device)

    def axis_terms(axis):
        idx = base[:, axis, None] + offs[None, :]      # [N, W]
        d = (idx.to(g.dtype) - g[:, axis, None]) * resolution
        w = torch.exp(-(d * d) / (2.0 * sigma * sigma))
        w = torch.where((idx >= 0) & (idx < L), w, torch.zeros_like(w))
        return idx.clamp(0, L - 1), w

    ix, wx = axis_terms(0)
    iy, wy = axis_terms(1)
    iz, wz = axis_terms(2)
    w = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
         * mask[:, None, None, None])
    flat = (((ix[:, :, None, None] * L + iy[:, None, :, None]) * L
             + iz[:, None, None, :]) * T + tsafe[:, None, None, None])
    grid = torch.zeros(L * L * L * T, dtype=coords.dtype,
                       device=coords.device)
    grid = grid.index_add(0, flat.reshape(-1), w.reshape(-1))
    return grid.reshape(L, L, L, T)


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

    ``atom_chunk`` bounds the plain version's ``[n, L^2]`` intermediate
    on big grids by accumulating the density over chunks of atoms; the
    kernel has no intermediate and takes every atom in one launch.
    """
    global plain_calls
    L, T = grid_size, num_types
    if kernel_route(coords):
        return _splat_kernel(coords, types, mask, L, T, resolution, sigma)
    plain_calls += 1
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


def kernel_route(coords) -> bool:
    """Whether ``separable_splat`` launches the kernel for ``coords``:
    CUDA tensors, unless autograd records and ``coords`` needs a
    gradient (the kernel has no backward; ``refine_poses`` alone asks)."""
    return coords.device.type == "cuda" and not (torch.is_grad_enabled()
                                                 and coords.requires_grad)


def splat_smem_bytes(Yb: int, Zb: int, Xb: int, T: int, seg: int) -> int:
    """Dynamic shared memory of one kernel block (``smem_bytes`` in
    ``csrc/separable_splat.cu``): two profile chunks ``[64, Xb + Zb +
    Yb]`` (rows padded to 4) or, in a tile's last block, the staging ``[2,
    Zb, Xb, T]``, whichever is larger, in float32; the last block's table
    of a run (``Xb T`` int32); ``seg`` atom indices (2 bytes each)."""
    prof = 2 * _KC * ((Xb + Zb + Yb + 3) // 4 * 4)
    return 4 * max(prof, 2 * Zb * Xb * T) + 4 * Xb * T + 2 * seg


@functools.cache
def splat_tile(L: int, T: int) -> tuple:
    """``(Yb, Zb, Xb)``: the kernel's tile at grid L and T types, of least
    modelled cost among those that fit a block.

    A block sums one type over the tile; a thread holds 2 y x 4 z x 8 x of
    it, so Yb is even, Zb a multiple of 4, Xb of 8, and a block has
    ``(Yb / 2) (Zb / 4) (Xb / 8)`` threads, at most 256.  Per atom, each
    tile's block issues about 78 instructions a warp (64 FMAs, 8
    products, the loads, the loop) and 20 per profile entry, Yb + Zb + Xb
    entries; tiles that overhang L are paid for whole.  Its shared memory
    (:func:`splat_smem_bytes`, at 4,096 listed atoms) fits the opt-in
    limit."""
    ry, rz, rx = _MICRO
    best = None
    for Xb in range(rx, -(-L // rx) * rx + 1, rx):
        for Zb in range(rz, -(-L // rz) * rz + 1, rz):
            for Yb in range(ry, -(-L // ry) * ry + 1, ry):
                threads = (Yb // ry) * (Zb // rz) * (Xb // rx)
                if threads > _MAX_THREADS:
                    break
                if (splat_smem_bytes(Yb, Zb, Xb, T, _MAX_SEG) + _SMEM_STATIC
                        > SMEM_OPTIN_BYTES):
                    break
                tiles = (-(-L // Yb)) * (-(-L // Zb)) * (-(-L // Xb))
                cost = tiles * (78 * -(-max(threads, _KC) // 32)
                                + 20 * (Xb + Zb + Yb) / 32)
                if best is None or cost < best[0]:
                    best = (cost, Yb, Zb, Xb)
    if best is None:
        raise ValueError(f"separable_splat: no kernel tile fits T={T}")
    return best[1:]


def _rows(x: torch.Tensor, lead: tuple, n: int) -> tuple:
    """``x [..., n]`` broadcast against the leading axes ``lead`` as ``(R
    rows [R, n] contiguous, rows_per)``: row b of the ``prod(lead)`` rows
    reads row ``b // rows_per``.  A per-row tensor whose broadcast axes
    all trail (``[G, 1, n]`` against ``(G, chunk)``) keeps its R rows;
    any other is expanded to one row per b."""
    B = math.prod(lead)
    shape = (1,) * (len(lead) + 1 - x.ndim) + tuple(x.shape[:-1])
    k = len(shape)
    while k and shape[k - 1] == 1:
        k -= 1
    if shape[:k] == tuple(lead[:k]):
        R = math.prod(shape[:k])
        return x.reshape(R, n).contiguous(), B // R
    return x.broadcast_to(lead + (n,)).reshape(B, n).contiguous(), 1


def _splat_kernel(coords, types, mask, L, T, resolution, sigma):
    """``separable_splat`` on the card: one launch of
    ``csrc/separable_splat.cu`` over every row and atom.  Raises for what
    the kernel does not take."""
    global launches
    if coords.dtype != torch.float32:
        raise TypeError(f"separable_splat: the kernel takes float32 "
                        f"coordinates, got {coords.dtype}")
    if not 1 <= T <= _MAX_TYPES:
        raise ValueError(f"separable_splat: the kernel takes 1 to "
                         f"{_MAX_TYPES} atom types, got {T}")
    if L < 1:
        raise ValueError(f"separable_splat: grid size {L}")
    lead = tuple(coords.shape[:-2])
    n = coords.shape[-2]
    B = math.prod(lead)
    if not 1 <= B <= _MAX_ROWS:
        raise ValueError(f"separable_splat: the kernel takes 1 to "
                         f"{_MAX_ROWS} atom sets a call, got {B}")
    dev = coords.device
    coords = coords.reshape(B, n, 3).contiguous()
    trows, tper = _rows(types.to(torch.int32), lead, n)
    specs = [("coords", coords, (B, n, 3))]
    mrows, mper = None, 1
    if mask is not None:
        mrows, mper = _rows(mask.to(torch.float32), lead, n)
        specs.append(("mask", mrows, (B // mper, n)))
    _build.check_tensors("separable_splat", dev, torch.float32, specs)
    _build.check_tensors("separable_splat", dev, torch.int32,
                         [("types", trows, (B // tper, n))])
    Yb, Zb, Xb = splat_tile(L, T)
    tiles = (-(-L // Yb)) * (-(-L // Zb)) * (-(-L // Xb))
    f32 = np.float32
    out = torch.empty((B, L, L, L, T), dtype=torch.float32, device=dev)
    done = torch.empty((B * tiles,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().dlpd_separable_splat(
            coords.data_ptr(), trows.data_ptr(),
            None if mrows is None else mrows.data_ptr(), out.data_ptr(),
            done.data_ptr(), B, n, L, T, tper, mper, Yb, Zb, Xb,
            min(max(n, 1), _MAX_SEG), float(f32(-0.5 * L * resolution)),
            float(f32(1.0) / f32(resolution)), float(f32(resolution)),
            float(f32(1.0) / f32(2.0 * sigma * sigma)), _build.stream(out))
    _build.check(err, "separable_splat")
    launches += 1
    # Stored as [B, y, z, x, T]: the plain version's strides.
    return out.permute(0, 3, 1, 2, 4).reshape(lead + (L, L, L, T))
