"""Continuous rigid-body pose refinement by gradient ascent.

Port of ``deeplocalproteindocking_tpu/sweep/refine.py``.  The sweep's
poses sit on the voxel lattice and the rotation set's covering radius;
this module ascends the score in continuous pose space, in an axis-angle
rotation perturbation and a sub-voxel translation:

* rotation gradients flow through the differentiable splat -> CNN ->
  ligand spectrum;
* the translation never touches a grid: by the shift theorem
  ``S(t) = sum_k G[k] exp(+2 pi i k.t / L)`` with ``G = sum_c H_c
  conj(F_c)``, evaluated for continuous t by three phase contractions
  (Hermitian-folded along z), with no inverse transform.

Poses are a batch axis (the JAX package vmaps one pose); every pose's
score depends only on its own parameters, so the gradient of the summed
score is each pose's own gradient.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.structure.transforms import (
    axis_angle_to_matrix)

# optax.adam's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class RefineResult(NamedTuple):
    rotations: torch.Tensor      # [K, 3, 3] refined
    translations: torch.Tensor   # [K, 3] Angstrom, refined (continuous)
    scores: torch.Tensor         # [K] refined scores
    initial_scores: torch.Tensor


def _phase_vectors(t_vox: torch.Tensor, L: int):
    """Per-axis (re, im) of ``exp(+2 pi i k t / L)`` for continuous
    ``t_vox [..., 3]``; each vector ``[..., L]`` (z: ``[..., L//2+1]``,
    Hermitian-weighted).

    Frequencies are signed (index k > L/2 means k - L), as non-integer
    shifts require; the Nyquist bin takes the real
    trigonometric-interpolation value ``cos(pi t)``.
    """
    dev = t_vox.device
    k = torch.arange(L, dtype=torch.float32, device=dev)
    kf = torch.where(k <= L // 2, k, k - L)
    kh = torch.arange(L // 2 + 1, dtype=torch.float32, device=dev)
    nyq = torch.arange(L, device=dev) == L // 2

    def full_axis(t):
        ang = 2.0 * math.pi * kf * t[..., None] / L
        re = torch.where(nyq, torch.cos(math.pi * t)[..., None],
                         torch.cos(ang))
        im = torch.where(nyq, 0.0, torch.sin(ang))
        return re, im

    px = full_axis(t_vox[..., 0])
    py = full_axis(t_vox[..., 1])
    tz = t_vox[..., 2]
    az = 2.0 * math.pi * kh * tz[..., None] / L
    w = torch.full((L // 2 + 1,), 2.0, device=dev)
    w[0] = 1.0
    w[-1] = 1.0
    last = torch.arange(L // 2 + 1, device=dev) == L // 2
    pzr = torch.where(last, torch.cos(math.pi * tz)[..., None],
                      w * torch.cos(az))
    pzi = torch.where(last, 0.0, w * torch.sin(az))
    return px, py, (pzr, pzi)


def continuous_score(H: torch.Tensor,
                     lig_coords: torch.Tensor,
                     lig_types: torch.Tensor,
                     lig_mask: torch.Tensor,
                     R: torch.Tensor,
                     t_vox: torch.Tensor,
                     rep_fn: Callable,
                     *,
                     grid_size: int,
                     lig_grid: int,
                     resolution: float,
                     sigma: float,
                     num_types: int) -> torch.Tensor:
    """Scores ``[K]`` of continuous poses ``R [K, 3, 3]``, ``t_vox [K, 3]``
    (voxel units) against the complex coupled spectrum ``H [L, L,
    L//2+1, C]``; differentiable in ``R`` and ``t_vox``.  Always on the
    float32 correlator."""
    L = grid_size
    coords_r = torch.einsum("kij,nj->kni", R, lig_coords)
    vol = separable_splat(coords_r, lig_types, lig_mask,
                          grid_size=lig_grid, resolution=resolution,
                          sigma=sigma, num_types=num_types)
    rep = rep_fn(vol)
    corr = get_correlator(L, lig_grid, "float32", rep.device)
    fre, fim = corr.ligand_spectrum(rep)           # [K, L, L, L/2+1, C]
    Hre, Him = H.real.to(torch.float32), H.imag.to(torch.float32)
    gre = (torch.einsum("ijkc,bijkc->bijk", Hre, fre)
           + torch.einsum("ijkc,bijkc->bijk", Him, fim))
    gim = (torch.einsum("ijkc,bijkc->bijk", Him, fre)
           - torch.einsum("ijkc,bijkc->bijk", Hre, fim))
    (pxr, pxi), (pyr, pyi), (pzr, pzi) = _phase_vectors(t_vox, L)
    # Contract z (Hermitian-weighted), then y, then x; keep (re, im).
    are = (torch.einsum("bijk,bk->bij", gre, pzr)
           - torch.einsum("bijk,bk->bij", gim, pzi))
    aim = (torch.einsum("bijk,bk->bij", gre, pzi)
           + torch.einsum("bijk,bk->bij", gim, pzr))
    bre = (torch.einsum("bij,bj->bi", are, pyr)
           - torch.einsum("bij,bj->bi", aim, pyi))
    bim = (torch.einsum("bij,bj->bi", are, pyi)
           + torch.einsum("bij,bj->bi", aim, pyr))
    s = (torch.einsum("bi,bi->b", bre, pxr)
         - torch.einsum("bi,bi->b", bim, pxi))
    return s / (L ** 3)


def continuous_score_block(*args, **kwargs):
    """The block engine's real-space continuous score: not ported yet
    (it needs the ``block`` engine)."""
    raise NotImplementedError(
        "continuous_score_block needs fft_impl='block', which is not "
        "ported yet")


def _rotation(w: torch.Tensor, R0: torch.Tensor) -> torch.Tensor:
    """``exp([w]x) @ R0`` with the JAX package's ``+1e-12`` guard on the
    axis-angle vector (its norm is never 0)."""
    w = w + 1e-12
    return axis_angle_to_matrix(w, torch.linalg.norm(w, dim=-1)) @ R0


def refine_poses(H: torch.Tensor,
                 lig_coords: torch.Tensor,
                 lig_types: torch.Tensor,
                 lig_mask: torch.Tensor,
                 rotations: torch.Tensor,
                 shifts: torch.Tensor,
                 rep_fn: Callable,
                 *,
                 grid_size: int,
                 lig_grid: int,
                 resolution: float,
                 sigma: float,
                 num_types: int,
                 steps: int = 30,
                 lr: float = 0.02,
                 fft_impl: str = "dft") -> RefineResult:
    """Refine K poses ``(rotations [K, 3, 3], shifts [K, 3] voxels)``.

    Adam ascent (optax's defaults, bias-corrected) on the axis-angle
    delta and the sub-voxel translation delta of every pose at once; a
    pose keeps its refinement only if it improved the score.  Returns
    continuous translations in Angstrom.
    """
    score_fn = (continuous_score_block if fft_impl == "block"
                else continuous_score)
    kw = dict(grid_size=grid_size, lig_grid=lig_grid,
              resolution=resolution, sigma=sigma, num_types=num_types)
    R0 = rotations.to(torch.float32)
    t0 = shifts.to(torch.float32)

    def score(w, dt):
        return score_fn(H, lig_coords, lig_types, lig_mask,
                        _rotation(w, R0), t0 + dt, rep_fn, **kw)

    params = [torch.zeros_like(t0), torch.zeros_like(t0)]     # w, dt
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    with torch.no_grad():
        s0 = score(*params)
    for step in range(1, steps + 1):
        ps = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = -score(*ps).sum()
            grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = _B1 * m[i] + (1.0 - _B1) * g
                v[i] = _B2 * v[i] + (1.0 - _B2) * g * g
                m_hat = m[i] / (1.0 - _B1 ** step)
                v_hat = v[i] / (1.0 - _B2 ** step)
                params[i] = params[i] - lr * m_hat / (torch.sqrt(v_hat)
                                                      + _EPS)
    with torch.no_grad():
        s1 = score(*params)
        better = (s1 > s0)[:, None]
        w = torch.where(better, params[0], 0.0)
        dt = torch.where(better, params[1], 0.0)
        R = _rotation(w, R0)
    return RefineResult(rotations=R, translations=(t0 + dt) * resolution,
                        scores=torch.maximum(s0, s1), initial_scores=s0)
