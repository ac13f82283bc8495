"""Resplat sweep: rotate ligand coordinates, re-splat, re-run the CNN.

Port of ``deeplocalproteindocking_tpu/sweep/resplat.py``.  Per chunk of
rotations:

    coords_R = R @ lig_coords                  exact rotation
    vol_R    = separable_splat(coords_R)       small ligand box Ls^3
    rep_R    = rep_fn(vol_R)                   CNN (or shape channels)
    D        = z-forward DFT, then K1          correlate/fused.py
    bmax     = K2                              correlate/invz_topk.py
    top-K    = drill_topk, streaming merge

on the ``dft_fused`` engine; the ``dft_pallas`` engine forms the score
volume with the forward DFT einsums and K3 (``correlate/idft.py``) and
takes ``exact_block_topk`` of it.  The JAX ``lax.scan`` is a Python loop over chunks whose top-K carry stays
on the device: no per-chunk host synchronization.  Padding rotations are
identities, masked out by ``num_valid``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_torch.correlate.fft import (
    correlate_scores, flat_index_to_shift)
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.sweep.topk import (
    DockResult, exact_block_topk)

ENGINES = ("dft_fused", "dft", "dft_pallas", "xla")


def fused_topk_engaged(fused_topk: Optional[bool], fft_impl: str,
                       topk_impl: str, L: int,
                       device: torch.device) -> bool:
    """The engage rule of the fused inverse-z + block-max top-K tail.

    Eligible: the ``dft_fused`` engine, exact top-K and ``L % 32 == 0``.
    ``fused_topk=None`` engages an eligible sweep on CUDA tensors;
    ``True`` engages any eligible sweep (on CPU tensors through the
    plain versions); ``False`` never engages.
    """
    eligible = (fft_impl == "dft_fused" and topk_impl == "exact"
                and L % 32 == 0)
    if fused_topk is None:
        return eligible and device.type == "cuda"
    return bool(fused_topk) and eligible


def auto_ligand_grid(lig_coords: np.ndarray, resolution: float,
                     sigma: float, receptive_field: int,
                     grid_size: int) -> int:
    """Smallest ligand box (multiple of 8, at least 16) covering atoms +
    splat tails + CNN receptive field, and the rotation-invariant L2
    radius.  The radius term omits the receptive field, exactly as the
    JAX package's does."""
    xyz = np.asarray(lig_coords)
    extent = 2.0 * (np.abs(xyz).max() + 3.0 * sigma)
    ls = int(np.ceil(extent / resolution)) + 2 * receptive_field
    radius = float(np.sqrt((xyz * xyz).sum(axis=1).max()))
    ls_contain = int(np.ceil(2.0 * (radius + 3.0 * sigma) / resolution))
    ls = min(grid_size, ((max(ls, ls_contain) + 7) // 8) * 8)
    return max(ls, 16)


def embed_small(rep_small: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Center a ``[..., Ls, Ls, Ls, C]`` rep in the ``grid_size`` box."""
    Ls = rep_small.shape[-2]
    off = (grid_size - Ls) // 2
    side = (off, grid_size - Ls - off)
    return F.pad(rep_small, (0, 0) + side * 3)


def _correlate_fused(Ht, reps, grid_size, lig_grid, dft_dtype):
    """Score volumes ``[b, L, L, L]`` via K1 and the kz -> z einsum
    (``Ht`` one receptor spectrum, or one per group of rows)."""
    corr = get_correlator(grid_size, lig_grid, dft_dtype, reps.device)
    return corr.scores_fused(Ht[0], Ht[1], reps)


def _fused_correlate_topk(Ht, reps, grid_size, lig_grid, dft_dtype,
                          score_mask, top_k):
    """Per-rotation ``(vals, flat)`` top-K without forming the score
    volume: K1, then K2, then the drill-down.  ``score_mask`` is None,
    ``[L, L, L]``, or ``[G, L, L, L]`` for G groups of consecutive rows
    (the heads of a head-batched sweep, the complexes of a batched one,
    whose G receptor spectra ``Ht`` carries)."""
    from deeplocalproteindocking_torch.correlate.invz_topk import (
        drill_topk, invz_blockmax)
    L = grid_size
    corr = get_correlator(L, lig_grid, dft_dtype, reps.device)
    Dre, Dim = corr.fused_D(Ht[0], Ht[1], reps)
    if score_mask is not None:
        bias = torch.where(score_mask, 0.0, float("-inf")).to(torch.float32)
        bias_flat = bias.reshape(-1, L * L * L)
    else:
        bias = torch.zeros((L, L, L), dtype=torch.float32,
                           device=reps.device)
        bias_flat = None
    bmax = invz_blockmax(Dre, Dim, corr.MzRe, corr.MzIm, bias)
    return drill_topk(Dre, Dim, corr.MzRe, corr.MzIm, bias_flat, bmax,
                      top_k)


def _correlate_batch(H, reps, grid_size, fft_impl, dft_dtype):
    """Score volumes ``[B, L, L, L]`` for small-box reps (``dft``,
    ``dft_pallas`` or ``xla`` engine); ``H`` one receptor spectrum, or
    ``[G, ...]`` one per group of rows."""
    if fft_impl in ("dft", "dft_pallas"):
        corr = get_correlator(grid_size, reps.shape[-2], dft_dtype,
                              reps.device)
        inverse_impl = "pallas" if fft_impl == "dft_pallas" else "einsum"
        return corr.scores(H.real.to(torch.float32),
                           H.imag.to(torch.float32), reps,
                           inverse_impl=inverse_impl)
    if fft_impl == "xla":
        return correlate_scores(H, embed_small(reps, grid_size))
    raise NotImplementedError(f"fft_impl={fft_impl!r} is not ported yet")


def dock_sweep_resplat(H: torch.Tensor,
                       lig_coords: torch.Tensor,
                       lig_types: torch.Tensor,
                       lig_mask: torch.Tensor,
                       rotations: torch.Tensor,
                       rep_fn: Callable[[torch.Tensor], torch.Tensor],
                       *,
                       grid_size: int,
                       lig_grid: int,
                       resolution: float,
                       sigma: float,
                       num_types: int,
                       top_k: int = 32,
                       chunk: int = 8,
                       score_mask: Optional[torch.Tensor] = None,
                       num_valid: Optional[int] = None,
                       fft_impl: str = "dft",
                       dft_dtype: str = "float32",
                       topk_impl: str = "exact",
                       fused_topk: Optional[bool] = None) -> DockResult:
    """Full rotation sweep with per-rotation coordinate re-splatting.

    ``H`` is the coupled receptor spectrum (``correlate/fft.py``) on the
    sweep's device; ``rep_fn`` maps density volumes ``[B, Ls, Ls, Ls, T]``
    to representations ``[B, Ls, Ls, Ls, C]``.

    Two batched forms (the JAX package vmaps this function instead),
    one loop whose steps hold ``chunk`` rotations of each of n sweeps,
    ``n * chunk`` rows; ``score_mask`` None or ``[n, L, L, L]`` gives
    each sweep its own mask; the result's fields gain a leading ``n``:

    - head-batched (``pipeline.rescore``): one receptor and ligand,
      ``rotations [n, R, 3, 3]``, n rotation sets;
    - complex-batched (``parallel.batch_eval.dock_batch``): ``H [n, L,
      L, L//2+1, C]``, ``lig_coords [n, A, 3]``, ``lig_types [n, A]``,
      ``lig_mask [n, A]``, one complex per sweep, ``rotations [R, 3,
      3]`` shared (or ``[n, R, 3, 3]``).  K1 takes the n spectra as
      receptor groups, K2 and ``drill_topk`` the n masks as bias groups.
    """
    if fft_impl not in ENGINES:
        raise NotImplementedError(
            f"fft_impl={fft_impl!r} is not ported yet (ported: {ENGINES})")
    if topk_impl != "exact":
        raise NotImplementedError(
            f"topk_impl={topk_impl!r} is not ported yet (exact is)")
    L = grid_size
    device = H.device
    complexes = lig_coords.ndim == 3        # one receptor + ligand per sweep
    if complexes and H.shape[0] != lig_coords.shape[0]:
        raise ValueError(f"dock_sweep_resplat: {H.shape[0]} receptor "
                         f"spectra for {lig_coords.shape[0]} ligands")
    batched = complexes or rotations.ndim == 4
    if complexes and rotations.ndim == 3:
        rotations = rotations.expand(H.shape[0], -1, -1, -1)
    if not batched:
        rotations = rotations[None]
        if score_mask is not None:
            score_mask = score_mask[None]
    n, n_rot = rotations.shape[:2]
    if num_valid is None:
        num_valid = n_rot
    rotations = rotations.to(device, torch.float32)
    Ht = None
    if fft_impl == "dft_fused":
        Ht = get_correlator(L, lig_grid, dft_dtype, device).prep_H(H)
    pad = (-n_rot) % chunk
    if pad:
        eye = torch.eye(3, dtype=rotations.dtype, device=device)
        rotations = torch.cat([rotations, eye.expand(n, pad, 3, 3)], dim=1)
    fused = fused_topk_engaged(fused_topk, fft_impl, topk_impl, L, device)
    neg_inf = torch.tensor(float("-inf"), device=device)

    best = torch.full((n, top_k), float("-inf"), device=device)
    best_rot = torch.zeros((n, top_k), dtype=torch.int32, device=device)
    best_flat = torch.zeros((n, top_k), dtype=torch.int64, device=device)
    with torch.inference_mode():
        for base in range(0, rotations.shape[1], chunk):
            Rc = rotations[:, base:base + chunk]          # [n, chunk, 3, 3]
            if complexes:
                coords_r = torch.einsum("gbij,gnj->gbni", Rc, lig_coords)
                types, mask = lig_types[:, None], lig_mask[:, None]
            else:
                coords_r = torch.einsum("bij,nj->bni",
                                        Rc.reshape(n * chunk, 3, 3),
                                        lig_coords)
                types, mask = lig_types, lig_mask
            vols = separable_splat(coords_r, types, mask,
                                   grid_size=lig_grid,
                                   resolution=resolution, sigma=sigma,
                                   num_types=num_types)
            reps = rep_fn(vols.reshape((n * chunk,) + vols.shape[-4:]))
            if fused:
                vals, flat = _fused_correlate_topk(
                    Ht, reps, L, lig_grid, dft_dtype, score_mask, top_k)
            else:
                if fft_impl == "dft_fused":
                    S = _correlate_fused(Ht, reps, L, lig_grid, dft_dtype)
                else:
                    S = _correlate_batch(H, reps, L, fft_impl, dft_dtype)
                S = S.reshape(n, chunk, L * L * L)
                if score_mask is not None:
                    S = torch.where(score_mask.reshape(n, 1, -1), S,
                                    neg_inf)
                vals, flat = exact_block_topk(
                    S.reshape(n * chunk, L * L * L), top_k)
            rot_ids = torch.arange(base, base + chunk, dtype=torch.int32,
                                   device=device)
            vals = torch.where((rot_ids < num_valid)[:, None],
                               vals.reshape(n, chunk, top_k), neg_inf)
            all_scores = torch.cat([best, vals.reshape(n, -1)], dim=1)
            all_rot = torch.cat([best_rot, rot_ids.repeat_interleave(
                top_k).expand(n, -1)], dim=1)
            all_flat = torch.cat([best_flat, flat.reshape(n, -1)], dim=1)
            best, sel = torch.topk(all_scores, top_k, dim=1)
            best_rot = torch.gather(all_rot, 1, sel)
            best_flat = torch.gather(all_flat, 1, sel)
    res = DockResult(scores=best, rot_idx=best_rot,
                     shifts=flat_index_to_shift(best_flat, L))
    return res if batched else DockResult(*(f[0] for f in res))
