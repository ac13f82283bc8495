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
takes ``exact_block_topk`` of it; the ``block`` engine (grids above
128^3) correlates each small-box rep against the real-space receptor
blockwise with ``torch.fft`` (``correlate/blockfft.py``) and takes
``exact_block_topk`` too.  The JAX ``lax.scan`` is a Python loop over
chunks whose top-K carry stays on the device: no per-chunk host
synchronization.  Padding rotations are
identities, masked out by ``num_valid``.  ``score_decoys_resplat`` is
training's differentiable form: the same model's scores of given poses.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from deeplocalproteindocking_torch.correlate.blockfft import (
    block_correlate_scores)
from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_torch.correlate.fft import (
    correlate_scores, flat_index_to_shift)
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.sweep.refine import continuous_score
from deeplocalproteindocking_torch.sweep.topk import (
    DockResult, exact_block_topk)
from deeplocalproteindocking_torch.utils.profiling import span

ENGINES = ("dft_fused", "dft", "dft_pallas", "xla", "block")

# The JAX package's warning for topk_impl="approx", word for word.  Off a
# TPU its ``jax.lax.approx_max_k`` returns the exact top-K, and so does
# the port.
APPROX_TOPK_WARNING = (
    "topk_impl='approx' trades per-rotation top-K set recall "
    "(measured 43/64 on near-tied shape scores, DESIGN.md) for "
    "~16% speed; top-1 is preserved but top-10 hit-rates can "
    "silently change. Use the default 'exact' for reported "
    "results.")


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
    """Score volumes ``[b, L, L, L]`` (``Ht`` one receptor spectrum, or
    one per group of rows) through K1 and the kz -> z einsum.

    Off the TPU the JAX package scores ``dft_fused`` through the einsum
    path of ``DFTCorrelator.scores``, which in bf16 rounds at other
    points than K1 (the ligand spectrum before the coupling, where K1
    rounds the coupled product).  So a bf16 sweep on the CPU takes that
    path, as the JAX package's CPU does, and the card K1, as its TPU
    does.  In float32 no cast rounds and both run K1's formulas."""
    corr = get_correlator(grid_size, lig_grid, dft_dtype, reps.device)
    if reps.device.type == "cpu" and corr.dtype != torch.float32:
        perm = (3, 2, 0, 1) if Ht[0].ndim == 4 else (0, 4, 3, 1, 2)
        Hre, Him = (h.permute(perm).to(torch.float32) for h in Ht)
        return corr.scores(Hre, Him, reps)
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


def _correlate_batch(H, reps, grid_size, fft_impl, dft_dtype,
                     fft_block=32):
    """Score volumes ``[B, L, L, L]`` for small-box reps (``dft``,
    ``dft_pallas``, ``xla`` or ``block`` engine); ``H`` one receptor
    spectrum (for ``block``: the real-space coupled receptor rep ``[L,
    L, L, C]``), or ``[G, ...]`` one per group of rows."""
    if fft_impl == "block":
        return block_correlate_scores(H, reps, None, block=fft_block)
    if fft_impl in ("dft", "dft_pallas"):
        corr = get_correlator(grid_size, reps.shape[-2], dft_dtype,
                              reps.device)
        inverse_impl = "pallas" if fft_impl == "dft_pallas" else "einsum"
        return corr.scores(H.real.to(torch.float32),
                           H.imag.to(torch.float32), reps,
                           inverse_impl=inverse_impl)
    if fft_impl == "xla":
        return correlate_scores(H, embed_small(reps, grid_size))
    raise ValueError(f"unknown fft_impl {fft_impl!r} (engines: {ENGINES})")


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
                       fft_block: int = 32,
                       fused_topk: Optional[bool] = None) -> DockResult:
    """Full rotation sweep with per-rotation coordinate re-splatting.

    ``H`` is the coupled receptor spectrum (``correlate/fft.py``) on the
    sweep's device, or under ``fft_impl="block"`` the real-space coupled
    receptor rep (``fft_block`` the translation-block edge); ``rep_fn``
    maps density volumes ``[B, Ls, Ls, Ls, T]`` to representations ``[B,
    Ls, Ls, Ls, C]``.  ``topk_impl="approx"`` warns as the JAX package
    does and takes the exact top-K (its ``approx_max_k`` is exact off a
    TPU); the fused top-K tail needs ``"exact"``.

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
        raise ValueError(f"unknown fft_impl {fft_impl!r} (engines: "
                         f"{ENGINES})")
    if topk_impl == "approx":
        warnings.warn(APPROX_TOPK_WARNING, stacklevel=2)
    elif topk_impl != "exact":
        raise ValueError(f"topk_impl={topk_impl!r}: 'exact' or 'approx'")
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

    def one_chunk(base, best, best_rot, best_flat):
        # The chunk's phases, each a span (utils/profiling.py): a
        # profiler range only while a profiler records, host time always.
        with span("sweep.rotate"):
            Rc = rotations[:, base:base + chunk]          # [n, chunk, 3, 3]
            if complexes:
                coords_r = torch.einsum("gbij,gnj->gbni", Rc, lig_coords)
                types, mask = lig_types[:, None], lig_mask[:, None]
            else:
                coords_r = torch.einsum("bij,nj->bni",
                                        Rc.reshape(n * chunk, 3, 3),
                                        lig_coords)
                types, mask = lig_types, lig_mask
        with span("sweep.splat"):
            vols = separable_splat(coords_r, types, mask,
                                   grid_size=lig_grid,
                                   resolution=resolution, sigma=sigma,
                                   num_types=num_types)
        with span("sweep.cnn"):
            reps = rep_fn(vols.reshape((n * chunk,) + vols.shape[-4:]))
        with span("sweep.correlate"):
            if fused:
                vals, flat = _fused_correlate_topk(
                    Ht, reps, L, lig_grid, dft_dtype, score_mask, top_k)
            else:
                if fft_impl == "dft_fused":
                    S = _correlate_fused(Ht, reps, L, lig_grid, dft_dtype)
                else:
                    S = _correlate_batch(H, reps, L, fft_impl, dft_dtype,
                                         fft_block)
                S = S.reshape(n, chunk, L * L * L)
                if score_mask is not None:
                    S = torch.where(score_mask.reshape(n, 1, -1), S,
                                    neg_inf)
                vals, flat = exact_block_topk(
                    S.reshape(n * chunk, L * L * L), top_k)
        with span("sweep.merge"):
            rot_ids = torch.arange(base, base + chunk, dtype=torch.int32,
                                   device=device)
            vals = torch.where((rot_ids < num_valid)[:, None],
                               vals.reshape(n, chunk, top_k), neg_inf)
            all_scores = torch.cat([best, vals.reshape(n, -1)], dim=1)
            all_rot = torch.cat([best_rot, rot_ids.repeat_interleave(
                top_k).expand(n, -1)], dim=1)
            all_flat = torch.cat([best_flat, flat.reshape(n, -1)], dim=1)
            best, sel = torch.topk(all_scores, top_k, dim=1)
            return (best, torch.gather(all_rot, 1, sel),
                    torch.gather(all_flat, 1, sel))

    best = torch.full((n, top_k), float("-inf"), device=device)
    best_rot = torch.zeros((n, top_k), dtype=torch.int32, device=device)
    best_flat = torch.zeros((n, top_k), dtype=torch.int64, device=device)
    with torch.inference_mode(), span("sweep"):
        for base in range(0, rotations.shape[1], chunk):
            with span("sweep.chunk"):
                best, best_rot, best_flat = one_chunk(base, best, best_rot,
                                                      best_flat)
    res = DockResult(scores=best, rot_idx=best_rot,
                     shifts=flat_index_to_shift(best_flat, L))
    return res if batched else DockResult(*(f[0] for f in res))


def score_decoys_resplat(H: torch.Tensor,
                         lig_coords: torch.Tensor,
                         lig_types: torch.Tensor,
                         lig_mask: torch.Tensor,
                         rotations: torch.Tensor,
                         shifts: torch.Tensor,
                         rep_fn: Callable[[torch.Tensor], torch.Tensor],
                         *,
                         grid_size: int,
                         lig_grid: int,
                         resolution: float,
                         sigma: float,
                         num_types: int,
                         fft_impl: str = "dft",
                         fft_block: int = 32) -> torch.Tensor:
    """Training path: differentiable scores ``[D]`` of the decoy poses
    ``(rotations [D, 3, 3], shifts [D, 3])``, by the sweep's own model
    (rotate coords -> splat -> CNN -> correlate), all D in one call.

    The ``dft*`` engines evaluate each pose's score by the shift theorem
    (``sweep/refine.continuous_score``: three phase contractions, no
    inverse transform, always float32; shifts may be off the lattice);
    ``xla`` forms the score volumes and gathers each pose's lattice cell
    (shifts rounded); ``block`` does the same one decoy at a time under
    ``torch.utils.checkpoint`` (``H`` the real-space coupled receptor
    rep), so reverse mode holds one decoy's score volume, as the JAX
    package's ``jax.checkpoint`` + ``lax.map`` do.
    """
    if fft_impl in ("dft", "dft_fused", "dft_pallas"):
        return continuous_score(
            H, lig_coords, lig_types, lig_mask, rotations,
            shifts.to(torch.float32), rep_fn, grid_size=grid_size,
            lig_grid=lig_grid, resolution=resolution, sigma=sigma,
            num_types=num_types)
    if fft_impl == "block":
        def score_one(R, s):
            coords_r = torch.einsum("ij,nj->ni", R, lig_coords)
            vol = separable_splat(coords_r, lig_types, lig_mask,
                                  grid_size=lig_grid, resolution=resolution,
                                  sigma=sigma, num_types=num_types)
            S = block_correlate_scores(H, rep_fn(vol[None])[0],
                                       block=fft_block)
            idx = torch.remainder(torch.round(s).long(), grid_size)
            return S[idx[0], idx[1], idx[2]]

        return torch.stack([
            torch.utils.checkpoint.checkpoint(score_one, R, s,
                                              use_reentrant=False)
            for R, s in zip(rotations, shifts)])
    if fft_impl != "xla":
        raise ValueError(f"score_decoys_resplat: unknown fft_impl "
                         f"{fft_impl!r}")
    coords_r = torch.einsum("dij,nj->dni", rotations, lig_coords)
    vols = separable_splat(coords_r, lig_types, lig_mask,
                           grid_size=lig_grid, resolution=resolution,
                           sigma=sigma, num_types=num_types)
    S = correlate_scores(H, embed_small(rep_fn(vols), grid_size))
    idx = torch.remainder(torch.round(shifts).long(), grid_size)
    return S[torch.arange(S.shape[0], device=S.device), idx[:, 0],
             idx[:, 1], idx[:, 2]]
