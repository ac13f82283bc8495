"""Overlap-save block-decomposed FFT correlation (the ``block`` engine).

Port of ``deeplocalproteindocking_tpu/correlate/blockfft.py``.  A
full-grid correlation holds ``[L, L, L//2+1, C]`` complex spectra per
rotation; above 128^3 the block engine computes the same score volume
without any L-sized transform:

* the translation grid is tiled into ``block^3`` blocks;
* for each block, an ``M = block + Ls`` receptor tile starting at
  ``t0 + (L - Ls)//2`` (indices taken mod L, which equals the JAX
  package's wrap padding for any pad length) is correlated against the
  ligand box at the origin of an M-box with M-point FFTs.  Every output
  ``d < block`` is alias-free because ``d + v < M`` for ``v < Ls``.

Blocks run one after another, so the peak is one tile's spectra, not
the grid's.  A tile's spectrum is shared by every ligand of the call
(the rotations of a sweep chunk) and each ligand's M-box spectrum by
every block.  M need not be a power of two (64 + 40 = 104); cuFFT takes
any size.  Every transform runs in float32, as the JAX package's
``jnp.fft.rfftn`` does (it takes no bf16).

``sharded_block_correlate`` splits the blocks over the ranks of a mesh
dimension by their first-axis start: each rank returns its slab of the
score volume, with no collective in the correlation.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _mixed_ligand(rep_lig_small: torch.Tensor,
                  coupling: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold the channel coupling into the ligand (linear, real space):
    ``lig~_e = sum_c A[e, c] lig_c``, in the ligand rep's dtype."""
    if coupling is None:
        return rep_lig_small
    return torch.einsum("...xyzc,ec->...xyze", rep_lig_small,
                        coupling.to(rep_lig_small.device,
                                    rep_lig_small.dtype))


def block_correlate_scores(rep_rec: torch.Tensor,
                           rep_lig_small: torch.Tensor,
                           coupling: Optional[torch.Tensor] = None,
                           *,
                           block: int = 32) -> torch.Tensor:
    """Score volumes of small ligand boxes, equal to ``correlate_scores``
    of each box centre-embedded in the grid, computed blockwise.

    ``rep_rec [L, L, L, C]``, or ``[G, L, L, L, C]`` one receptor per
    group of rows; ``rep_lig_small [Ls, Ls, Ls, C]`` (returns ``[L, L,
    L]``) or ``[B, Ls, Ls, Ls, C]`` with G dividing B, rows ``[g B/G,
    (g+1) B/G)`` against receptor g (returns ``[B, L, L, L]``).
    ``block`` must divide L.
    """
    return _block_scores(rep_rec, rep_lig_small, coupling, block, 0,
                         rep_rec.shape[-2])


def sharded_block_correlate(mesh, rep_rec: torch.Tensor,
                            rep_lig_small: torch.Tensor,
                            coupling: Optional[torch.Tensor] = None,
                            *,
                            block: int = 32,
                            axis: str = "rot") -> torch.Tensor:
    """:func:`block_correlate_scores` with the translation blocks split
    over ``mesh``'s dimension ``axis`` by their first-axis start.  Rank i
    of R computes the blocks whose x start lies in ``[i L/R, (i+1) L/R)``
    and returns that slab, ``[L/R, L, L]`` (``[B, L/R, L, L]`` for a
    batch of ligands); receptor and ligand are replicated and the
    correlation runs no collective.  ``(L // block) % R`` must be 0."""
    L = rep_rec.shape[-2]
    R = mesh.shape[mesh.mesh_dim_names.index(axis)]
    if (L // block) % R:
        raise ValueError(
            f"L/block={L // block} slabs must divide {R} devices")
    slab = L // R
    x_lo = mesh.get_local_rank(axis) * slab
    return _block_scores(rep_rec, rep_lig_small, coupling, block, x_lo,
                         x_lo + slab)


def _block_scores(rep_rec, rep_lig_small, coupling, block, x_lo, x_hi):
    """The blocks of :func:`block_correlate_scores` whose x start lies in
    ``[x_lo, x_hi)``: scores ``[..., x_hi - x_lo, L, L]``."""
    single = rep_lig_small.ndim == 4
    rec = rep_rec if rep_rec.ndim == 5 else rep_rec[None]
    lig = rep_lig_small[None] if single else rep_lig_small
    G, L, C = rec.shape[0], rec.shape[1], rec.shape[-1]
    nb_rows, Ls = lig.shape[0], lig.shape[1]
    if L % block:
        raise ValueError(f"block={block} must divide grid size {L}")
    if nb_rows % G:
        raise ValueError(f"{G} receptors do not divide {nb_rows} ligands")
    M = block + Ls
    off = (L - Ls) // 2
    b = nb_rows // G
    dims = (-3, -2, -1)

    # Every transform runs channels-first, over three contiguous axes:
    # cuFFT is several times slower with the rows or channels innermost.
    # Ligand at the ORIGIN of the M-box: corr[d] = sum_v tile[d+v] lig[v].
    lig = _mixed_ligand(lig, coupling).to(torch.float32)
    ligM = F.pad(lig, (0, 0) + (0, M - Ls) * 3).permute(0, 4, 1, 2, 3)
    F_lig = torch.fft.rfftn(ligM.contiguous(), dim=dims)   # [B, C, M^2 Mh]
    # [G, M, M, M//2+1, C, b]: the per-voxel channel contraction is a
    # batched [1, C] x [C, b] product on contiguous operands.
    F_lig_conj = torch.conj(F_lig).reshape(
        G, b, C, M, M, M // 2 + 1).permute(0, 3, 4, 5, 2, 1).contiguous()
    del F_lig

    rec = rec.permute(0, 4, 1, 2, 3)                      # [G, C, L, L, L]
    S = torch.empty((G, b, x_hi - x_lo, L, L), dtype=torch.float32,
                    device=rec.device)
    ar = torch.arange(M, device=rec.device)
    for x0 in range(x_lo, x_hi, block):
        slab_x = rec[:, :, (x0 + off + ar) % L]
        for y0 in range(0, L, block):
            slab_y = slab_x[:, :, :, (y0 + off + ar) % L]
            for z0 in range(0, L, block):
                tile = slab_y[..., (z0 + off + ar) % L]  # [G, C, M, M, M]
                F_tile = torch.fft.rfftn(
                    tile.to(torch.float32).contiguous(), dim=dims)
                prod = torch.matmul(
                    F_tile.permute(0, 2, 3, 4, 1).unsqueeze(-2), F_lig_conj)
                corr = torch.fft.irfftn(
                    prod.squeeze(-2).permute(0, 4, 1, 2, 3).contiguous(),
                    s=(M, M, M), dim=dims)               # [G, b, M, M, M]
                S[..., x0 - x_lo:x0 - x_lo + block, y0:y0 + block,
                  z0:z0 + block] = corr[..., :block, :block, :block]
    S = S.reshape(nb_rows, x_hi - x_lo, L, L)
    return S[0] if single else S
