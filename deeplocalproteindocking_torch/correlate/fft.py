"""Receptor spectrum, engine dispatch and shift indexing.

Port of ``deeplocalproteindocking_tpu/correlate/fft.py``.  The docking
score of a ligand at every integer translation is a circular
correlation,

    S(t) = irfftn( sum_d H_d . conj(F[lig]_d) ),  H_d = sum_c A[c,d] F[rec]_c

with the channel coupling ``A`` folded into the receptor spectrum ``H``
once per complex.  Correlation index ``i`` is the signed shift ``i`` if
``i <= L//2`` else ``i - L``.
"""
from __future__ import annotations

from typing import Optional

import torch

_FFT_DIMS = (-4, -3, -2)


def receptor_transform(rec_rep: torch.Tensor,
                       coupling: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Coupled receptor spectrum ``H [..., L, L, L//2+1, C']`` complex64.

    ``rec_rep [..., L, L, L, C]`` float32 (a leading axis: one receptor
    per complex of a batch); ``coupling [C, C']`` (None = identity).
    """
    F_rec = torch.fft.rfftn(rec_rep.to(torch.float32), dim=_FFT_DIMS)
    if coupling is None:
        return F_rec
    return torch.einsum("...xyzc,cd->...xyzd", F_rec,
                        coupling.to(F_rec.device, torch.complex64))


def resolve_engine(fft_impl: str, grid_size: int) -> str:
    """Concrete correlator engine: ``dft_fused`` above 128^3 resolves to
    the overlap-save ``block`` engine, as in the JAX package."""
    if fft_impl == "dft_fused" and grid_size > 128:
        return "block"
    return fft_impl


def coupled_receptor(rep_rec: torch.Tensor,
                     coupling: Optional[torch.Tensor],
                     fft_impl: str) -> torch.Tensor:
    """The receptor-side tensor ``H`` a spectral engine consumes."""
    if fft_impl == "block":
        raise NotImplementedError(
            "fft_impl='block' is not ported yet (dft_fused, dft, "
            "dft_pallas and xla are)")
    return receptor_transform(rep_rec, coupling)


def correlate_scores(H: torch.Tensor, lig_rep: torch.Tensor
                     ) -> torch.Tensor:
    """Score volumes ``[..., L, L, L]`` of full-grid ligand reps
    ``[..., L, L, L, C]`` against ``H`` (the ``xla`` engine).  ``H [G,
    L, L, L//2+1, C]`` holds one spectrum per group of rows: ``lig_rep
    [B, ...]`` with G dividing B, rows ``[g B/G, (g+1) B/G)`` against
    ``H[g]``."""
    L = lig_rep.shape[-2]
    F_lig = torch.fft.rfftn(lig_rep.to(torch.float32), dim=(-4, -3, -2))
    grouped = H.ndim == 5
    if grouped:
        F_lig = F_lig.reshape((H.shape[0], -1) + F_lig.shape[1:])
        H = H[:, None]
    G = torch.sum(H * torch.conj(F_lig), dim=-1)
    S = torch.fft.irfftn(G, s=(L, L, L), dim=(-3, -2, -1))
    return S.flatten(0, 1) if grouped else S


def flat_index_to_shift(flat: torch.Tensor, L: int) -> torch.Tensor:
    """Flat index over ``[L, L, L]`` -> signed shift ``[..., 3]`` int32."""
    flat = flat.long()
    iz = flat % L
    iy = (flat // L) % L
    ix = flat // (L * L)
    idx = torch.stack([ix, iy, iz], dim=-1)
    return torch.where(idx <= L // 2, idx, idx - L).to(torch.int32)


def shift_to_flat_index(shift: torch.Tensor, L: int) -> torch.Tensor:
    """Signed shift ``[..., 3]`` -> flat index over ``[L, L, L]``."""
    idx = torch.remainder(shift.long(), L)
    return (idx[..., 0] * L + idx[..., 1]) * L + idx[..., 2]


def translation_mask(L: int, max_shift: int,
                     center: Optional[torch.Tensor] = None,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """``[L, L, L]`` bool mask of shifts with ``|t_i - c_i| <= max_shift``
    (circular distance per axis); ``center`` is a signed shift ``[3]``."""
    i = torch.arange(L, device=device)
    signed = torch.where(i <= L // 2, i, i - L)
    if center is None:
        center = torch.zeros(3, dtype=signed.dtype, device=device)
    center = center.to(device=device, dtype=signed.dtype)
    d = torch.abs(signed[None, :] - center[:, None])
    d = torch.minimum(d, L - d)
    ok = d <= max_shift
    return (ok[0][:, None, None] & ok[1][None, :, None]
            & ok[2][None, None, :])
