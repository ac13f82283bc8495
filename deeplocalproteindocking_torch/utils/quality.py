"""CAPRI-style docking quality metrics: LRMSD, IRMSD, fnat, class.

Port of ``deeplocalproteindocking_tpu/utils/quality.py``.  The CAPRI
conventions:

* **LRMSD**: ligand RMSD after superposing the receptors (the receptor
  frame is shared, so a direct RMSD over ligand atoms);
* **IRMSD**: minimum RMSD over the native *interface* atoms (atoms of
  either partner within ``interface_cutoff`` of the other partner in the
  native complex), with optimal superposition of the interface;
* **fnat**: fraction of native residue-residue contacts (any heavy-atom
  pair within ``contact_cutoff``) recovered by the model pose;
* CAPRI class: high / medium / acceptable / incorrect.

The residue contact table and the interface masks come in a chunked form
for real protein sizes: receptor atoms are taken ``atom_chunk`` at a
time, so the atom-pair intermediate is ``[..., atom_chunk, N_lig]``,
never ``[N_rec, N_lig]`` per pose.  The ligand may carry leading (pose)
axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplocalproteindocking_torch.utils.rmsd import kabsch_rmsd, rmsd

CAPRI_CLASSES = ("incorrect", "acceptable", "medium", "high")


def ligand_rmsd(lig_pose: torch.Tensor, lig_native: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """LRMSD in the shared receptor frame (no superposition needed)."""
    return rmsd(lig_pose, lig_native, mask)


def _pair_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., A, B]`` squared distances of ``a [A, 3]`` and ``b [..., B,
    3]``, as differences (not the expanded dot-product form), so contact
    decisions at the cutoff round as the JAX package's do."""
    diff = a[:, None, :] - b[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def interface_masks(rec: torch.Tensor, lig_native: torch.Tensor,
                    cutoff: float = 10.0):
    """Boolean masks of native-interface atoms for receptor and ligand."""
    hit = _pair_sq_dists(rec, lig_native) < cutoff * cutoff
    return hit.any(dim=1), hit.any(dim=0)


def interface_rmsd(rec: torch.Tensor, lig_native: torch.Tensor,
                   lig_pose: torch.Tensor,
                   cutoff: float = 10.0) -> torch.Tensor:
    """IRMSD: Kabsch RMSD over native-interface atoms of the complex."""
    rec_if, lig_if = interface_masks(rec, lig_native, cutoff)
    native = torch.cat([rec, lig_native], dim=0)
    model = torch.cat([rec, lig_pose], dim=0)
    mask = torch.cat([rec_if, lig_if], dim=0).to(rec.dtype)
    return kabsch_rmsd(model, native, mask)


def fnat(rec: torch.Tensor, lig_native: torch.Tensor,
         lig_pose: torch.Tensor, rec_res: torch.Tensor,
         lig_res: torch.Tensor, cutoff: float = 5.0,
         num_rec_res: int | None = None,
         num_lig_res: int | None = None) -> torch.Tensor:
    """Fraction of native residue-residue contacts recovered by the pose.

    ``rec_res``/``lig_res`` are integer residue ids per atom; a residue
    pair is in contact when any heavy-atom pair is within ``cutoff``.
    The residue counts default to the largest id + 1.
    """
    n_rec = (num_rec_res if num_rec_res is not None
             else int(rec_res.max()) + 1)
    n_lig = (num_lig_res if num_lig_res is not None
             else int(lig_res.max()) + 1)
    kw = dict(num_rec_res=n_rec, num_lig_res=n_lig, cutoff=cutoff,
              atom_chunk=max(len(rec), 1))
    nat = residue_contact_table(rec, lig_native, rec_res, lig_res, **kw)
    mod = residue_contact_table(rec, lig_pose, rec_res, lig_res, **kw)
    n_nat = torch.clamp(nat.sum(), min=1)
    return (nat & mod).sum() / n_nat


def residue_contact_table(rec: torch.Tensor, lig: torch.Tensor,
                          rec_res: torch.Tensor, lig_res: torch.Tensor,
                          *, num_rec_res: int, num_lig_res: int,
                          cutoff: float = 5.0,
                          atom_chunk: int = 1024) -> torch.Tensor:
    """Residue-pair contact table ``bool [..., num_rec_res, num_lig_res]``.

    A residue pair is in contact when any heavy-atom pair is within
    ``cutoff``.  ``lig`` is ``[..., N_lig, 3]``; peak memory is
    O(atom_chunk * N_lig) per leading index, whatever N_rec.  Atom
    contacts reduce to residues through one-hot products, whose float32
    sums of 0/1 are exact counts.
    """
    c2 = cutoff * cutoff
    lig_hot = F.one_hot(lig_res.long(), num_lig_res).to(lig.dtype)
    counts = torch.zeros(lig.shape[:-2] + (num_rec_res, num_lig_res),
                         dtype=lig.dtype, device=lig.device)
    for a0 in range(0, rec.shape[0], atom_chunk):
        rc = rec[a0:a0 + atom_chunk]
        am = (_pair_sq_dists(rc, lig) < c2).to(lig.dtype)  # [..., A, N]
        rec_hot = F.one_hot(rec_res[a0:a0 + atom_chunk].long(),
                            num_rec_res).to(lig.dtype)     # [A, n_rec]
        counts += rec_hot.T @ (am @ lig_hot)
    return counts > 0


def interface_masks_chunked(rec: torch.Tensor, lig_native: torch.Tensor,
                            cutoff: float = 10.0, atom_chunk: int = 1024):
    """:func:`interface_masks` with O(atom_chunk * N_lig) peak memory."""
    c2 = cutoff * cutoff
    lig_any = torch.zeros(lig_native.shape[0], dtype=torch.bool,
                          device=lig_native.device)
    rec_parts = []
    for a0 in range(0, rec.shape[0], atom_chunk):
        hit = _pair_sq_dists(rec[a0:a0 + atom_chunk], lig_native) < c2
        lig_any |= hit.any(dim=0)
        rec_parts.append(hit.any(dim=1))
    return torch.cat(rec_parts), lig_any


def capri_class(fnat_v, lrmsd_v, irmsd_v) -> int:
    """CAPRI quality class index into ``CAPRI_CLASSES`` (host scalar)."""
    f, l, i = float(fnat_v), float(lrmsd_v), float(irmsd_v)
    if f >= 0.5 and (l <= 1.0 or i <= 1.0):
        return 3
    if f >= 0.3 and (l <= 5.0 or i <= 2.0):
        return 2
    if f >= 0.1 and (l <= 10.0 or i <= 4.0):
        return 1
    return 0
