"""Synthetic docked complexes and padded device tensors.

Port of the main-path part of ``deeplocalproteindocking_tpu/data/
benchmark.py``: the deterministic carved-blob generator (numpy, the same
draws from the same seed) and ``structure_to_device``.  The polymer
backbone generator (``backbone=True``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplocalproteindocking_torch.structure.atom_types import (
    assign_atom_types)
from deeplocalproteindocking_torch.structure.pdb import Structure

# Residues with their side-chain heavy atoms, used for synthesis.
_RES_ATOMS = {
    "ALA": ["CB"],
    "SER": ["CB", "OG"],
    "CYS": ["CB", "SG"],
    "VAL": ["CB", "CG1", "CG2"],
    "ASP": ["CB", "CG", "OD1", "OD2"],
    "ASN": ["CB", "CG", "OD1", "ND2"],
    "LEU": ["CB", "CG", "CD1", "CD2"],
    "LYS": ["CB", "CG", "CD", "CE", "NZ"],
    "PHE": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "ARG": ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "HIS": ["CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "TRP": ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3",
            "CH2"],
}


@dataclasses.dataclass
class Complex:
    """A receptor/ligand pair; ligand in its native (bound) pose."""
    name: str
    receptor: Structure
    ligand: Structure


def _random_chain(rng: np.random.Generator, n_res: int,
                  chain: str) -> Structure:
    """Compact globular mini-protein with valid PDB atom/residue names:
    residue centers packed into a ball by min-distance rejection."""
    res_pool = list(_RES_ATOMS)
    radius = 3.2 * n_res ** (1.0 / 3.0)
    centers = []
    while len(centers) < n_res:
        p = rng.uniform(-radius, radius, 3)
        if np.linalg.norm(p) > radius:
            continue
        if centers and np.linalg.norm(
                np.asarray(centers) - p, axis=1).min() < 4.6:
            continue
        centers.append(p)
    names, ress, rids, xyz = [], [], [], []
    for ri, ca in enumerate(centers):
        res = res_pool[rng.integers(len(res_pool))]
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        local = {
            "N": np.array([-1.45, 0.0, 0.0]),
            "CA": np.zeros(3),
            "C": np.array([1.52, 0.0, 0.0]),
            "O": np.array([2.10, 1.05, 0.0]),
        }
        for k, an in enumerate(_RES_ATOMS[res]):
            local[an] = np.array([0.0, 1.5 + 1.3 * (k // 2),
                                  1.3 * (k % 2)])
        for an, off in local.items():
            names.append(an)
            ress.append(res)
            rids.append(ri + 1)
            xyz.append(ca + q @ off)
    atom_names = np.asarray(names, dtype="<U4")
    res_names = np.asarray(ress, dtype="<U3")
    return Structure(
        coords=np.asarray(xyz, dtype=np.float32), atom_names=atom_names,
        res_names=res_names, res_ids=np.asarray(rids, dtype=np.int32),
        chain_ids=np.full(len(names), chain, dtype="<U1"),
        types=assign_atom_types(res_names, atom_names),
    )


def _deform(rng: np.random.Generator, s: Structure, rmsd: float,
            lengthscale: float = 8.0, n_modes: int = 4) -> Structure:
    """Smooth Gaussian-RBF displacement field with per-atom RMS ``rmsd``
    and no net translation (the unbound-conformer stand-in)."""
    if rmsd <= 0.0:
        return s
    c = s.coords.astype(np.float64)
    lo, hi = c.min(0), c.max(0)
    centers = rng.uniform(lo, hi, size=(n_modes, 3))
    amps = rng.normal(size=(n_modes, 3))
    d2 = ((c[:, None, :] - centers[None]) ** 2).sum(-1)
    disp = np.exp(-d2 / (2.0 * lengthscale ** 2)) @ amps
    disp -= disp.mean(0)
    rms = float(np.sqrt((disp ** 2).sum(1).mean()))
    disp *= rmsd / max(rms, 1e-9)
    return dataclasses.replace(s, coords=(c + disp).astype(np.float32))


def synthetic_complex(seed: int = 0, n_res_rec: int = 30,
                      n_res_lig: int = 15, unbound_rmsd: float = 0.0,
                      backbone: bool = False) -> Complex:
    """Deterministic synthetic docked complex: one globular blob carved
    into a receptor and the surface chunk of ``n_res_lig`` residues
    nearest the most protruding residue (the ligand).  The receptor is
    centered at the origin; the ligand keeps its native placement."""
    if backbone:
        raise NotImplementedError(
            "backbone=True (the polymer generator) is not ported yet")
    rng = np.random.default_rng(seed)
    whole = _random_chain(rng, n_res_rec + n_res_lig, "A")
    n_res = n_res_rec + n_res_lig
    res_centers = np.stack([
        whole.coords[whole.res_ids == i + 1].mean(0) for i in range(n_res)])
    depth = np.linalg.norm(res_centers - whole.coords.mean(0), axis=1)
    seed_res = int(np.argmax(depth))
    d_to_seed = np.linalg.norm(res_centers - res_centers[seed_res], axis=1)
    lig_res = set((np.argsort(d_to_seed)[:n_res_lig] + 1).tolist())
    lig_mask = np.isin(whole.res_ids, list(lig_res))
    rec = whole.select(~lig_mask)
    lig = whole.select(lig_mask)
    lig.chain_ids = np.full(len(lig), "B", dtype="<U1")
    shift = rec.coords.mean(0)
    rec.coords = rec.coords - shift
    lig.coords = lig.coords - shift
    if unbound_rmsd > 0.0:
        rec = _deform(rng, rec, unbound_rmsd)
        lig = _deform(rng, lig, unbound_rmsd)
    return Complex(name=f"synth{seed}", receptor=rec, ligand=lig)


def structure_to_device(s: Structure, max_atoms: Optional[int] = None,
                        bucket: Optional[int] = None,
                        device: torch.device | str = "cpu"):
    """Pad to ``max_atoms`` (or up to a multiple of ``bucket``) and
    return ``(coords [M, 3] f32, types [M] int32, mask [M] f32)`` on
    ``device``.  Padding rows have type -1 and mask 0."""
    s = s.typed()
    n = len(s)
    m = max_atoms or n
    if max_atoms is None and bucket:
        m = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    if n > m:
        raise ValueError(f"structure has {n} atoms > max_atoms={m}")
    coords = np.zeros((m, 3), dtype=np.float32)
    types = np.full((m,), -1, dtype=np.int32)
    mask = np.zeros((m,), dtype=np.float32)
    coords[:n] = s.coords
    types[:n] = s.types
    mask[:n] = 1.0
    return (torch.as_tensor(coords, device=device),
            torch.as_tensor(types, device=device),
            torch.as_tensor(mask, device=device))
