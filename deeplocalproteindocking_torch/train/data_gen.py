"""Training-batch assembly: complexes -> padded ``TrainBatch`` with decoys.

Port of ``deeplocalproteindocking_tpu/train/data_gen.py``: picks
complexes, centers receptor and ligand, snaps the native shift to the
voxel lattice, samples labelled decoy sets (``train/decoys.py``) and
pads atom counts so every row of a batch has one shape.  Every sample
is drawn on a CPU ``torch.Generator`` and the batch moves to the device
at the end, so one seed gives the same batch on the card and on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data.benchmark import (
    Complex, structure_to_device)
from deeplocalproteindocking_torch.structure.transforms import (
    random_rotations, rotate)
from deeplocalproteindocking_torch.sweep.resplat import auto_ligand_grid
from deeplocalproteindocking_torch.train.decoys import (
    DecoySet, generate_decoys, generate_global_decoys)
from deeplocalproteindocking_torch.train.scoring_path import train_lig_grid
from deeplocalproteindocking_torch.train.trainer import TrainBatch
from deeplocalproteindocking_torch.utils.profiling import span


def native_voxel_shift(cplx: Complex, resolution: float) -> np.ndarray:
    """Native ligand placement as an integer voxel shift."""
    t = (cplx.ligand.center - cplx.receptor.center) / resolution
    return np.round(t).astype(np.int32)


def fit_lig_grid(complexes: Sequence[Complex],
                 cfg: DockConfig) -> DockConfig:
    """Size the fixed training ligand box to the dataset's largest ligand
    (atoms + 3-sigma splat tails + CNN receptive field, never below
    ``grid_size // 2``); a no-op when ``cfg.lig_grid_size`` is set or
    the mode is not ``resplat``."""
    if cfg.lig_grid_size is not None or cfg.sweep_mode != "resplat":
        return cfg
    rf = len(cfg.rep_features) * (cfg.rep_kernel // 2) + 1
    ls = max(auto_ligand_grid(c.ligand.centered().coords, cfg.resolution,
                              cfg.sigma, rf, cfg.grid_size)
             for c in complexes)
    return cfg.replace(lig_grid_size=max(ls, cfg.grid_size // 2))


def _check_ligands_fit(complexes: Sequence[Complex],
                       cfg: DockConfig) -> None:
    """Every ligand's L2 radius + 3 sigma inside the training box's
    half-width: decoys and the augmentation rotate it inside the box."""
    half_box = 0.5 * train_lig_grid(cfg) * cfg.resolution
    for c in complexes:
        lig = c.ligand.centered()
        extent = float(np.linalg.norm(lig.coords, axis=1).max()
                       ) + 3.0 * cfg.sigma
        if extent > half_box:
            raise ValueError(
                f"ligand of {c.name} (extent {extent:.1f} A) exceeds the "
                f"training ligand box ({half_box:.1f} A half-width); raise "
                f"config.lig_grid_size or let data_gen.fit_lig_grid "
                f"size it from the dataset")


def make_training_batch(generator: torch.Generator,
                        complexes: Sequence[Complex],
                        cfg: DockConfig,
                        max_atoms: Optional[int] = None,
                        mined: Optional[Dict[str, DecoySet]] = None,
                        device: torch.device | str = "cuda"
                        ) -> TrainBatch:
    """Sample ``cfg.batch_complexes`` complexes and their decoy sets
    from the CPU ``generator``, as a ``TrainBatch`` on ``device``.

    Each complex's ``cfg.num_decoys`` decoys: local perturbations of the
    native pose (native first), ``cfg.decoy_global_frac`` of them global
    (full SO(3) x box-wide shifts) and, from the ``mined`` buffer
    (``{complex.name: DecoySet}``, ``train/mining.py``), up to
    ``cfg.mined_frac`` FFT-mined hard negatives.  With
    ``cfg.augment_rotations`` the whole complex (receptor, ligand, native
    shift, mined poses) turns by one random rotation, which keeps every
    label; ``decoy_shift`` is float32 because the turned mined shifts
    leave the lattice.
    """
    with span("train.batch", root=True):
        return _draw_batch(generator, complexes, cfg, max_atoms, mined,
                           device)


def _draw_batch(generator, complexes, cfg, max_atoms, mined, device):
    if max_atoms is None:
        max_atoms = max(max(len(c.receptor.typed()), len(c.ligand.typed()))
                        for c in complexes)
    if cfg.sweep_mode == "resplat":
        _check_ligands_fit(complexes, cfg)
    idx = torch.randint(0, len(complexes), (cfg.batch_complexes,),
                        generator=generator)
    rows = {f: [] for f in TrainBatch._fields}
    for i in idx.tolist():
        cplx = complexes[i]
        rc, rt, rm = structure_to_device(cplx.receptor.centered(), max_atoms)
        lc, lt, lm = structure_to_device(cplx.ligand.centered(), max_atoms)
        nat_f = (cplx.ligand.center - cplx.receptor.center) / cfg.resolution
        if cfg.augment_rotations:
            R0 = random_rotations(1, generator)[0]
            rc = rotate(rc, R0) * rm[:, None]
            lc = rotate(lc, R0) * lm[:, None]
            nat_f = R0.numpy() @ np.asarray(nat_f)
        nat = torch.as_tensor(np.round(nat_f).astype(np.int32))

        buf = (mined or {}).get(cplx.name)
        n_mined = (min(int(round(cfg.mined_frac * cfg.num_decoys)),
                       len(buf.lrmsd)) if buf is not None else 0)
        n_global = int(round(cfg.decoy_global_frac * cfg.num_decoys))
        n_local = max(1, cfg.num_decoys - n_global - n_mined)
        n_global = cfg.num_decoys - n_local - n_mined

        parts = [generate_decoys(
            generator, lc, lm, nat, n=n_local, resolution=cfg.resolution,
            max_angle=float(np.deg2rad(cfg.decoy_max_angle_deg)),
            max_shift=cfg.decoy_max_shift)]
        if n_global > 0:
            lig_half_vox = int(np.ceil(
                (float(lc.abs().max()) + 3.0 * cfg.sigma) / cfg.resolution))
            cap = max(1, cfg.grid_size // 2 - lig_half_vox - 1)
            parts.append(generate_global_decoys(
                generator, lc, lm, nat, n=n_global,
                resolution=cfg.resolution, max_shift_vox=cap))
        if n_mined > 0:
            pick = torch.randperm(len(buf.lrmsd), generator=generator)[
                :n_mined]
            mR, mS, mL = (a[pick].to(torch.float32) for a in buf)
            if cfg.augment_rotations:
                # Mined poses live in the canonical frame; x' = R0 x
                # turns them into R' = R0 R R0^T, s' = R0 s.
                mR = torch.einsum("ij,djk,lk->dil", R0, mR, R0)
                mS = torch.einsum("ij,dj->di", R0, mS)
            parts.append(DecoySet(mR, mS, mL))
        for f, v in zip(TrainBatch._fields,
                        (rc, rt, rm, lc, lt, lm,
                         torch.cat([p.rotations for p in parts]),
                         torch.cat([p.shifts.to(torch.float32)
                                    for p in parts]),
                         torch.cat([p.lrmsd for p in parts]))):
            rows[f].append(v)
    return TrainBatch(**{f: torch.stack(v).to(device)
                         for f, v in rows.items()})
