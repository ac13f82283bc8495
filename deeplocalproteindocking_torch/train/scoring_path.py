"""Decoy-scoring forward pass for training.

Port of ``deeplocalproteindocking_tpu/train/scoring_path.py``: training
scores poses with exactly the model definition the docking sweep uses,
in ``resplat`` mode (rotate atom coords, splat the ligand box, CNN,
correlate; ``sweep/resplat.score_decoys_resplat``), with gradients
through the voxelizer, the CNN and the coupling.  The ``resample`` mode
(rotate the ligand representation volume) needs ``grids/rotate``, which
is not ported.
"""
from __future__ import annotations

import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.fft import (
    coupled_receptor, resolve_engine)
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.models.scoring import ScoringModel
from deeplocalproteindocking_torch.sweep.resplat import score_decoys_resplat


def train_lig_grid(cfg: DockConfig) -> int:
    """The fixed training ligand box (``data_gen`` checks ligands fit)."""
    return cfg.lig_grid_size or max(16, cfg.grid_size // 2)


def complex_scores(model: ScoringModel, cfg: DockConfig,
                   rec_c: torch.Tensor, rec_t: torch.Tensor,
                   rec_m: torch.Tensor, lig_c: torch.Tensor,
                   lig_t: torch.Tensor, lig_m: torch.Tensor,
                   d_rot: torch.Tensor, d_shift: torch.Tensor
                   ) -> torch.Tensor:
    """Scores ``[D]`` of one complex's decoy set under ``model``'s
    parameters, differentiable in them."""
    if cfg.sweep_mode != "resplat":
        raise NotImplementedError(
            f"sweep_mode={cfg.sweep_mode!r} needs grids/rotate, which is "
            f"not ported yet (ROADMAP Queue A 5)")
    rec_vol = separable_splat(
        rec_c, rec_t, rec_m, grid_size=cfg.grid_size,
        resolution=cfg.resolution, sigma=cfg.sigma,
        num_types=cfg.num_atom_types,
        atom_chunk=4096 if rec_c.shape[0] > 4096 else None)
    impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
    H = coupled_receptor(model.represent(rec_vol), model.coupling, impl)
    return score_decoys_resplat(
        H, lig_c, lig_t, lig_m, d_rot, d_shift, model.represent,
        grid_size=cfg.grid_size, lig_grid=train_lig_grid(cfg),
        resolution=cfg.resolution, sigma=cfg.sigma,
        num_types=cfg.num_atom_types, fft_impl=impl)
