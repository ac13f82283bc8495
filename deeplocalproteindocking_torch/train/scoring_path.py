"""Decoy-scoring forward pass for training.

Port of ``deeplocalproteindocking_tpu/train/scoring_path.py``: training
scores poses with exactly the model definition the docking sweep uses,
dispatching on ``config.sweep_mode``:

* ``resplat``: rotate atom coords, splat the ligand box, CNN, correlate
  (``sweep/resplat.score_decoys_resplat``), with gradients through the
  voxelizer, the CNN and the coupling;
* ``resample``: the full-grid model on both sides, then per decoy the
  ligand representation rotated by resampling (``grids/rotate``) and
  scored at its shift (``correlate/fft.score_at``), one decoy at a time
  under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
  + ``lax.map``).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.fft import (
    coupled_receptor, receptor_transform, resolve_engine, score_at)
from deeplocalproteindocking_torch.grids.rotate import rotate_volume
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
    kw = dict(grid_size=cfg.grid_size, resolution=cfg.resolution,
              sigma=cfg.sigma, num_types=cfg.num_atom_types,
              atom_chunk=4096 if rec_c.shape[0] > 4096 else None)
    rec_vol = separable_splat(rec_c, rec_t, rec_m, **kw)
    if cfg.sweep_mode == "resplat":
        impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
        H = coupled_receptor(model.represent(rec_vol), model.coupling, impl)
        return score_decoys_resplat(
            H, lig_c, lig_t, lig_m, d_rot, d_shift, model.represent,
            grid_size=cfg.grid_size, lig_grid=train_lig_grid(cfg),
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types, fft_impl=impl,
            fft_block=cfg.fft_block)
    lig_vol = separable_splat(lig_c, lig_t, lig_m, **kw)
    rep_rec, rep_lig, coupling = model(rec_vol, lig_vol)
    H = receptor_transform(rep_rec, coupling)

    def score_one(R, s):
        return score_at(H, rotate_volume(rep_lig, R), s[None])[0]

    return torch.stack([
        torch.utils.checkpoint.checkpoint(score_one, R, s,
                                          use_reentrant=False)
        for R, s in zip(d_rot, d_shift)])
