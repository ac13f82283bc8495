"""Batched multi-complex docking on one card.

Port of the unsharded (``mesh=None``) branch of
``deeplocalproteindocking_tpu/parallel/batch_eval.py``, which ``jax.vmap``s
the resplat sweep over a group of complexes padded to common shapes.
Here the group is the complex-batched form of
:func:`~deeplocalproteindocking_torch.sweep.resplat.dock_sweep_resplat`:
one loop whose steps hold ``chunk`` rotations of every complex.  On the
``dft_fused`` engine each step is one K1 launch with one receptor
spectrum per complex and one K2 launch with one bias group per complex.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat
from deeplocalproteindocking_torch.sweep.topk import DockResult


def dock_batch(H_batch: torch.Tensor,
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
               fft_impl: str = "dft",
               dft_dtype: str = "float32",
               fused_topk: Optional[bool] = None) -> DockResult:
    """Dock ``B`` complexes against one rotation set in one sweep.

    ``H_batch [B, L, L, L//2+1, C]`` coupled receptor spectra;
    ``lig_coords [B, A, 3]``, ``lig_types [B, A]``, ``lig_mask [B, A]``
    padded ligands; ``rotations [R, 3, 3]``; ``score_mask [B, L, L, L]``
    optional per-complex translation masks (the wrap-around guard and
    the local-docking restriction, as in ``pipeline.dock``).  Returns a
    ``DockResult`` with leading ``[B, K]``.  Each sweep step holds
    ``B * chunk`` rows.
    """
    if H_batch.ndim != 5 or lig_coords.ndim != 3:
        raise ValueError(f"dock_batch: H_batch [B, L, L, L//2+1, C] and "
                         f"lig_coords [B, A, 3], got {tuple(H_batch.shape)}"
                         f" and {tuple(lig_coords.shape)}")
    if rotations.ndim != 3:
        raise ValueError(f"dock_batch: rotations [R, 3, 3], got "
                         f"{tuple(rotations.shape)}")
    return dock_sweep_resplat(
        H_batch, lig_coords, lig_types, lig_mask, rotations, rep_fn,
        grid_size=grid_size, lig_grid=lig_grid, resolution=resolution,
        sigma=sigma, num_types=num_types, top_k=top_k, chunk=chunk,
        score_mask=score_mask, fft_impl=fft_impl, dft_dtype=dft_dtype,
        fused_topk=fused_topk)
