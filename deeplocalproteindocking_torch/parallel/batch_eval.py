"""Batched multi-complex docking, on one card or over a ``(rot, batch)``
mesh.

Port of ``deeplocalproteindocking_tpu/parallel/batch_eval.py``, which
``jax.vmap``s the resplat sweep over a group of complexes padded to
common shapes.  Here the group is the complex-batched form of
:func:`~deeplocalproteindocking_torch.sweep.resplat.dock_sweep_resplat`:
one loop whose steps hold ``chunk`` rotations of every complex.  On the
``dft_fused`` engine each step is one K1 launch with one receptor
spectrum per complex and one K2 launch with one bias group per complex.

Over a mesh (``parallel/mesh.py``) each rank owns a (complex slice x
rotation slice) tile: the complexes split over ``batch`` (no
communication), each complex's rotations over ``rot`` as in
``parallel/sharded_sweep.py`` (the top-K merge), and the ``[B, K]`` rows
are gathered over ``batch`` so that every rank returns all of them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplocalproteindocking_torch.parallel.collectives import (
    all_gather_rows)
from deeplocalproteindocking_torch.parallel.sharded_sweep import (
    dim_size, merge_rot_shards, rotation_shard)
from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat
from deeplocalproteindocking_torch.sweep.topk import DockResult


def batch_slice(mesh, B: int) -> slice:
    """This rank's complexes of a group of ``B`` on the ``batch``
    dimension; ``B`` must divide by its size."""
    nb = dim_size(mesh, "batch")
    if B % nb:
        raise ValueError(f"dock_batch: {B} complexes do not divide over "
                         f"mesh batch={nb}")
    b = B // nb
    j = mesh.get_local_rank("batch")
    return slice(j * b, (j + 1) * b)


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
               fft_block: int = 32,
               fused_topk: Optional[bool] = None,
               mesh=None) -> DockResult:
    """Dock ``B`` complexes against one rotation set in one sweep.

    ``H_batch [B, L, L, L//2+1, C]`` coupled receptor spectra (under
    ``fft_impl="block"``: ``[B, L, L, L, C]`` real-space coupled receptor
    reps, one per complex);
    ``lig_coords [B, A, 3]``, ``lig_types [B, A]``, ``lig_mask [B, A]``
    padded ligands; ``rotations [R, 3, 3]``; ``score_mask [B, L, L, L]``
    optional per-complex translation masks (the wrap-around guard and
    the local-docking restriction, as in ``pipeline.dock``).  Returns a
    ``DockResult`` with leading ``[B, K]``.  Each sweep step holds
    ``B * chunk`` rows.  With a ``mesh`` B must divide by its ``batch``
    size; each rank sweeps its tile (:func:`dock_batch_shard`) and every
    rank returns all B rows.
    """
    if H_batch.ndim != 5 or lig_coords.ndim != 3:
        raise ValueError(f"dock_batch: H_batch [B, L, L, L', C] and "
                         f"lig_coords [B, A, 3], got {tuple(H_batch.shape)}"
                         f" and {tuple(lig_coords.shape)}")
    if rotations.ndim != 3:
        raise ValueError(f"dock_batch: rotations [R, 3, 3], got "
                         f"{tuple(rotations.shape)}")
    kw = dict(grid_size=grid_size, lig_grid=lig_grid,
              resolution=resolution, sigma=sigma, num_types=num_types,
              top_k=top_k, chunk=chunk, fft_impl=fft_impl,
              dft_dtype=dft_dtype, fft_block=fft_block,
              fused_topk=fused_topk)
    if mesh is None:
        return dock_sweep_resplat(
            H_batch, lig_coords, lig_types, lig_mask, rotations, rep_fn,
            score_mask=score_mask, **kw)
    own = batch_slice(mesh, H_batch.shape[0])
    return dock_batch_shard(
        mesh, H_batch[own], lig_coords[own], lig_types[own], lig_mask[own],
        rotations, rep_fn,
        score_mask=None if score_mask is None else score_mask[own], **kw)


def dock_batch_shard(mesh, H_local: torch.Tensor,
                     lig_coords: torch.Tensor, lig_types: torch.Tensor,
                     lig_mask: torch.Tensor, rotations: torch.Tensor,
                     rep_fn: Callable[[torch.Tensor], torch.Tensor], *,
                     top_k: int = 32, chunk: int = 8,
                     score_mask: Optional[torch.Tensor] = None,
                     **kw) -> DockResult:
    """The mesh branch of :func:`dock_batch` on this rank's complexes
    (``batch_slice``) only: ``H_local [b, ...]``, ligands ``[b, ...]``,
    ``score_mask`` None or ``[b, L, L, L]``.  Sweeps this rank's rotation
    slice of each, merges over ``rot``, gathers the rows over ``batch``:
    returns ``[b * mesh batch, K]`` on every rank."""
    local, base, valid = rotation_shard(mesh, rotations, chunk)
    res = dock_sweep_resplat(
        H_local, lig_coords, lig_types, lig_mask, local, rep_fn,
        top_k=top_k, chunk=chunk, score_mask=score_mask, num_valid=valid,
        **kw)
    res = merge_rot_shards(mesh, res, base, rotations.shape[0], top_k)
    group = mesh.get_group("batch")
    return DockResult(*(all_gather_rows(f, group) for f in res))
