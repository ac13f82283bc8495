"""Rotation-sharded docking sweeps over the ``rot`` dimension of a mesh.

Port of ``deeplocalproteindocking_tpu/parallel/sharded_sweep.py``.  Each
rank sweeps a contiguous slice of the rotation set with the receptor
replicated, then the ranks' top-K candidate lists are gathered and merged
into one top-K that every rank returns: the only communication of a
sweep (K candidates per rank).  JAX's schedule is kept exactly:

* ``per_shard = ceil(n_rot / (R * chunk)) * chunk`` rotations per rank,
  the set padded with identities;
* rank r's rotations start at ``base = r * per_shard``; its sweep gets
  ``num_valid = clip(n_rot - base, 0, per_shard)``, so padding cannot
  crowd real candidates out of its top-K;
* ``rot_idx`` is rebased by ``base`` and every candidate at
  ``rot_idx >= n_rot`` scores -inf before the gather and the top-K.

The fused top-K tail (K1 then K2, no score volume) follows the port's
own rule, ``sweep/resplat.fused_topk_engaged`` (``fused_topk=None``):
on CUDA tensors every rank's ``dft_fused`` sweep launches K1 and K2 as a
single-card request does.  The JAX package pins ``fused_topk=False``
under ``shard_map`` as a guard against a fault of its TPU worker, "to be
lifted after a real multi-chip validation run"; that guard is TPU-only,
like ``FUSED_GRID_ALLOWLIST``, and the answer is the same exact top-K
either way.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplocalproteindocking_torch.parallel.collectives import merge_topk
from deeplocalproteindocking_torch.sweep.docker import dock_sweep
from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat
from deeplocalproteindocking_torch.sweep.topk import DockResult
from deeplocalproteindocking_torch.utils.profiling import span


def dim_size(mesh, name: str) -> int:
    """Ranks along mesh dimension ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def rotation_shard(mesh, rotations: torch.Tensor, chunk: int):
    """``(local rotations [per_shard, 3, 3], base, local_valid)``: this
    rank's slice of ``rotations [n_rot, 3, 3]`` on the ``rot`` dimension,
    padded with identities."""
    R = dim_size(mesh, "rot")
    n_rot = rotations.shape[0]
    per_shard = -(-n_rot // (R * chunk)) * chunk
    base = mesh.get_local_rank("rot") * per_shard
    local = rotations[base:base + per_shard]
    pad = per_shard - local.shape[0]
    if pad:
        eye = torch.eye(3, dtype=rotations.dtype, device=rotations.device)
        local = torch.cat([local, eye.expand(pad, 3, 3)])
    return local, base, min(max(n_rot - base, 0), per_shard)


def merge_rot_shards(mesh, res: DockResult, base: int, n_rot: int,
                     top_k: int) -> DockResult:
    """A rank's ``DockResult`` (``[K]`` or ``[b, K]``) rebased by ``base``,
    padding killed, merged over the ``rot`` dimension."""
    with span("parallel.merge"):
        rot_idx = res.rot_idx + base
        scores = torch.where(rot_idx < n_rot, res.scores, torch.tensor(
            float("-inf"), device=rot_idx.device))
        return DockResult(*merge_topk(scores, rot_idx, res.shifts,
                                      mesh.get_group("rot"), top_k))


def sharded_dock_sweep(mesh,
                       rec_rep: torch.Tensor,
                       lig_rep: torch.Tensor,
                       rotations: torch.Tensor,
                       coupling: Optional[torch.Tensor] = None,
                       *,
                       top_k: int = 32,
                       chunk: int = 8,
                       score_mask: Optional[torch.Tensor] = None
                       ) -> DockResult:
    """``sweep/docker.dock_sweep`` (the resample sweep) with rotations
    sharded over ``mesh``'s ``rot`` dimension.  Returns the merged
    top-K, the same on every rank, ``rot_idx`` into the unpadded set."""
    local, base, valid = rotation_shard(mesh, rotations, chunk)
    res = dock_sweep(rec_rep, lig_rep, local, coupling, top_k=top_k,
                     chunk=chunk, score_mask=score_mask, num_valid=valid)
    return merge_rot_shards(mesh, res, base, rotations.shape[0], top_k)


def sharded_dock_sweep_resplat(mesh,
                               H: torch.Tensor,
                               lig_coords: torch.Tensor,
                               lig_types: torch.Tensor,
                               lig_mask: torch.Tensor,
                               rotations: torch.Tensor,
                               rep_fn: Callable[[torch.Tensor],
                                                torch.Tensor],
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
                               topk_impl: str = "exact",
                               fft_block: int = 32) -> DockResult:
    """``sweep/resplat.dock_sweep_resplat`` with rotations sharded over
    ``mesh``'s ``rot`` dimension; the same communication as
    :func:`sharded_dock_sweep`."""
    local, base, valid = rotation_shard(mesh, rotations, chunk)
    res = dock_sweep_resplat(
        H, lig_coords, lig_types, lig_mask, local, rep_fn,
        grid_size=grid_size, lig_grid=lig_grid, resolution=resolution,
        sigma=sigma, num_types=num_types, top_k=top_k, chunk=chunk,
        score_mask=score_mask, num_valid=valid, fft_impl=fft_impl,
        dft_dtype=dft_dtype, topk_impl=topk_impl, fft_block=fft_block,
        fused_topk=None)
    return merge_rot_shards(mesh, res, base, rotations.shape[0], top_k)
