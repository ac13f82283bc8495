"""The resample sweep: rotate the ligand representation, correlate.

Port of ``deeplocalproteindocking_tpu/sweep/docker.py`` (the
``sweep_mode="resample"`` path, the reference's own formulation): for
each chunk of rotations, rotate the full-grid ligand representation by
trilinear resampling (``grids/rotate.py``), correlate it against the
coupled receptor spectrum over every translation (``torch.fft``,
``correlate/fft.correlate_scores``), take each rotation's top-K and
merge it into a streaming top-K kept on the device.  The receptor
spectrum is computed once, before the loop.  No hand-written kernel
runs on this path.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplocalproteindocking_torch.correlate.fft import (
    correlate_scores, flat_index_to_shift, receptor_transform)
from deeplocalproteindocking_torch.grids.rotate import rotate_volumes
from deeplocalproteindocking_torch.sweep.topk import DockResult

__all__ = ["DockResult", "dock_sweep"]


def dock_sweep(rec_rep: torch.Tensor,
               lig_rep: torch.Tensor,
               rotations: torch.Tensor,
               coupling: Optional[torch.Tensor] = None,
               *,
               top_k: int = 32,
               chunk: int = 8,
               score_mask: Optional[torch.Tensor] = None,
               num_valid: Optional[int] = None) -> DockResult:
    """Sweep ``rotations [R, 3, 3]`` over all translations.

    ``rec_rep``/``lig_rep`` are ``[L, L, L, C]`` representation volumes
    on the sweep's device; ``score_mask`` (optional ``[L, L, L]`` bool)
    restricts the valid translations.  Rotations are padded to a
    multiple of ``chunk`` with identities; those and every rotation at
    index >= ``num_valid`` score -inf.
    """
    L = rec_rep.shape[0]
    device = rec_rep.device
    n_rot = rotations.shape[0]
    if num_valid is None:
        num_valid = n_rot
    rotations = rotations.to(device, torch.float32)
    with torch.inference_mode():
        H = receptor_transform(rec_rep, coupling)
        pad = (-n_rot) % chunk
        if pad:
            eye = torch.eye(3, dtype=rotations.dtype, device=device)
            rotations = torch.cat([rotations, eye.expand(pad, 3, 3)])
        neg_inf = torch.tensor(float("-inf"), device=device)
        best = torch.full((top_k,), float("-inf"), device=device)
        best_rot = torch.zeros((top_k,), dtype=torch.int32, device=device)
        best_flat = torch.zeros((top_k,), dtype=torch.int64, device=device)
        for base in range(0, rotations.shape[0], chunk):
            lig_rots = rotate_volumes(lig_rep,
                                      rotations[base:base + chunk])
            S = correlate_scores(H, lig_rots)           # [chunk, L, L, L]
            if score_mask is not None:
                S = torch.where(score_mask[None], S, neg_inf)
            vals, flat = torch.topk(S.reshape(chunk, L * L * L), top_k)
            rot_ids = torch.arange(base, base + chunk, dtype=torch.int32,
                                   device=device)
            vals = torch.where((rot_ids < num_valid)[:, None], vals,
                               neg_inf)
            all_scores = torch.cat([best, vals.reshape(-1)])
            all_rot = torch.cat([best_rot, rot_ids.repeat_interleave(top_k)])
            all_flat = torch.cat([best_flat, flat.reshape(-1)])
            best, sel = torch.topk(all_scores, top_k)
            best_rot, best_flat = all_rot[sel], all_flat[sel]
    return DockResult(scores=best, rot_idx=best_rot,
                      shifts=flat_index_to_shift(best_flat, L))
