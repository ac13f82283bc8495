"""The judge of a served docking request.

Given a request's inputs (the receptor and ligand as the benchmark made
them), the configuration, the weights file's arrays and the poses the
program served, the plain model (``model.py``) works out again the
score of every served pose, the scores over every translation of the
served rotations and of a sample of other rotations drawn from the
seed, the translation mask, the rotation set and the clustering, and
returns the numbers that decide ``correct``:

* ``score_err``: the widest gap between a served score and the plain
  model's score of the same pose, over the plain top score's size;
* ``missed``: scored rotations whose best pose beats the last served
  score by more than the score limit, with no served pose at least as
  good within the clustering radius of it (greedy NMS keeps every raw
  top-K pose or a better one within the radius); a served top pose
  that is not the best of the scored rotations counts here;
* ``pose_faults``: served poses that break a stated guarantee: the
  rotation is not the rotation set's, the translation not the shift's,
  the shift outside the mask, the scores not ranked, two poses closer
  than the clustering radius, or no pose at all.

``peak_gap`` (how far the plain best of the scored rotations lies above
the plain score of the served top pose, on the same scale) comes back
as a reading, not compared.  With ``control`` the same sample is also
scored by the plain model rounded to ``control`` (a dtype name) where
the program rounds to its own precision, and the control's
``score_err`` and ``peak_gap`` (the plain score of the control's top
pose) come back beside the program's.
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from reference import geometry, model

ROT_TOL, SHIFT_TOL, RMSD_SLACK = 1e-5, 1e-4, 1e-3


def _maps_best(H, reps, quant, cap, L):
    """Score maps of ``reps``, their masked best values and shifts."""
    S = model.score_maps(H, reps, quant)
    if cap is not None:
        i = torch.arange(L, device=S.device)
        s = torch.abs(torch.where(i <= L // 2, i, i - L))
        ok = torch.minimum(s, L - s) <= cap
        m = ok[:, None, None] & ok[None, :, None] & ok[None, None, :]
        S = torch.where(m, S, torch.tensor(float("-inf"), device=S.device,
                                           dtype=S.dtype))
    flat = S.reshape(S.shape[0], -1)
    best, arg = flat.max(dim=1)
    ix, iy, iz = arg // (L * L), (arg // L) % L, arg % L
    shift = np.stack([geometry.signed(v.cpu().numpy(), L)
                      for v in (ix, iy, iz)], -1)
    return S, best.cpu().numpy(), shift


def _atoms(xyz, types, bucket, device):
    """Typed atoms as float32 ``(coords, types, mask)`` padded with
    zero rows (type -1, mask 0) up to the configuration's atom bucket,
    as the configuration states the program holds them."""
    m = geometry.padded(len(xyz), bucket)
    c = np.zeros((m, 3), np.float32)
    c[:len(xyz)] = xyz
    t = np.full(m, -1, np.int64)
    t[:len(xyz)] = types
    mask = (t >= 0).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (c, t, mask))


def check_request(cfg: dict, flat_weights: dict, rec_xyz, rec_types,
                  lig_xyz, lig_types, poses: dict, *, n_sample: int,
                  rng: np.random.Generator, score_limit: float,
                  device, control: Optional[str] = None,
                  batch: int = 8) -> dict:
    """The numbers of one served request (see the module's docstring).
    ``poses``: the served arrays ``scores [K]``, ``rotations [K, 3, 3]``,
    ``translations [K, 3]``, ``rot_idx [K]``, ``shifts [K, 3]``."""
    L, res, sigma = cfg["grid_size"], cfg["resolution"], cfg["sigma"]
    T, n_rot = cfg["num_atom_types"], cfg["num_rotations"]
    W = model.Weights(flat_weights, device)
    rec = geometry.centered(rec_xyz)
    lig = geometry.centered(lig_xyz)
    rec_t, lig_t = np.asarray(rec_types), np.asarray(lig_types)
    recT, ligT = rec[rec_t >= 0], lig[lig_t >= 0]
    rf = geometry.receptive_field(cfg["rep_features"], cfg["rep_kernel"],
                                  cfg["shape_prior"])
    Ls = cfg["lig_grid_size"] or geometry.ligand_box(ligT, res, sigma, rf,
                                                     L)
    cap = geometry.wrap_cap(ligT, L, res, sigma)
    rots = geometry.super_fibonacci(n_rot)
    rots32 = geometry.super_fibonacci(n_rot, device)

    scores = np.asarray(poses["scores"], np.float64)
    K = len(scores)
    rot_idx = np.asarray(poses["rot_idx"], np.int64)
    shifts = np.asarray(poses["shifts"], np.int64)
    faults = []
    if K == 0:
        faults.append("no pose served")
    else:
        if not np.all(np.isfinite(scores)):
            faults.append("a served score is not finite")
        if np.any(np.diff(scores) > 0):
            faults.append("served scores not in descending order")
        if rot_idx.min() < 0 or rot_idx.max() >= n_rot:
            faults.append("rotation index outside the set")
            rot_idx = np.clip(rot_idx, 0, n_rot - 1)
        if np.abs(np.asarray(poses["rotations"]) - rots[rot_idx]).max() \
                > ROT_TOL:
            faults.append("a served rotation is not the set's")
        if np.abs(np.asarray(poses["translations"]) - shifts * res).max() \
                > SHIFT_TOL:
            faults.append("a served translation is not its shift")
        if not geometry.in_mask(shifts, cap, L).all():
            faults.append("a served shift lies outside the mask")
        D = geometry.pose_rmsd(lig, rots[rot_idx], shifts * res,
                               rots[rot_idx], shifts * res)
        close = D[np.triu_indices(K, 1)] < cfg["nms_rmsd"] - RMSD_SLACK
        if close.any():
            faults.append(f"{int(close.sum())} served pose pairs closer "
                          f"than the clustering radius")

    served_rots = np.unique(rot_idx)
    others = np.setdiff1d(np.arange(n_rot), served_rots)
    sample = rng.choice(others, size=min(n_sample, len(others)),
                        replace=False)
    todo = np.concatenate([served_rots, np.sort(sample)])
    quant_ctl = model.rounder(control)
    P_rec, P_lig = model.coupling_factors(W.coupling, cfg["coupling_rank"])
    P_lig32 = P_lig.to(torch.float32)

    bucket = cfg["atom_bucket"]
    rc, rt, rm = _atoms(recT, rec_t[rec_t >= 0], bucket, device)
    lc, lt, lm = _atoms(ligT, lig_t[lig_t >= 0], bucket, device)
    with model.exact_float32(), torch.no_grad():
        vol = model.splat(rc[None], rt, rm, L, res, sigma, T,
                          chunk=4096 if len(rc) > 4096 else None)
        H = model.receptor_spectrum(model.cnn(vol, W)[0], P_rec)
        H_ctl = None
        if control is not None:
            rep = model.cnn(vol, W, quant_ctl)[0]
            H_ctl = model.receptor_spectrum(quant_ctl(rep), P_rec)
            H_ctl = torch.complex(quant_ctl(H_ctl.real),
                                  quant_ctl(H_ctl.imag))
        del vol
        best = np.empty(len(todo))
        best_shift = np.empty((len(todo), 3), np.int64)
        ref_at = np.full(K, np.nan)
        ctl_at = np.full(K, np.nan)
        ctl_best = np.full(len(todo), -np.inf)
        ctl_best_ref = np.full(len(todo), np.nan)
        for b0 in range(0, len(todo), batch):
            ids = todo[b0:b0 + batch]
            R = rots32[torch.as_tensor(ids, device=device)]
            coords = torch.einsum("bij,nj->bni", R, lc)
            vols = model.splat(coords, lt, lm, Ls, res, sigma, T)
            S, bv, bs = _maps_best(H, model.cnn(vols, W, last=P_lig32),
                                   model.rounder(None), cap, L)
            best[b0:b0 + len(ids)] = bv
            best_shift[b0:b0 + len(ids)] = bs
            for j, r in enumerate(ids):
                for p in np.nonzero(rot_idx == r)[0]:
                    t = np.mod(shifts[p], L)
                    ref_at[p] = float(S[j, t[0], t[1], t[2]])
            if control is not None:
                Sc, cv, cs = _maps_best(
                    H_ctl, model.cnn(vols, W, quant_ctl, last=P_lig32),
                    quant_ctl, cap, L)
                ctl_best[b0:b0 + len(ids)] = cv
                for j, r in enumerate(ids):
                    t = np.mod(cs[j], L)
                    ctl_best_ref[b0 + j] = float(S[j, t[0], t[1], t[2]])
                    for p in np.nonzero(rot_idx == r)[0]:
                        t = np.mod(shifts[p], L)
                        ctl_at[p] = float(Sc[j, t[0], t[1], t[2]])
                del Sc
            del S, vols

    out = {"requests": 1, "pose_faults": len(faults), "faults": faults}
    if K == 0:
        out.update(score_err=float("inf"), peak_gap=float("inf"),
                   missed=len(todo))
        return out
    scale = max(float(np.abs(ref_at).max()), 1e-30)
    out["score_err"] = float(np.abs(scores - ref_at).max() / scale)
    out["peak_gap"] = float(max(best.max() - ref_at[0], 0.0) / scale)
    margin = score_limit * scale
    s_min = scores.min()
    missed = 0
    Rs, ts = rots[rot_idx], shifts * res
    for i, r in enumerate(todo):
        if best[i] <= s_min + margin:
            continue
        d = geometry.pose_rmsd(lig, rots[r][None], best_shift[i][None] * res,
                               Rs, ts)[0]
        ok = (scores >= best[i] - margin) & (d < cfg["nms_rmsd"]
                                             + RMSD_SLACK)
        missed += int(not ok.any())
    out["missed"] = missed
    if control is not None:
        out["control_score_err"] = float(np.abs(ctl_at - ref_at).max()
                                         / scale)
        top = int(np.argmax(ctl_best))
        out["control_peak_gap"] = float(
            max(best.max() - ctl_best_ref[top], 0.0) / scale)
    return out
