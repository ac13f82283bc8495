"""The judge of a training cell's first steps.

The plain model (``model.py``) follows the program's first steps from
the same weights on the same batches (the poses, labels and padded
atoms the benchmark's seeded feed drew, taken as inputs): each decoy's
score by the correlation's spectrum at its continuous shift, the
pairwise ranking hinge per complex and its mean over the batch, the
gradients by autograd, and AdamW as optax composes it (Adam's moments,
decoupled weight decay, the cosine rate at the update count before the
step).  It compares

* ``loss_gap``: each step's loss, the widest relative gap;
* ``grad_gap``: the norm of the first gradient per leaf, as the program's
  optimizer holds it after one step (its first moment over 1 - b1);
* ``update_gap``: the norm of each leaf's change over the steps;

both by the worst leaf: the gap between the two norms over the larger
of the reference leaf's norm and the median leaf's; and

* ``grad_diff``: the first gradient compared element by element: the
  norm of each leaf's difference from the reference over the same
  denominator, the median leaf's.  A norm averages rounding away; the
  difference keeps it, so this separates the configuration's TF32
  convolutions from a bfloat16 run.  The median leaf, because the
  smallest leaf (the 16 x 16 coupling) reads a few seeds' ill-conditioned
  gradients several times higher in every precision.

Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out.  With ``control`` the reference is also run rounded to that dtype
and the same numbers are read for it against the exact run.  Imports
nothing of the program.
"""
from __future__ import annotations

import math
import types
from typing import Optional

import numpy as np
import torch

from reference import model

B1, B2, EPS, ALPHA = 0.9, 0.999, 1e-8, 0.1


def learning_rate(cfg: dict, t: int) -> float:
    lr, T = cfg["learning_rate"], cfg["lr_decay_steps"]
    if T <= 0:
        return lr
    decay = 0.5 * (1.0 + math.cos(math.pi * min(t, T) / T))
    return lr * ((1.0 - ALPHA) * decay + ALPHA)


def hinge(scores, lrmsd, near_native: float, margin: float, kinks=None):
    """The ranking hinge; ``kinks`` (a list) gets the smallest distance
    of a ranked pair from the hinge's kink, where rounding can switch
    the pair's gradient on or off."""
    pos = (lrmsd <= near_native).to(scores.dtype)
    w = pos[:, None] * (1.0 - pos)[None, :]
    m = margin - (scores[:, None] - scores[None, :])
    if kinks is not None and bool((w > 0).any()):
        kinks.append(float(m.detach().abs()[w > 0].min()))
    h = torch.clamp(m, min=0.0)
    return (h * w).sum() / torch.clamp(w.sum(), min=1.0)


def batch_loss(cfg: dict, params: dict, conv_keys, batch: dict, device,
               quant=model.rounder(None), kinks=None):
    """Mean over the batch's complexes of the ranking hinge of their
    decoy scores under ``params`` (flax keys, torch layout)."""
    L, res, sigma = cfg["grid_size"], cfg["resolution"], cfg["sigma"]
    T = cfg["num_atom_types"]
    Ls = cfg["lig_grid_size"] or max(16, L // 2)
    W = types.SimpleNamespace(kernels=[params[k] for k in conv_keys],
                              biases=[None] * len(conv_keys),
                              shape_prior=cfg["shape_prior"])
    coupling = params["coupling"].to(torch.float64)
    losses = []
    for b in range(batch["rec_coords"].shape[0]):
        rc, rt, rm, lc, lt, lm = (
            batch[f"{side}_{k}"][b].to(device)
            for side in ("rec", "lig") for k in ("coords", "types", "mask"))
        rep_rec = model.cnn(model.splat(
            rc[None], rt, rm, L, res, sigma, T,
            chunk=4096 if len(rc) > 4096 else None), W, quant)[0]
        F_rec = torch.fft.rfftn(quant(rep_rec).to(torch.float64),
                                dim=(0, 1, 2))
        H = torch.einsum("xyzc,cd->xyzd", F_rec,
                         coupling.to(torch.complex128))
        H = torch.complex(quant(H.real), quant(H.imag))
        R = batch["decoy_rot"][b].to(device, torch.float32)
        vols = model.splat(torch.einsum("dij,nj->dni", R, lc), lt, lm, Ls,
                           res, sigma, T)
        rep = quant(model.cnn(vols, W, quant))
        s = model.continuous_scores(H, rep,
                                    batch["decoy_shift"][b].to(device))
        losses.append(hinge(s, batch["decoy_lrmsd"][b].to(device,
                                                          torch.float64),
                            cfg["near_native_rmsd"], cfg["hinge_margin"],
                            kinks))
    return torch.stack(losses).mean()


def follow(cfg: dict, flat: dict, batches, device, control=None,
           kinks=None):
    """``(losses, first gradients, parameters after the steps, the
    starting parameters)`` of the reference, flax keys, torch layout;
    ``kinks`` (a list) gets each step's smallest distance of a ranked
    pair from the hinge's kink."""
    quant = model.rounder(control)
    W = model.Weights(flat, device)
    conv_keys = sorted(k for k in flat if k.endswith("/kernel"))
    p = {k: w.clone() for k, w in zip(conv_keys, W.kernels)}
    p["coupling"] = W.coupling.clone()
    p0 = {k: v.detach().to(torch.float64).clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    cur = {k: v.clone() for k, v in p0.items()}
    losses, g1 = [], None
    with model.exact_float32():
        for count, batch in enumerate(batches):
            leaves = {k: (v.to(torch.float32) if k != "coupling"
                          else v.clone()).requires_grad_(True)
                      for k, v in cur.items()}
            step_kinks = []
            loss = batch_loss(cfg, leaves, conv_keys, batch, device, quant,
                              step_kinks)
            if kinks is not None:
                kinks.append(min(step_kinks, default=float("inf")))
            grads = torch.autograd.grad(loss, list(leaves.values()))
            g = {k: gr.detach().to(torch.float64)
                 for k, gr in zip(leaves, grads)}
            losses.append(float(loss.detach()))
            if g1 is None:
                g1 = g
            lr, t = learning_rate(cfg, count), count + 1
            for k in cur:
                mu[k] = B1 * mu[k] + (1 - B1) * g[k]
                nu[k] = B2 * nu[k] + (1 - B2) * g[k] * g[k]
                u = (mu[k] / (1 - B1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** t)) + EPS)
                cur[k] = cur[k] - lr * (u + cfg["weight_decay"] * cur[k])
    return losses, g1, cur, p0


def _worst_leaf(got: dict, want: dict, keep) -> float:
    norms = {k: float(torch.linalg.norm(v)) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.norm(got[k])) - norms[k])
               / max(norms[k], med, 1e-300) for k in keep)


def _leaf_diffs(got: dict, want: dict, keep) -> dict:
    norms = {k: float(torch.linalg.norm(v)) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float(torch.linalg.norm(got[k] - want[k]))
            / max(norms[k], med, 1e-300) for k in keep}


def numbers(ref, losses, g1, params) -> dict:
    """The three numbers of ``(losses, g1, params)`` against ``ref``'s
    ``follow`` result."""
    r_losses, r_g1, r_params, p0 = ref
    gnorm = {k: float(torch.linalg.norm(v)) for k, v in r_g1.items()}
    med = float(np.median(list(gnorm.values())))
    keep = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(losses, r_losses))
    if len(losses) != len(r_losses) or not all(map(math.isfinite, losses)):
        loss_gap = float("inf")
    d_got = {k: params[k] - p0[k] for k in keep}
    d_ref = {k: r_params[k] - p0[k] for k in r_params}
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(g1, r_g1, keep),
            "update_gap": _worst_leaf(d_got, d_ref, keep),
            "grad_diff": float(np.median(list(
                _leaf_diffs(g1, r_g1, keep).values()))),
            "losses": list(r_losses),
            "step_loss_gaps": [abs(a - b) / max(abs(b), 1e-12)
                               for a, b in zip(losses, r_losses)],
            "leaf_grad_gaps": {k: _worst_leaf(g1, r_g1, [k]) for k in keep},
            "leaf_update_gaps": {k: _worst_leaf(d_got, d_ref, [k])
                                 for k in keep},
            "leaf_grad_diffs": _leaf_diffs(g1, r_g1, keep),
            "leaf_update_diffs": _leaf_diffs(d_got, d_ref, keep)}


def compare(cfg: dict, flat: dict, kept: dict, names: dict, device,
            control: Optional[str] = None) -> dict:
    """The numbers of the program's kept steps (``kept``: ``losses``,
    ``batches``, ``mu1`` and ``params`` by program name; ``names``:
    program name -> flax key)."""
    kinks = []
    ref = follow(cfg, flat, kept["batches"], device, kinks=kinks)
    p0 = ref[3]

    def flax(d):
        return {names[k]: v.to(device, torch.float64) for k, v in d.items()
                if k in names}
    g1 = {k: v / (1 - B1) for k, v in flax(kept["mu1"]).items()}
    params = flax(kept["params"])
    if set(params) != set(p0):
        raise ValueError(f"program leaves {sorted(params)} != reference "
                         f"leaves {sorted(p0)}")
    out = numbers(ref, kept["losses"], g1, params)
    out["step_kinks"] = kinks
    if control is not None:
        c_losses, c_g1, c_params, _ = follow(cfg, flat, kept["batches"],
                                             device, control)
        for k, v in numbers(ref, c_losses, c_g1, c_params).items():
            if k.endswith(("_gap", "_gaps", "_diff", "_diffs")):
                out["control_" + k] = v
    return out
