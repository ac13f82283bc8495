"""Ranking loss over near-native vs decoy poses.

Port of ``deeplocalproteindocking_tpu/train/losses.py``.  Higher score =
better pose.  The loss is the mean over all (near-native, decoy) pairs
of ``max(0, margin - (S_pos - S_neg))``; a decoy set without a positive
or a negative contributes zero (masked mean, ``max(sum w, 1)`` guard).
"""
from __future__ import annotations

import torch


def _pair_weights(scores: torch.Tensor, lrmsd: torch.Tensor,
                  near_native_rmsd: float) -> torch.Tensor:
    """``w[i, j] = 1`` where pose i is near-native and pose j a decoy."""
    pos = (lrmsd <= near_native_rmsd).to(scores.dtype)
    return pos[:, None] * (1.0 - pos)[None, :]


def ranking_hinge_loss(scores: torch.Tensor, lrmsd: torch.Tensor, *,
                       near_native_rmsd: float = 5.0,
                       margin: float = 1.0) -> torch.Tensor:
    """Pairwise hinge over one complex's decoy set: ``scores [D]``,
    ``lrmsd [D]`` -> scalar loss."""
    w = _pair_weights(scores, lrmsd, near_native_rmsd)
    hinge = torch.clamp(margin - (scores[:, None] - scores[None, :]),
                        min=0.0)
    return (hinge * w).sum() / torch.clamp(w.sum(), min=1.0)


def pairwise_ranking_accuracy(scores: torch.Tensor, lrmsd: torch.Tensor,
                              near_native_rmsd: float = 5.0
                              ) -> torch.Tensor:
    """Fraction of (near-native, decoy) pairs ranked strictly correctly."""
    w = _pair_weights(scores, lrmsd, near_native_rmsd)
    correct = (scores[:, None] > scores[None, :]).to(scores.dtype)
    return (correct * w).sum() / torch.clamp(w.sum(), min=1.0)
