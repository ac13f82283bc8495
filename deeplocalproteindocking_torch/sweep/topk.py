"""Exact two-level block top-K, and the sweep's result type.

Port of ``deeplocalproteindocking_tpu/sweep/topk.py``: max-reduce blocks
of ``block`` elements (and super-blocks of ``block2`` blocks), top-k over
the maxima, then top-k over the winning blocks' contents.  Exact: an
element outside the selected blocks is beaten by at least k selected
maxima.  Values are exactly ``torch.topk``'s multiset; which of several
equal values is returned may differ.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DockResult(NamedTuple):
    """Top-K ranked rigid-body poses (descending score)."""
    scores: torch.Tensor      # [K] float32
    rot_idx: torch.Tensor     # [K] int32 — index into the rotation set
    shifts: torch.Tensor      # [K, 3] int32 — signed voxel translations

    def translations(self, resolution: float) -> torch.Tensor:
        """Translations in Angstrom."""
        return self.shifts.to(torch.float32) * resolution


def _take_blocks(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, n, w]``, ``idx [B, k]`` -> ``x[b, idx[b, j], :]`` ``[B, k, w]``."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def exact_block_topk(x: torch.Tensor, k: int, block: int = 32,
                     block2: Optional[int] = 32):
    """Exact top-k over the last axis of ``x [B, n]``.

    Returns ``(values [B, k], flat_indices [B, k] int64)``.  ``n`` must
    be divisible by ``block``.
    """
    B, n = x.shape
    if n % block:
        raise ValueError(f"n={n} not divisible by block={block}")
    nb = n // block
    if nb < k:
        return torch.topk(x, k)
    xb = x.reshape(B, nb, block)
    bmax = xb.amax(dim=-1)                              # [B, nb]
    if (block2 and nb % block2 == 0 and nb // block2 >= k
            and nb >= 16 * block2):
        nb2 = nb // block2
        bmax_b = bmax.reshape(B, nb2, block2)
        _, sidx = torch.topk(bmax_b.amax(dim=-1), k)    # super-blocks
        cand1 = _take_blocks(bmax_b, sidx)
        _, c1 = torch.topk(cand1.reshape(B, k * block2), k)
        bidx = (torch.gather(sidx, 1, c1 // block2) * block2
                + c1 % block2)
    else:
        _, bidx = torch.topk(bmax, k)                   # [B, k]
    cand = _take_blocks(xb, bidx)                       # [B, k, block]
    vals, ci = torch.topk(cand.reshape(B, k * block), k)
    flat = torch.gather(bidx, 1, ci // block) * block + ci % block
    return vals, flat
