"""Scoring model: shared representation net + learned channel coupling.

Port of ``deeplocalproteindocking_tpu/models/scoring.py``.  The coupling
starts as the identity (plain model) or as the 2x2 shape block with
zeros elsewhere (hybrid model), so an untrained model scores pure shape
complementarity.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeplocalproteindocking_torch.models.representation import (
    HybridRepresentation, Representation)


def identity_coupling(c: int) -> torch.Tensor:
    return torch.eye(c, dtype=torch.float32)


def shape_block_coupling(c: int, core_weight: float = 12.0
                         ) -> torch.Tensor:
    m = torch.zeros((c, c), dtype=torch.float32)
    m[0, 0] = 1.0
    m[1, 1] = -core_weight
    return m


class ScoringModel(nn.Module):
    def __init__(self, features: Sequence[int] = (32, 32, 16),
                 kernel: int = 3, dtype: torch.dtype = torch.float32,
                 shape_prior: bool = False, in_channels: int = 11):
        super().__init__()
        self.shape_prior = shape_prior
        if shape_prior:
            self.representation = HybridRepresentation(
                in_channels, features, kernel, dtype)
            c = features[-1] + 2
            init = shape_block_coupling(c)
        else:
            self.representation = Representation(
                in_channels, features, kernel, dtype)
            c = features[-1]
            init = identity_coupling(c)
        self.coupling = nn.Parameter(init)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax-style init: lecun-normal conv kernels from ``generator``,
        zero biases, the deterministic coupling init."""
        self.representation.reset_parameters(generator)
        c = self.coupling.shape[0]
        init = (shape_block_coupling(c) if self.shape_prior
                else identity_coupling(c))
        with torch.no_grad():
            self.coupling.copy_(init)

    def forward(self, rec_vol: torch.Tensor, lig_vol: torch.Tensor):
        """``(rep_rec, rep_lig, coupling)`` for the sweep."""
        return (self.representation(rec_vol),
                self.representation(lig_vol), self.coupling)

    def represent(self, vol: torch.Tensor) -> torch.Tensor:
        return self.representation(vol)
