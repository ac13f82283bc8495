"""float32-accumulating contractions shared by the correlator modules.

The JAX package writes every DFT contraction as
``einsum(..., preferred_element_type=f32)`` on operands of the
correlator's dtype.  Upcasting bf16 or f32 operands to float32 is exact,
so an einsum on the upcast operands is the same contraction.
"""
from __future__ import annotations

import torch


def mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` in float32."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def cmm(eq: str, are, aim, bre, bim):
    """Complex ``(are + i aim) . (bre + i bim)`` as four real float32
    contractions; returns (re, im)."""
    return (mm(eq, are, bre) - mm(eq, aim, bim),
            mm(eq, are, bim) + mm(eq, aim, bre))
