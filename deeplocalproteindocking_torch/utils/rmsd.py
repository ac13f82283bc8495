"""RMSD: plain and optimal-superposition (Kabsch).

Port of ``deeplocalproteindocking_tpu/utils/rmsd.py``.  The minimum RMSD
over rigid superposition comes from the same quaternion eigen-method
(Kearsley's 4x4 symmetric key matrix, ``torch.linalg.eigh``) in float32,
so both packages compute the same numbers; an SVD would round
differently.  Every function is batched over leading axes: ``[..., N,
3]`` coordinate sets with an optional ``[..., N]`` mask.
"""
from __future__ import annotations

import torch

from deeplocalproteindocking_torch.structure.transforms import quat_to_matrix


def _weights(a: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    return mask.to(a.dtype)


def _masked_center(x, w):
    n = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mu = (x * w[..., None]).sum(-2) / n
    return x - mu[..., None, :], n[..., 0]


def rmsd(a: torch.Tensor, b: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain (no superposition) RMSD between ``[..., N, 3]`` coord sets."""
    w = _weights(a, mask)
    n = torch.clamp(w.sum(-1), min=1.0)
    sq = (torch.sum((a - b) ** 2, dim=-1) * w).sum(-1) / n
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _quaternion_matrix(a, b, w):
    """Kearsley 4x4 key matrix from centered weighted coord sets."""
    M = torch.einsum("...ni,...nj->...ij", a * w[..., None], b)  # [...,3,3]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    A = M - M.transpose(-1, -2)
    d = torch.stack([A[..., 1, 2], A[..., 2, 0], A[..., 0, 1]], dim=-1)
    S = M + M.transpose(-1, -2)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    block = S - tr[..., None, None] * eye
    top = torch.cat([tr[..., None, None], d[..., None, :]], dim=-1)
    bot = torch.cat([d[..., :, None], block], dim=-1)
    return torch.cat([top, bot], dim=-2)  # [..., 4, 4]


def kabsch_rmsd(a: torch.Tensor, b: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Minimum RMSD over rigid superposition of ``a`` onto ``b``."""
    w = _weights(a, mask)
    ac, n = _masked_center(a, w)
    bc, _ = _masked_center(b, w)
    K = _quaternion_matrix(ac, bc, w)
    lam = torch.linalg.eigvalsh(K)[..., -1]          # largest eigenvalue
    ga = (torch.sum(ac * ac, dim=-1) * w).sum(-1)
    gb = (torch.sum(bc * bc, dim=-1) * w).sum(-1)
    sq = (ga + gb - 2.0 * lam) / n
    return torch.sqrt(torch.clamp(sq, min=0.0))


def kabsch_rotation(a: torch.Tensor, b: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Optimal rotation aligning centered ``a`` onto centered ``b``."""
    w = _weights(a, mask)
    ac, _ = _masked_center(a, w)
    bc, _ = _masked_center(b, w)
    K = _quaternion_matrix(ac, bc, w)
    _, vecs = torch.linalg.eigh(K)
    return quat_to_matrix(vecs[..., -1])            # q = (w, x, y, z)
