"""The scoring model in plain PyTorch: Gaussian splat, the analytic
shape channels, the 3-D CNN, the channel coupling and the translational
correlation.

Written from the model's definition (Derevyanko & Lamoureux, bioRxiv
738690: typed Gaussian densities, a shared 3-D CNN, a learned coupling
between receptor and ligand channels, the score as a circular
correlation over every translation; the repository's hybrid model adds
two analytic shape channels).  It reads the flax weights itself, works
in float32 with TF32 off for the splat and the CNN and in float64 for
the transforms, and imports nothing of the program.  ``quant`` rounds
at the points where a lower-precision program would round, for the
control (``None``: no rounding).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

CORE_WEIGHT, THRESHOLD, SHELL = 12.0, 0.35, 2


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rounder(dtype_name: Optional[str]) -> Callable:
    """``x -> x`` rounded through ``dtype_name`` and back (identity for
    None).  A float8 type rounds as a float8 path does: each tensor
    scaled by its largest magnitude onto the type's range first."""
    if dtype_name is None:
        return lambda x: x
    dt = getattr(torch, dtype_name)
    if not dtype_name.startswith("float8"):
        return lambda x: x.to(torch.float32).to(dt).to(x.dtype)
    top = torch.finfo(dt).max

    def scaled(x):
        y = x.to(torch.float32)
        s = (y.abs().max() / top).clamp(min=1e-30)
        return ((y / s).to(dt).to(torch.float32) * s).to(x.dtype)
    return scaled


class Weights:
    """The flax parameter file: conv kernels ``[kx, ky, kz, I, O]`` as
    torch ``[O, I, kx, ky, kz]``, the coupling ``[C, C]``."""

    def __init__(self, flat: dict, device):
        keys = sorted(k for k in flat if k.endswith("/kernel"))
        self.kernels = [torch.as_tensor(
            np.ascontiguousarray(np.asarray(flat[k], np.float32)
                                 .transpose(4, 3, 0, 1, 2)), device=device)
            for k in keys]
        self.biases = [None if k.replace("kernel", "bias") not in flat
                       else torch.as_tensor(np.asarray(
                           flat[k.replace("kernel", "bias")], np.float32),
                           device=device) for k in keys]
        self.coupling = torch.as_tensor(np.asarray(flat["coupling"],
                                                   np.float64),
                                        device=device)
        self.shape_prior = any("cnn" in k for k in keys)


def splat(coords: torch.Tensor, types: torch.Tensor, mask: torch.Tensor,
          L: int, resolution: float, sigma: float, T: int,
          chunk: Optional[int] = None) -> torch.Tensor:
    """Density ``[B, L, L, L, T]`` of atoms ``coords [B, n, 3]`` with
    ``types [n]`` or ``[B, n]`` and ``mask`` of the same shape (padding
    rows 0): the sum of each atom's Gaussian over every voxel, box
    centered on 0, voxel i centered at ``-L res / 2 + (i + 1/2) res``.
    Each axis's profile is taken in voxel units, then one matrix
    product per batch row (per ``chunk`` atoms, summed): the arithmetic
    of the published separable form, so that equal atoms give equal
    densities to the last bit, and the shape channels' threshold sees
    the same occupancy."""
    B, n = coords.shape[:2]
    if chunk is not None and n > chunk:
        return sum(splat(coords[:, a:a + chunk], types[..., a:a + chunk],
                         mask[..., a:a + chunk], L, resolution, sigma, T)
                   for a in range(0, n, chunk))
    origin = torch.full((3,), -0.5 * L * resolution, dtype=coords.dtype,
                        device=coords.device)
    g = (coords - origin) / resolution - 0.5
    centers = torch.arange(L, dtype=coords.dtype, device=coords.device)
    d = (g[..., None] - centers) * resolution               # [B, n, 3, L]
    prof = torch.exp(-(d * d) / (2.0 * sigma * sigma))
    mask = mask.to(coords.dtype) * (types >= 0).to(coords.dtype)
    px = prof[..., 0, :] * mask[..., None]
    onehot = F.one_hot(types.clamp(0, T - 1).long(), T).to(coords.dtype)
    W = px[..., :, None] * onehot[..., None, :]             # [B, n, L, T]
    U = prof[..., 1, :, None] * prof[..., 2, None, :]       # [B, n, L, L]
    out = torch.bmm(U.reshape(B, n, L * L).transpose(1, 2),
                    W.reshape(B, n, L * T))                 # [(y z), (x t)]
    return out.reshape(B, L, L, L, T).permute(0, 3, 1, 2, 4)


def shape_channels(vol: torch.Tensor) -> torch.Tensor:
    """``[B, L, L, L, 2]``: (surface, core); core = summed density above
    the threshold, surface = its cube dilation by SHELL voxels minus the
    core (nothing outside the box)."""
    core = (vol.sum(-1) > THRESHOLD).to(vol.dtype)
    w = 2 * SHELL + 1
    dil = F.max_pool3d(core[:, None], w, stride=1, padding=SHELL)[:, 0]
    return torch.stack([dil - core, core], dim=-1)


def cnn(vol: torch.Tensor, w: Weights, quant=rounder(None),
        last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The representation ``[B, L, L, L, C]`` of ``vol [B, L, L, L, T]``:
    "SAME" convolutions with ELU between them, the shape channels first
    when the model has them.  ``last [C, r]`` projects the output
    channels (the rank-r ligand side)."""
    x = vol.permute(0, 4, 1, 2, 3)
    for i, (k, b) in enumerate(zip(w.kernels, w.biases)):
        x = F.conv3d(quant(x), quant(k), None if b is None else quant(b),
                     padding=k.shape[-1] // 2)
        if i + 1 < len(w.kernels):
            x = F.elu(x)
    rep = quant(x).permute(0, 2, 3, 4, 1)
    if w.shape_prior:
        rep = torch.cat([shape_channels(vol), rep], dim=-1)
    if last is not None:
        rep = torch.einsum("bxyzc,cr->bxyzr", rep, last.to(rep.dtype))
    return rep


def coupling_factors(coupling: torch.Tensor, rank: Optional[int]):
    """``(P_rec [C, r], P_lig [C, r])`` with ``P_rec P_lig^T`` the
    coupling cut to its leading ``rank`` singular triplets (float64
    SVD), or the whole coupling and the identity."""
    C = coupling.shape[0]
    if rank is None or rank >= C:
        eye = torch.eye(C, dtype=coupling.dtype, device=coupling.device)
        return coupling, eye
    U, s, Vh = torch.linalg.svd(coupling)
    return U[:, :rank] * s[:rank], Vh[:rank].T


def embed(rep: torch.Tensor, L: int) -> torch.Tensor:
    """A ``[B, Ls, Ls, Ls, C]`` box centered in the ``L`` grid."""
    Ls = rep.shape[1]
    off = (L - Ls) // 2
    side = (off, L - Ls - off)
    return F.pad(rep, (0, 0) + side * 3)


def receptor_spectrum(rep_rec: torch.Tensor, P_rec: torch.Tensor
                      ) -> torch.Tensor:
    """``[L, L, L//2+1, r]`` complex128: the receptor rep's transform,
    coupled."""
    F_rec = torch.fft.rfftn(rep_rec.to(torch.float64), dim=(0, 1, 2))
    return torch.einsum("xyzc,cr->xyzr", F_rec,
                        P_rec.to(torch.complex128))


def score_maps(H: torch.Tensor, lig_rep: torch.Tensor, quant=rounder(None)
               ) -> torch.Tensor:
    """Scores ``[B, L, L, L]`` at every circular shift: ``irfftn(sum_r
    H_r conj(F[lig]_r))``, index i the signed shift i (i <= L/2) or
    i - L; ``lig_rep [B, Ls, Ls, Ls, r]``."""
    L = H.shape[0]
    F_lig = torch.fft.rfftn(embed(quant(lig_rep).to(torch.float64), L),
                            dim=(1, 2, 3))
    G = torch.einsum("xyzr,bxyzr->bxyz", H, torch.conj(F_lig))
    return torch.fft.irfftn(G, s=(L, L, L), dim=(1, 2, 3))


def continuous_scores(H: torch.Tensor, lig_rep: torch.Tensor,
                      t_vox: torch.Tensor) -> torch.Tensor:
    """Scores ``[B]`` at continuous shifts ``t_vox [B, 3]`` (voxels): the
    trigonometric interpolation ``sum_k G[k] exp(2 pi i k.t / L) / L^3``
    of the correlation's spectrum over signed frequencies, the Nyquist
    bin taking ``cos(pi t)`` per axis; differentiable."""
    L = H.shape[0]
    F_lig = torch.fft.fftn(embed(lig_rep.to(torch.float64), L),
                           dim=(1, 2, 3))
    Hf = _full_spectrum(H, L)
    G = torch.einsum("xyzr,bxyzr->bxyz", Hf, torch.conj(F_lig))
    k = torch.arange(L, device=H.device, dtype=torch.float64)
    kf = torch.where(k <= L // 2, k, k - L)
    nyq = k == L // 2
    t = t_vox.to(torch.float64)

    def phase(ti):
        ang = 2.0 * np.pi * kf * ti[:, None] / L
        re = torch.where(nyq, torch.cos(np.pi * ti)[:, None],
                         torch.cos(ang))
        im = torch.where(nyq, torch.zeros_like(ang), torch.sin(ang))
        return torch.complex(re, im)

    px, py, pz = phase(t[:, 0]), phase(t[:, 1]), phase(t[:, 2])
    s = torch.einsum("bxyz,bx,by,bz->b", G, px, py, pz)
    return s.real / L ** 3


def _full_spectrum(H: torch.Tensor, L: int) -> torch.Tensor:
    """The full ``[L, L, L, r]`` spectrum of a real volume from its rfft
    half ``[L, L, L//2+1, r]`` (Hermitian symmetry)."""
    idx = (-torch.arange(L, device=H.device)) % L
    rest = torch.conj(H[idx][:, idx][:, :, idx[L // 2 + 1:]])
    return torch.cat([H, rest], dim=2)
