"""K2: fused kz->z inverse + translation mask + block max, and the
exact top-K drill-down that follows it.

Port of ``deeplocalproteindocking_tpu/correlate/pallas_invz_topk.py``:

    S[x,y,z]  = sum_k D_re[k,x,y] Mz_re[k,z] - D_im[k,x,y] Mz_im[k,z]
    S        += bias                   (0 / -inf translation mask)
    bmax      = max over 32-wide y runs at fixed (x, z)

without forming the score volume.  :func:`drill_topk` then selects the
top-K blocks by their maxima and recomputes the winning blocks' 32
scores from ``D``.  Exactness: every element outside the selected
blocks is beaten by at least K block maxima.  Flat indices follow the
full volume's ``x*L^2 + y*L + z`` convention.

:func:`invz_blockmax` runs the plain version
:func:`invz_blockmax_reference` for CPU tensors and launches the
hand-written CUDA kernel ``csrc/invz_blockmax_fft.cu`` for CUDA tensors
at L = Z in ``FFT_GRIDS`` (32, 64, 96, 128: every L % 32 == 0 that K1
takes, so every L the fused top-K tail reaches).  ``Mz`` is the c2r
inverse along kz
(:func:`~deeplocalproteindocking_torch.correlate.dft.hermitian_inverse_z`),
so the kernel computes it as a real FFT and never reads ``Mz``; the
wrapper checks once per tensor that ``Mz`` is that matrix.  A CUDA
tensor never falls back: the kernel launches or the call raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate.dft import hermitian_inverse_z
from deeplocalproteindocking_torch.sweep.topk import exact_block_topk

YB = 32         # block width along y
FFT_GRIDS = (32, 64, 96, 128)

# Kernel launches since the last reset (the main path's proof of use).
# K2 has one kernel, so both count every launch; ``launches_fft`` is the
# name that chip_smoke.py's records and measure_scaling read.
launches = 0
launches_fft = 0

# Mz tensors found to be the c2r matrix ("Re" or "Im"), checked once each.
_c2r_checked = WeakIdKeyDictionary()


def _as_groups(bias: torch.Tensor, b: int) -> torch.Tensor:
    if bias.ndim == 3:
        bias = bias[None]
    if bias.ndim != 4 or b % bias.shape[0]:
        raise ValueError(f"invz_blockmax: bias must be [X, Y, Z] or "
                         f"[G, X, Y, Z] with G dividing b={b}, got "
                         f"{tuple(bias.shape)}")
    return bias


def invz_blockmax_reference(Dre, Dim, MzRe, MzIm, bias):
    """Plain torch version: the score volume in float32, the bias added
    per group of ``b // G`` rows, then the max over 32-wide y runs."""
    f32 = torch.float32
    b, K, X, Y = Dre.shape
    Z = MzRe.shape[1]
    bias = _as_groups(bias, b)
    G = bias.shape[0]
    S = (torch.einsum("bkxy,kz->bxyz", Dre.to(f32), MzRe.to(f32))
         - torch.einsum("bkxy,kz->bxyz", Dim.to(f32), MzIm.to(f32)))
    S = (S.reshape(G, b // G, X, Y, Z) + bias.to(f32)[:, None])
    return S.reshape(b, X, Y // YB, YB, Z).amax(dim=3)


def k2_route(L: int) -> str:
    """``"fft"``: the kernel K2 launches for CUDA tensors at grid size
    ``L`` (``Mz [L//2+1, L]``).  Raises ``ValueError`` for L outside
    ``FFT_GRIDS``: no kernel takes those, and no path reaches them (K1
    refuses L > 128, the fused tail needs L % 32 == 0)."""
    if L not in FFT_GRIDS:
        raise ValueError(f"invz_blockmax: no kernel for L={L}; the FFT "
                         f"kernel takes L in {FFT_GRIDS}")
    return "fft"


def require_c2r(MzRe: torch.Tensor, MzIm: torch.Tensor) -> None:
    """Raise unless ``Mz`` is :func:`hermitian_inverse_z` of its L, the
    function the FFT kernel computes.  Each tensor is compared once."""
    if _c2r_checked.get(MzRe) == "Re" and _c2r_checked.get(MzIm) == "Im":
        return
    for part, t, want in zip(("Re", "Im"), (MzRe, MzIm),
                             hermitian_inverse_z(MzRe.shape[-1])):
        _build.check_matrix("invz_blockmax: the FFT route computes the c2r "
                            "inverse along kz", _c2r_checked, "Mz" + part, t,
                            part, want)


def _launch_fft(Dre, Dim, MzRe, MzIm, bias):
    """``csrc/invz_blockmax_fft.cu`` on checked tensors, ``bias [G, X, Y,
    L]``; ``Mz`` must be the c2r matrix (it is not read)."""
    global launches, launches_fft
    b, K, X, Y = Dre.shape
    L, G = MzRe.shape[1], bias.shape[0]
    k2_route(L)
    if K != L // 2 + 1:
        raise ValueError(f"invz_blockmax: the FFT kernel takes K = L/2 + 1, "
                         f"got L={L}, K={K}")
    if Dre.data_ptr() % 16 or Dim.data_ptr() % 16:
        raise ValueError("invz_blockmax: the FFT kernel needs D 16-byte "
                         "aligned")
    require_c2r(MzRe, MzIm)
    out = torch.empty((b, X, Y // YB, L), dtype=torch.float32,
                      device=Dre.device)
    with torch.cuda.device(Dre.device):
        err = _build.library().dlpd_invz_blockmax_fft(
            Dre.data_ptr(), Dim.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, X, Y, L, G, _build.stream(Dre))
    _build.check(err, "invz_blockmax_fft")
    launches += 1
    launches_fft += 1
    return out


def invz_blockmax(Dre: torch.Tensor, Dim: torch.Tensor,
                  MzRe: torch.Tensor, MzIm: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Block maxima ``[b, X, Y//32, Z]`` float32 of the score volumes.

    ``Dre/Dim [b, K, X, Y]`` from ``fused_correlate``; ``MzRe/MzIm
    [K, Z]`` Hermitian-weighted inverse twiddles; ``bias`` additive mask
    (0 valid / -inf masked), ``[X, Y, Z]`` or ``[G, X, Y, Z]`` with G
    dividing b (each contiguous run of b//G rows shares a group).
    """
    b, K, X, Y = Dre.shape
    if Y % YB:
        raise ValueError(f"invz_blockmax needs Y % {YB} == 0, got Y={Y}")
    if Dre.device.type == "cpu":
        return invz_blockmax_reference(Dre, Dim, MzRe, MzIm, bias)
    if Dre.device.type != "cuda":
        raise ValueError(f"invz_blockmax: no kernel for device "
                         f"{Dre.device}")
    bias = _as_groups(bias, b)
    Z = MzRe.shape[1]
    G = bias.shape[0]
    _build.check_tensors(
        "invz_blockmax", Dre.device, torch.float32,
        (("Dre", Dre, (b, K, X, Y)), ("Dim", Dim, (b, K, X, Y)),
         ("MzRe", MzRe, (K, Z)), ("MzIm", MzIm, (K, Z)),
         ("bias", bias, (G, X, Y, Z))))
    return _launch_fft(Dre, Dim, MzRe, MzIm, bias)


def drill_topk(Dre: torch.Tensor, Dim: torch.Tensor,
               MzRe: torch.Tensor, MzIm: torch.Tensor,
               bias_flat: Optional[torch.Tensor],
               bmax: torch.Tensor, top_k: int):
    """Exact top-K ``(vals [b, k], flat [b, k])`` from block maxima.

    ``bmax [b, X, NBy, Z]`` from :func:`invz_blockmax`; the winning
    blocks' 32 scores are recomputed from ``D`` with the same
    contraction, plus the mask when given: ``bias_flat [X*Y*Z]`` for all
    rows, or ``[G, X*Y*Z]`` grouped as :func:`invz_blockmax` groups its
    bias (each contiguous run of b//G rows shares a group).
    """
    f32 = torch.float32
    b, X, NBy, Z = bmax.shape
    Y = NBy * YB
    _, bid = exact_block_topk(bmax.reshape(b, X * NBy * Z), top_k)
    x = bid // (NBy * Z)                                # [b, k]
    yb = (bid // Z) % NBy
    z = bid % Z
    ys = yb[..., None] * YB + torch.arange(YB, device=bmax.device)
    rows = torch.arange(b, device=bmax.device)[:, None, None]
    cr = Dre.permute(0, 2, 3, 1)[rows, x[..., None], ys]   # [b, k, 32, K]
    ci = Dim.permute(0, 2, 3, 1)[rows, x[..., None], ys]
    mr = MzRe.t()[z]                                    # [b, k, K]
    mi = MzIm.t()[z]
    vals = (torch.einsum("bkjK,bkK->bkj", cr.to(f32), mr.to(f32))
            - torch.einsum("bkjK,bkK->bkj", ci.to(f32), mi.to(f32)))
    flat = x[..., None] * (Y * Z) + ys * Z + z[..., None]   # [b, k, 32]
    if bias_flat is not None:
        groups = bias_flat.reshape(-1, X * Y * Z)
        if b % groups.shape[0]:
            raise ValueError(f"drill_topk: {groups.shape[0]} bias groups do "
                             f"not divide b={b}")
        g = rows // (b // groups.shape[0])
        vals = vals + groups[g, flat]
    best, sel = torch.topk(vals.reshape(b, top_k * YB), top_k)
    return best, torch.gather(flat.reshape(b, top_k * YB), 1, sel)
