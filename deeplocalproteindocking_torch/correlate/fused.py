"""K1: fused forward-y/x + channel coupling + inverse-x/y correlator.

Port of ``deeplocalproteindocking_tpu/correlate/pallas_fused.py``.  Per
(kz frequency, rotation):

    B[c,x,j]  = sum_y A[c,x,y] Wy[y,j]          forward y   (rounded)
    F[c,j,i]  = sum_x B[c,x,j] Wx[x,i]          forward x   (float32)
    G[j,i]    = sum_c H[c,j,i] conj(F[c,j,i])   coupling    (rounded)
    C[j,x']   = sum_i G[j,i]   Ux[i,x']         inverse x   (rounded)
    D[x',y']  = sum_j C[j,x']  Uy[j,y']         inverse y   (float32)

"rounded" = cast back to the operand dtype, as the TPU kernel casts.
:func:`fused_correlate` launches the hand-written CUDA kernel
(``csrc/fused_correlate.cu``) for CUDA tensors and runs the plain
version :func:`fused_correlate_reference` for CPU tensors.  A CUDA
tensor never falls back: the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate._contract import cmm

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_L = 128

# Kernel launches since the last reset (the main path's proof of use).
launches = 0


def fused_correlate_reference(Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm,
                              UxRe, UxIm, UyRe, UyIm):
    """Plain torch version: the same formulas and rounding points as
    the TPU kernel, as float32 einsums over the whole batch."""
    dt = Are.dtype
    Bre, Bim = cmm("bkcxy,yj->bkcxj", Are, Aim, WyRe, WyIm)
    Bre, Bim = Bre.to(dt), Bim.to(dt)
    Fre, Fim = cmm("bkcxj,xi->bkcji", Bre, Bim, WxRe, WxIm)
    Hr, Hi = Hre.to(torch.float32), Him.to(torch.float32)
    Gre = (Hr * Fre + Hi * Fim).sum(dim=2).to(dt)       # [b, K, J, I]
    Gim = (Hi * Fre - Hr * Fim).sum(dim=2).to(dt)
    Cre, Cim = cmm("bkji,ix->bkjx", Gre, Gim, UxRe, UxIm)
    Cre, Cim = Cre.to(dt), Cim.to(dt)
    return cmm("bkjx,jy->bkxy", Cre, Cim, UyRe, UyIm)


def fused_correlate(Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm,
                    UxRe, UxIm, UyRe, UyIm):
    """``(Dre, Dim) [b, K, X', Y']`` float32.

    ``Are/Aim [b, K, C, X, Y]`` z-transformed ligand volumes;
    ``Hre/Him [K, C, J, I]`` coupled receptor spectrum
    (``DFTCorrelator.prep_H``); twiddles ``Wy [Y, J]``, ``Wx [X, I]``,
    ``Ux [I, X']``, ``Uy [J, Y']``; all of one dtype (float32 or
    bfloat16) and device.
    """
    if Are.device.type == "cpu":
        return fused_correlate_reference(Are, Aim, Hre, Him, WyRe, WyIm,
                                         WxRe, WxIm, UxRe, UxIm, UyRe,
                                         UyIm)
    if Are.device.type != "cuda":
        raise ValueError(f"fused_correlate: no kernel for device "
                         f"{Are.device}")
    global launches
    b, K, C, X, Y = Are.shape
    J, I = WyRe.shape[1], WxRe.shape[1]
    Xp, Yp = UxRe.shape[1], UyRe.shape[1]
    if Are.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_correlate: kernel takes float32 or "
                        f"bfloat16, got {Are.dtype}")
    if max(I, Xp, Yp, J) > _MAX_L:
        raise ValueError(f"fused_correlate: kernel takes L <= {_MAX_L}, "
                         f"got J={J}, I={I}, X'={Xp}, Y'={Yp}")
    args = (Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe,
            UyIm)
    names = ("Are", "Aim", "Hre", "Him", "WyRe", "WyIm", "WxRe", "WxIm",
             "UxRe", "UxIm", "UyRe", "UyIm")
    shapes = ((b, K, C, X, Y),) * 2 + ((K, C, J, I),) * 2 + (
        (Y, J),) * 2 + ((X, I),) * 2 + ((I, Xp),) * 2 + ((J, Yp),) * 2
    _build.check_tensors("fused_correlate", Are.device, Are.dtype,
                         zip(names, args, shapes))
    Dre = torch.empty((b, K, Xp, Yp), dtype=torch.float32,
                      device=Are.device)
    Dim = torch.empty_like(Dre)
    lib = _build.library()
    with torch.cuda.device(Are.device):
        err = lib.dlpd_fused_correlate(
            _KERNEL_DTYPES[Are.dtype], *(t.data_ptr() for t in args),
            Dre.data_ptr(), Dim.data_ptr(), b, K, C, X, Y, J, I, Xp, Yp,
            torch.cuda.current_stream(Are.device).cuda_stream)
    _build.check(err, "fused_correlate")
    launches += 1
    return Dre, Dim
