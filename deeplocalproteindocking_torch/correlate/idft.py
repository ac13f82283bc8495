"""K3: the inverse DFT of the correlation spectrum, passes B and C fused.

Port of ``deeplocalproteindocking_tpu/correlate/pallas_idft.py``
(``fft_impl="dft_pallas"``).  For the summed spectrum
``G (re, im) [B, L, L, L//2+1]`` float32:

    E[b,kx,ky,z]  = sum_kz G[b,kx,ky,kz] Mz[kz,z]          pass A (einsum)
    f[b,x,ky,z]   = sum_kx Ux[kx,x] E[b,kx,ky,z]           pass B (kernel)
    S[b,x,y,z]    = Re sum_ky Uy[ky,y] f[b,x,ky,z]         pass C (kernel)

all complex products as four real float32 contractions, with float32
twiddles whatever the correlator's operand dtype, as the TPU kernel
takes them.  :func:`idft_bc` launches the hand-written CUDA kernel
(``csrc/idft_bc.cu``) for CUDA tensors and runs the plain version
:func:`idft_bc_reference` for CPU tensors; a CUDA tensor never falls
back.
"""
from __future__ import annotations

import torch

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate._contract import cmm, mm

TX = 8          # x rows per block (the TPU kernel's TX)
KYB = 16        # ky block (the TPU kernel's KYB)
_MAX_L = 128

# Kernel launches since the last reset (the main path's proof of use).
launches = 0


def _check_grid(L: int) -> None:
    if L % TX or L % KYB:
        # Silent remainder rows would produce wrong score volumes.
        raise ValueError(
            f"fft_impl='dft_pallas' needs grid_size divisible by {TX} and "
            f"{KYB}; got {L}. Use fft_impl='dft_fused' or 'dft' for this "
            f"grid size.")


def _pass_a(gre, gim, MzRe, MzIm):
    """kz -> z with the complex Hermitian-weighted ``Mz [L//2+1, L]``."""
    ere, eim = cmm("bijk,kz->bijz", gre, gim, MzRe, MzIm)
    return ere.contiguous(), eim.contiguous()


def idft_bc_reference(Ere, Eim, UxRe, UxIm, UyRe, UyIm):
    """Plain torch version of passes B and C, in float32."""
    fre, fim = cmm("bkjz,kx->bxjz", Ere, Eim, UxRe, UxIm)
    return mm("bxjz,jy->bxyz", fre, UyRe) - mm("bxjz,jy->bxyz", fim, UyIm)


def idft_bc(Ere: torch.Tensor, Eim: torch.Tensor, UxRe: torch.Tensor,
            UxIm: torch.Tensor, UyRe: torch.Tensor, UyIm: torch.Tensor
            ) -> torch.Tensor:
    """Real ``S [B, L, L, L]`` float32 from ``E (re, im) [B, L, L, L]``
    (kx, ky, z) and the inverse twiddles ``Ux/Uy [L, L]`` (k, position),
    all float32."""
    B, L = Ere.shape[0], Ere.shape[1]
    _check_grid(L)
    if Ere.device.type == "cpu":
        return idft_bc_reference(Ere, Eim, UxRe, UxIm, UyRe, UyIm)
    if Ere.device.type != "cuda":
        raise ValueError(f"idft_bc: no kernel for device {Ere.device}")
    global launches
    if L > _MAX_L:
        raise ValueError(f"idft_bc: kernel takes L <= {_MAX_L}, got {L}")
    vol, tw = (B, L, L, L), (L, L)
    _build.check_tensors(
        "idft_bc", Ere.device, torch.float32,
        (("Ere", Ere, vol), ("Eim", Eim, vol), ("UxRe", UxRe, tw),
         ("UxIm", UxIm, tw), ("UyRe", UyRe, tw), ("UyIm", UyIm, tw)))
    S = torch.empty(vol, dtype=torch.float32, device=Ere.device)
    lib = _build.library()
    with torch.cuda.device(Ere.device):
        err = lib.dlpd_idft_bc(
            Ere.data_ptr(), Eim.data_ptr(), UxRe.data_ptr(), UxIm.data_ptr(),
            UyRe.data_ptr(), UyIm.data_ptr(), S.data_ptr(), B, L,
            torch.cuda.current_stream(Ere.device).cuda_stream)
    _build.check(err, "idft_bc")
    launches += 1
    return S


def _inverse(passes_bc, gre, gim, UxRe, UxIm, UyRe, UyIm, MzRe, MzIm):
    _check_grid(gre.shape[1])
    f32 = torch.float32
    ere, eim = _pass_a(gre.to(f32), gim.to(f32), MzRe.to(f32), MzIm.to(f32))
    return passes_bc(ere, eim, *(u.to(f32).contiguous()
                                 for u in (UxRe, UxIm, UyRe, UyIm)))


def pallas_inverse(gre, gim, UxRe, UxIm, UyRe, UyIm, MzRe, MzIm
                   ) -> torch.Tensor:
    """``G (re, im) [B, L, L, L//2+1]`` -> real ``S [B, L, L, L]``.

    Twiddles as the correlator holds them: ``Ux/Uy [k, pos]``, ``Mz
    [kz, z]`` (Hermitian-weighted, 1/L folded per axis); all are used in
    float32.  Raises ``ValueError`` unless L is a multiple of 8 and 16.
    """
    return _inverse(idft_bc, gre, gim, UxRe, UxIm, UyRe, UyIm, MzRe, MzIm)


def pallas_inverse_reference(gre, gim, UxRe, UxIm, UyRe, UyIm, MzRe, MzIm
                             ) -> torch.Tensor:
    """Plain torch version of :func:`pallas_inverse`, same pass order."""
    return _inverse(idft_bc_reference, gre, gim, UxRe, UxIm, UyRe, UyIm,
                    MzRe, MzIm)
