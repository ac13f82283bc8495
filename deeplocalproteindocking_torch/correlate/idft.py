"""K3: the inverse DFT of the correlation spectrum, passes B and C fused.

Port of ``deeplocalproteindocking_tpu/correlate/pallas_idft.py``
(``fft_impl="dft_pallas"``).  For the summed spectrum
``G (re, im) [B, L, L, L//2+1]`` float32:

    E[b,kx,ky,z]  = sum_kz G[b,kx,ky,kz] Mz[kz,z]          pass A (einsum)
    f[b,x,ky,z]   = sum_kx Ux[kx,x] E[b,kx,ky,z]           pass B (kernel)
    S[b,x,y,z]    = Re sum_ky Uy[ky,y] f[b,x,ky,z]         pass C (kernel)

all complex products as four real float32 contractions, with float32
twiddles whatever the correlator's operand dtype, as the TPU kernel
takes them.  :func:`idft_bc` runs the plain version
:func:`idft_bc_reference` for CPU tensors and launches the hand-written
CUDA kernel ``csrc/idft_fft.cu`` for CUDA tensors at L in ``FFT_GRIDS``
(16, 32, 48, 64, 80, 96, 112, 128: every grid the engine takes, a
multiple of 16 up to 128).  ``Ux`` and ``Uy`` are the inverse DFT matrix
(:func:`~deeplocalproteindocking_torch.correlate.dft.inverse_dft`), so
the kernel computes passes B and C as a complex FFT along ky and a c2r
along kx (at L = 16 one pass per rotation, both inverses in shared
memory) and never reads them; the wrapper checks once per tensor that
they are that matrix.  At 48, 80 and 112 the last 32-wide z run is half
full and masked.  A CUDA tensor never falls back: the kernel launches
or the call raises.
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate._contract import cmm, mm

TX = 8          # x rows per block (the TPU kernel's TX)
KYB = 16        # ky block (the TPU kernel's KYB)
FFT_GRIDS = (16, 32, 48, 64, 80, 96, 112, 128)

# Kernel launches since the last reset (the main path's proof of use).
# K3 has one kernel, so both count every launch; ``launches_fft`` is the
# name that chip_smoke.py's records and measure_scaling read.
launches = 0
launches_fft = 0

# Twiddle tensors found to be the inverse DFT matrix ("Re" or "Im"),
# checked once each.
_idft_checked = WeakIdKeyDictionary()


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


def k3_route(L: int) -> str:
    """``"fft"``: the kernel K3 launches for CUDA tensors at grid size
    ``L``.  Raises ``ValueError`` for L outside ``FFT_GRIDS``, which the
    engine refuses too."""
    if L not in FFT_GRIDS:
        raise ValueError(f"idft_bc: no kernel for L={L}; the FFT kernel "
                         f"takes L in {FFT_GRIDS}")
    return "fft"


def require_idft(UxRe, UxIm, UyRe, UyIm) -> None:
    """Raise unless ``Ux`` and ``Uy`` are
    :func:`~deeplocalproteindocking_torch.correlate.dft.inverse_dft` of
    their L, the matrix the FFT kernel applies.  Each tensor is compared
    once."""
    # dft imports this module (pallas_inverse): import it at call time.
    from deeplocalproteindocking_torch.correlate.dft import inverse_dft
    named = (("UxRe", UxRe, "Re"), ("UxIm", UxIm, "Im"), ("UyRe", UyRe, "Re"),
             ("UyIm", UyIm, "Im"))
    if all(_idft_checked.get(t) == part for _, t, part in named):
        return
    want = dict(zip(("Re", "Im"), inverse_dft(UxRe.shape[-1])))
    for name, t, part in named:
        _build.check_matrix("idft_bc: the FFT route computes the inverse DFT "
                            "along x and y", _idft_checked, name, t, part,
                            want[part])


def _launch_fft(Ere, Eim, UxRe, UxIm, UyRe, UyIm):
    """``csrc/idft_fft.cu`` on checked tensors; ``Ux``/``Uy`` must be
    the inverse DFT matrix (they are not read).  The kernel's scratch,
    the folded half spectrum ``h (re, im) [B, L/2+1, L, L]``, is
    allocated here (L = 16 runs in one pass and leaves it unused)."""
    global launches, launches_fft
    B, L = Ere.shape[0], Ere.shape[1]
    k3_route(L)
    if Ere.data_ptr() % 16 or Eim.data_ptr() % 16:
        raise ValueError("idft_bc: the FFT kernel needs E 16-byte aligned")
    require_idft(UxRe, UxIm, UyRe, UyIm)
    S = torch.empty((B, L, L, L), dtype=torch.float32, device=Ere.device)
    h = torch.empty((2, B, L // 2 + 1, L, L), dtype=torch.float32,
                    device=Ere.device)
    with torch.cuda.device(Ere.device):
        err = _build.library().dlpd_idft_fft(
            Ere.data_ptr(), Eim.data_ptr(), h[0].data_ptr(), h[1].data_ptr(),
            S.data_ptr(), B, L, _build.stream(Ere))
    _build.check(err, "idft_fft")
    launches += 1
    launches_fft += 1
    return S


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
    vol, tw = (B, L, L, L), (L, L)
    _build.check_tensors(
        "idft_bc", Ere.device, torch.float32,
        (("Ere", Ere, vol), ("Eim", Eim, vol), ("UxRe", UxRe, tw),
         ("UxIm", UxIm, tw), ("UyRe", UyRe, tw), ("UyIm", UyIm, tw)))
    return _launch_fft(Ere, Eim, UxRe, UxIm, UyRe, UyIm)


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
