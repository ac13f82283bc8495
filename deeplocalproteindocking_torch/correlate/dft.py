"""Matmul-DFT correlation engine.

Port of ``deeplocalproteindocking_tpu/correlate/dft.py``.  The 3-D
transform of a small ligand box is three axis contractions with
precomputed twiddle matrices (the box's centering offset folded into the
forward twiddles, so the embed into the big box is never formed), and
the inverse is two full ``[L -> L]`` contractions plus a Hermitian-
weighted real-part contraction over the rfft half axis.

Twiddles are built by the JAX package's numpy ``_twiddle`` formula and
moved to the device once per (L, Ls, dtype, device).  Every contraction
runs in float32 on operands of the correlator's ``dtype`` and is cast
back to ``dtype`` at the same points the JAX module casts
(``preferred_element_type=f32`` there).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from deeplocalproteindocking_torch.correlate._contract import cmm as _cmm
from deeplocalproteindocking_torch.correlate._contract import mm as _mm
from deeplocalproteindocking_torch.correlate.fused import (fused_correlate,
                                                           twiddle_layouts)
from deeplocalproteindocking_torch.correlate.idft import pallas_inverse

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _twiddle(pos: np.ndarray, freqs: np.ndarray, L: int, sign: float,
             scale: float = 1.0):
    """(re, im) of ``scale * exp(sign * 2 pi i * pos * k / L)``."""
    ang = 2.0 * np.pi * np.outer(pos, freqs) / L
    re = (scale * np.cos(ang)).astype(np.float32)
    im = (sign * scale * np.sin(ang)).astype(np.float32)
    return re, im


def inverse_dft(L: int):
    """``U (re, im) [L, L]`` float32, ``U[k, x] = e^{+2 pi i k x / L} / L``:
    the inverse DFT along x or y as a matrix (k, position)."""
    kf = np.arange(L)
    return _twiddle(kf, kf, L, +1.0, scale=1.0 / L)


def hermitian_inverse_z(L: int):
    """``Mz (re, im) [L//2+1, L]`` float32: the c2r inverse along kz
    (``irfft`` with its 1/L) as a matrix, Hermitian weights 1, 2, ..., 2,
    1 folded in."""
    kh = np.arange(L // 2 + 1)
    w = np.full(L // 2 + 1, 2.0)
    w[0] = w[-1] = 1.0
    re, im = _twiddle(kh, np.arange(L), L, +1.0, scale=1.0 / L)
    return ((re * w[:, None]).astype(np.float32),
            (im * w[:, None]).astype(np.float32))


class DFTCorrelator:
    """Twiddle matrices for a (grid_size, lig_grid) pair on one device."""

    def __init__(self, grid_size: int, lig_grid: int,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"):
        L, Ls = grid_size, lig_grid
        if L % 2:
            raise ValueError("grid_size must be even")
        self.L, self.Ls = L, Ls
        self.dtype = dtype
        self.device = torch.device(device)
        off = (L - Ls) // 2
        pos = np.arange(Ls) + off               # ligand voxel -> big grid
        kf = np.arange(L)
        kh = np.arange(L // 2 + 1)
        WxRe, WxIm = _twiddle(pos, kf, L, -1.0)
        WzRe, WzIm = _twiddle(pos, kh, L, -1.0)
        UxRe, UxIm = inverse_dft(L)
        mzre, mzim = hermitian_inverse_z(L)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a, np.float32)).to(
                self.device, dt).contiguous()

        # Operand-typed twiddles (forward x and y share one matrix, as
        # do inverse x and y).
        self.WxRe, self.WxIm = dev(WxRe), dev(WxIm)
        self.WyRe, self.WyIm = self.WxRe, self.WxIm
        self.WzRe, self.WzIm = dev(WzRe), dev(WzIm)
        self.UxRe, self.UxIm = dev(UxRe), dev(UxIm)
        self.UyRe, self.UyIm = self.UxRe, self.UxIm
        # K3 takes its x/y twiddles in float32 whatever the operand dtype,
        # as the TPU kernel does.
        self.UxRe32 = dev(UxRe, torch.float32)
        self.UxIm32 = dev(UxIm, torch.float32)
        # Hermitian-weighted kz -> z inverse: float32 for the fused
        # top-K tail, which reads it at full precision, and in the
        # operand dtype (Op) for the einsum inverses, as the JAX module
        # casts it.
        self.MzRe = dev(mzre, torch.float32)
        self.MzIm = dev(mzim, torch.float32)
        self.MzReOp = dev(mzre)
        self.MzImOp = dev(mzim)

    def _cast(self, *xs):
        return tuple(x.to(self.dtype) for x in xs)

    def ligand_spectrum(self, vols: torch.Tensor):
        """``[B, Ls, Ls, Ls, C]`` -> spectrum (re, im) each
        ``[B, L, L, L//2+1, C]`` float32."""
        v = vols.to(self.dtype)
        are, aim = self._cast(_mm("bxyzc,zk->bxykc", v, self.WzRe),
                              _mm("bxyzc,zk->bxykc", v, self.WzIm))
        bre, bim = self._cast(*_cmm("bxykc,yj->bxjkc", are, aim,
                                    self.WyRe, self.WyIm))
        return _cmm("bxjkc,xi->bijkc", bre, bim, self.WxRe, self.WxIm)

    def scores(self, Hre: torch.Tensor, Him: torch.Tensor,
               vols: torch.Tensor, inverse_impl: str = "einsum"
               ) -> torch.Tensor:
        """Score volumes ``[B, L, L, L]`` from the coupled receptor
        spectrum ``Hre/Him [L, L, L//2+1, C]``, or ``[G, L, L, L//2+1,
        C]`` with G dividing B: rows ``[g B/G, (g+1) B/G)`` couple with
        ``H[g]``.

        ``inverse_impl="einsum"`` is the ``dft`` engine; ``"pallas"``
        (the ``dft_pallas`` engine) hands the float32 summed spectrum,
        never cast to the operand dtype, to K3 (``correlate/idft.py``).
        """
        fre, fim = self._cast(*self.ligand_spectrum(vols))
        Hre_, Him_ = self._cast(Hre, Him)
        grouped = Hre.ndim == 5
        if grouped:
            fre = fre.reshape((Hre.shape[0], -1) + fre.shape[1:])
            fim = fim.reshape(fre.shape)
        eq = "gijkc,gbijkc->gbijk" if grouped else "ijkc,bijkc->bijk"
        gre = _mm(eq, Hre_, fre) + _mm(eq, Him_, fim)
        gim = _mm(eq, Him_, fre) - _mm(eq, Hre_, fim)
        if grouped:
            gre, gim = gre.flatten(0, 1), gim.flatten(0, 1)
        if inverse_impl == "pallas":
            return pallas_inverse(gre, gim, self.UxRe32, self.UxIm32,
                                  self.UxRe32, self.UxIm32, self.MzRe,
                                  self.MzIm)
        return self.inverse(gre, gim)

    # ---- fused-kernel path (correlate/fused.py) ----
    def prep_H(self, H: torch.Tensor):
        """``H [i, j, k, c]`` complex -> (re, im) in the fused kernel's
        ``[k, c, j, i]`` layout; ``[G, i, j, k, c]`` (one spectrum per
        complex of a batched sweep) -> ``[G, k, c, j, i]``.  Once per
        complex."""
        Ht = (H.permute(2, 3, 1, 0) if H.ndim == 4
              else H.permute(0, 3, 4, 2, 1))
        return (Ht.real.to(self.dtype).contiguous(),
                Ht.imag.to(self.dtype).contiguous())

    def fused_D(self, HtRe: torch.Tensor, HtIm: torch.Tensor,
                vols: torch.Tensor):
        """``D (re, im) [b, K, X, Y]`` float32 via the fused kernel;
        ``HtRe/HtIm`` from :meth:`prep_H`, one spectrum or G of them.

        The z forward pass is an einsum emitting the kernel's
        ``[b, k, c, x, y]`` layout; the kernel fuses forward-y/x +
        coupling + inverse-x/y.
        """
        v = vols.to(self.dtype)
        are, aim = self._cast(_mm("bxyzc,zk->bkcxy", v, self.WzRe),
                              _mm("bxyzc,zk->bkcxy", v, self.WzIm))
        return fused_correlate(
            are.contiguous(), aim.contiguous(), HtRe, HtIm,
            self.WyRe, self.WyIm, self.WxRe, self.WxIm,
            self.UxRe, self.UxIm, self.UyRe, self.UyIm,
            layouts=self.k1_layouts)

    @functools.cached_property
    def k1_layouts(self):
        """K1's twiddles in the layouts of its tensor-core kernel
        (``fused.twiddle_layouts``; None where no kernel takes the
        shapes), made at the first use and kept: a sweep launches K1
        hundreds of times."""
        return twiddle_layouts(self.WyRe, self.WyIm, self.WxRe, self.WxIm,
                               self.UxRe, self.UxIm, self.UyRe, self.UyIm)

    def scores_fused(self, HtRe: torch.Tensor, HtIm: torch.Tensor,
                     vols: torch.Tensor) -> torch.Tensor:
        """Score volumes ``[b, L, L, L]`` via :meth:`fused_D` and the
        Hermitian kz -> z contraction."""
        Dre, Dim = self.fused_D(HtRe, HtIm, vols)
        return (_mm("bkxy,kz->bxyz", Dre, self.MzReOp)
                - _mm("bkxy,kz->bxyz", Dim, self.MzImOp))

    def inverse(self, gre: torch.Tensor, gim: torch.Tensor
                ) -> torch.Tensor:
        """irfftn of ``G (re, im) [B, L, L, L/2+1]`` as three axis
        contractions -> real ``[B, L, L, L]`` float32."""
        gre, gim = self._cast(gre, gim)
        cre, cim = self._cast(*_cmm("bijk,ix->bxjk", gre, gim,
                                    self.UxRe, self.UxIm))
        dre, dim = self._cast(*_cmm("bxjk,jy->bxyk", cre, cim,
                                    self.UyRe, self.UyIm))
        return (_mm("bxyk,kz->bxyz", dre, self.MzReOp)
                - _mm("bxyk,kz->bxyz", dim, self.MzImOp))


@functools.lru_cache(maxsize=8)
def _correlator(grid_size: int, lig_grid: int, dtype_name: str,
                device: str) -> DFTCorrelator:
    # Built as normal tensors even when first asked for inside a sweep's
    # inference_mode: refine saves these twiddles for backward.
    with torch.inference_mode(False):
        return DFTCorrelator(grid_size, lig_grid, _DTYPES[dtype_name],
                             device)


def get_correlator(grid_size: int, lig_grid: int,
                   dtype_name: str = "float32",
                   device: torch.device | str = "cpu") -> DFTCorrelator:
    """Correlator cached per (L, Ls, dtype, device)."""
    return _correlator(grid_size, lig_grid, dtype_name,
                       str(torch.device(device)))
