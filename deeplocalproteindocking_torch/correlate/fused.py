"""K1: fused forward-y/x + channel coupling + inverse-x/y correlator.

Port of ``deeplocalproteindocking_tpu/correlate/pallas_fused.py``.  Per
(kz frequency, rotation):

    B[c,x,j]  = sum_y A[c,x,y] Wy[y,j]          forward y   (rounded)
    F[c,j,i]  = sum_x B[c,x,j] Wx[x,i]          forward x   (float32)
    G[j,i]    = sum_c H[c,j,i] conj(F[c,j,i])   coupling    (rounded)
    C[j,x']   = sum_i G[j,i]   Ux[i,x']         inverse x   (rounded)
    D[x',y']  = sum_j C[j,x']  Uy[j,y']         inverse y   (float32)

"rounded" = cast back to the operand dtype, as the TPU kernel casts.
:func:`fused_correlate` runs the plain version
:func:`fused_correlate_reference` for CPU tensors and launches one of two
hand-written CUDA kernels for CUDA tensors, chosen by :func:`k1_route`
from dtype and shapes alone:

- ``"tc"`` (``csrc/fused_correlate_tc.cu``): bf16 on the tensor cores
  (``mma.sync``), for ligand boxes X, Y <= 64 and I, J, X', Y' multiples
  of 16 up to 128 -- the main path.  Its twiddles go in the layouts of
  :func:`tc_operands`.
- ``"simt"`` (``csrc/fused_correlate.cu``): float32 FMA loops, for
  float32 and every other shape up to L = 128.  Its shared memory
  (:func:`simt_smem_bytes`) does not grow with the ligand box's area.

A CUDA tensor never falls back: the routed kernel launches or the call
raises.
"""
from __future__ import annotations

import torch

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate._contract import cmm

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_L = 128
_TC_MAX_BOX = 64
_SIMT_JT = 8                   # the SIMT kernel's j rows per tile (kJT)
SMEM_OPTIN_BYTES = 232_448     # shared memory a Hopper block may opt in to

# Kernel launches since the last reset (the main path's proof of use):
# every K1 launch, and those of the tensor-core kernel alone.
launches = 0
launches_tc = 0


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


def k1_route(dtype, X, Y, I, J, Xp, Yp) -> str:
    """``"tc"`` or ``"simt"``: the kernel K1 launches for CUDA tensors.

    ``"tc"`` iff the operands are bf16, the ligand box has X, Y <= 64,
    and I, J, X', Y' are multiples of 16 no larger than 128.
    """
    if (dtype == torch.bfloat16 and max(X, Y) <= _TC_MAX_BOX
            and all(n > 0 and n % 16 == 0 and n <= _MAX_L
                    for n in (I, J, Xp, Yp))):
        return "tc"
    return "simt"


def tc_operands(WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe, UyIm):
    """The tensor-core kernel's twiddles: ``Wy^T [J, P]`` and
    ``Wx^T [I, P]`` zero-padded to ``P`` = the larger of X and Y rounded
    up to 16, ``Ux^T [X', I]`` and ``Uy^T [Y', J]``, all contiguous.
    Each is an MMA operand stored with its contraction axis innermost."""
    P = -(-max(WyRe.shape[0], WxRe.shape[0]) // 16) * 16

    def pad_t(w):
        return torch.nn.functional.pad(w.T, (0, P - w.shape[0])).contiguous()

    return (pad_t(WyRe), pad_t(WyIm), pad_t(WxRe), pad_t(WxIm),
            UxRe.T.contiguous(), UxIm.T.contiguous(), UyRe.T.contiguous(),
            UyIm.T.contiguous())


def simt_smem_bytes(X, I, Xp, Yp, dtype) -> int:
    """Dynamic shared memory of one SIMT-kernel block (``smem_bytes`` in
    ``csrc/fused_correlate.cu``): the float32 D accumulator ``[X', Y']``
    (re, im) and the B, G, C and Uy tiles of 8 rows in the operand
    dtype.  The ligand slab A is read from device memory, so only X of
    the box counts."""
    elt = torch.empty((), dtype=dtype).element_size()
    return 2 * 4 * Xp * Yp + 2 * elt * _SIMT_JT * (X + I + Xp + Yp)


def _launch_simt(args, dims, Dre, Dim):
    """``csrc/fused_correlate.cu`` on ``args`` as :func:`fused_correlate`
    takes them; ``dims = (b, K, C, X, Y, J, I, Xp, Yp)``.  Raises before
    the launch if a block would need more shared memory than Hopper
    gives one."""
    global launches
    _, _, _, X, _, _, I, Xp, Yp = dims
    smem = simt_smem_bytes(X, I, Xp, Yp, args[0].dtype)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"fused_correlate: the SIMT kernel needs {smem} B of shared "
            f"memory per block at X={X}, I={I}, X'={Xp}, Y'={Yp}, more "
            f"than the {SMEM_OPTIN_BYTES} B a block may have")
    dev = args[0].device
    with torch.cuda.device(dev):
        err = _build.library().dlpd_fused_correlate(
            _KERNEL_DTYPES[args[0].dtype], *(t.data_ptr() for t in args),
            Dre.data_ptr(), Dim.data_ptr(), *dims,
            _build.stream(args[0]))
    _build.check(err, "fused_correlate")
    launches += 1


def _launch_tc(args, dims, Dre, Dim):
    """``csrc/fused_correlate_tc.cu`` on the same ``args`` (bf16), with
    the twiddles put in :func:`tc_operands`' layouts."""
    global launches, launches_tc
    dev = args[0].device
    ops = args[:4] + tc_operands(*args[4:])
    with torch.cuda.device(dev):
        err = _build.library().dlpd_fused_correlate_tc(
            *(t.data_ptr() for t in ops), Dre.data_ptr(), Dim.data_ptr(),
            *dims, _build.stream(args[0]))
    _build.check(err, "fused_correlate_tc")
    launches += 1
    launches_tc += 1


def fused_correlate(Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm,
                    UxRe, UxIm, UyRe, UyIm):
    """``(Dre, Dim) [b, K, X', Y']`` float32.

    ``Are/Aim [b, K, C, X, Y]`` z-transformed ligand volumes;
    ``Hre/Him [K, C, J, I]`` coupled receptor spectrum
    (``DFTCorrelator.prep_H``); twiddles ``Wy [Y, J]``, ``Wx [X, I]``,
    ``Ux [I, X']``, ``Uy [J, Y']``; all of one dtype (float32 or
    bfloat16) and device.
    """
    args = (Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe,
            UyIm)
    if Are.device.type == "cpu":
        return fused_correlate_reference(*args)
    if Are.device.type != "cuda":
        raise ValueError(f"fused_correlate: no kernel for device "
                         f"{Are.device}")
    b, K, C, X, Y = Are.shape
    J, I = WyRe.shape[1], WxRe.shape[1]
    Xp, Yp = UxRe.shape[1], UyRe.shape[1]
    if Are.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_correlate: kernel takes float32 or "
                        f"bfloat16, got {Are.dtype}")
    if max(I, Xp, Yp, J) > _MAX_L:
        raise ValueError(f"fused_correlate: kernel takes L <= {_MAX_L}, "
                         f"got J={J}, I={I}, X'={Xp}, Y'={Yp}")
    names = ("Are", "Aim", "Hre", "Him", "WyRe", "WyIm", "WxRe", "WxIm",
             "UxRe", "UxIm", "UyRe", "UyIm")
    shapes = ((b, K, C, X, Y),) * 2 + ((K, C, J, I),) * 2 + (
        (Y, J),) * 2 + ((X, I),) * 2 + ((I, Xp),) * 2 + ((J, Yp),) * 2
    _build.check_tensors("fused_correlate", Are.device, Are.dtype,
                         zip(names, args, shapes))
    Dre = torch.empty((b, K, Xp, Yp), dtype=torch.float32,
                      device=Are.device)
    Dim = torch.empty_like(Dre)
    launch = (_launch_tc if k1_route(Are.dtype, X, Y, I, J, Xp, Yp) == "tc"
              else _launch_simt)
    launch(args, (b, K, C, X, Y, J, I, Xp, Yp), Dre, Dim)
    return Dre, Dim
