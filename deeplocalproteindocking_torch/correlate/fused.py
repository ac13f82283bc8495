"""K1: fused forward-y/x + channel coupling + inverse-x/y correlator.

Port of ``deeplocalproteindocking_tpu/correlate/pallas_fused.py``.  Per
(kz frequency, rotation):

    B[c,x,j]  = sum_y A[c,x,y] Wy[y,j]          forward y   (rounded)
    F[c,j,i]  = sum_x B[c,x,j] Wx[x,i]          forward x   (float32)
    G[j,i]    = sum_c H[c,j,i] conj(F[c,j,i])   coupling    (rounded)
    C[j,x']   = sum_i G[j,i]   Ux[i,x']         inverse x   (rounded)
    D[x',y']  = sum_j C[j,x']  Uy[j,y']         inverse y   (float32)

"rounded" = cast back to the operand dtype, as the TPU kernel casts.
``H`` is one coupled receptor spectrum for all b rows, or G of them
(``[G, K, C, J, I]``, G dividing b): rows ``[g b/G, (g+1) b/G)``
correlate against ``H[g]``, the rule K2's bias groups follow, so one
launch serves a batched sweep step of G complexes.
:func:`fused_correlate` runs the plain version
:func:`fused_correlate_reference` for CPU tensors and launches one of two
hand-written CUDA kernels for CUDA tensors, chosen by :func:`k1_route`
from the dtype alone, for ligand boxes X, Y <= 128 and even I, J, X', Y'
up to 128 (every grid the ``dft_fused`` engine takes):

- ``"tc"`` (``csrc/fused_correlate_tc.cu``): bf16 on the tensor cores
  (``mma.sync``) -- the main path.  Its twiddles go in the layouts of
  :func:`tc_operands`; boxes above 64 run as two x tiles of A
  (:func:`tc_smem_bytes`).
- ``"tf32"`` (``csrc/fused_correlate_tf32.cu``): float32 on the tensor
  cores (``wgmma``), each real product as three TF32 products of hi/lo
  splits (3xTF32) -- every float32 config the repository ships.  Its
  twiddles go in the step images of :func:`tf32_operands`, streamed
  through a ring in shared memory; boxes above 64 run as 2 x 2 tiles of
  A (:func:`tf32_plan`, :func:`tf32_smem_bytes`).

Both pad J, I, X' and Y' inside the kernel (grid 120, say; tc to a
multiple of 16, tf32 to 64 or 128): the twiddles come zero-padded to
that size, H is read as 0 past J and I (never copied), and D is stored
only below X' and Y'.

A tensor-core route's twiddle layouts (:func:`twiddle_layouts`) are
made once by a caller that launches often (``DFTCorrelator.k1_layouts``)
and passed in, or made at each launch when not given.  A CUDA tensor
never falls back: the routed kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from deeplocalproteindocking_torch import _build
from deeplocalproteindocking_torch.correlate._contract import cmm

_ROUTES = {torch.bfloat16: "tc", torch.float32: "tf32"}   # by dtype
_MAX_L = 128                   # also the largest box of every route
_TILE = 64                     # the tensor-core kernels' A tile edge
_SLOT = (0, 2, 4, 6, 1, 3, 5, 7)   # slot s of a tf32 step holds k = _SLOT[s]
SMEM_OPTIN_BYTES = 232_448     # shared memory a Hopper block may opt in to

# Kernel launches since the last reset (the main path's proof of use):
# every K1 launch, and those of each tensor-core kernel alone.
launches = 0
launches_tc = 0
launches_tf32 = 0


def h_groups(Hre: torch.Tensor, b: int) -> int:
    """G, the number of receptor spectra in ``Hre`` (``[K, C, J, I]``:
    1; ``[G, K, C, J, I]``: G).  Raises unless the rank is 4 or 5 and G
    divides the b rows."""
    if Hre.ndim not in (4, 5):
        raise ValueError(f"fused_correlate: H must be [K, C, J, I] or "
                         f"[G, K, C, J, I], got {tuple(Hre.shape)}")
    G = 1 if Hre.ndim == 4 else Hre.shape[0]
    if G < 1 or b % G:
        raise ValueError(f"fused_correlate: {G} receptor spectra do not "
                         f"divide b={b} rows")
    return G


def fused_correlate_reference(Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm,
                              UxRe, UxIm, UyRe, UyIm):
    """Plain torch version: the same formulas and rounding points as
    the TPU kernel, as float32 einsums over the whole batch, the b rows
    taken as ``(G, b/G)`` against G receptor spectra."""
    dt = Are.dtype
    b = Are.shape[0]
    G = h_groups(Hre, b)
    Bre, Bim = cmm("bkcxy,yj->bkcxj", Are, Aim, WyRe, WyIm)
    Bre, Bim = Bre.to(dt), Bim.to(dt)
    Fre, Fim = cmm("bkcxj,xi->bkcji", Bre, Bim, WxRe, WxIm)
    grouped = (G, b // G) + Fre.shape[1:]
    Fre, Fim = Fre.reshape(grouped), Fim.reshape(grouped)
    Hr = Hre.to(torch.float32).reshape((G, 1) + Hre.shape[-4:])
    Hi = Him.to(torch.float32).reshape((G, 1) + Him.shape[-4:])
    Gre = (Hr * Fre + Hi * Fim).sum(dim=3).to(dt).flatten(0, 1)
    Gim = (Hi * Fre - Hr * Fim).sum(dim=3).to(dt).flatten(0, 1)
    Cre, Cim = cmm("bkji,ix->bkjx", Gre, Gim, UxRe, UxIm)
    Cre, Cim = Cre.to(dt), Cim.to(dt)
    return cmm("bkjx,jy->bkxy", Cre, Cim, UyRe, UyIm)


def _route(dtype, X, Y, I, J, Xp, Yp):
    """:func:`k1_route`'s answer, or None where no kernel takes the
    dtype and shapes."""
    if (0 < max(X, Y) <= _MAX_L
            and all(0 < n <= _MAX_L and n % 2 == 0 for n in (I, J, Xp, Yp))):
        return _ROUTES.get(dtype)
    return None


def k1_route(dtype, X, Y, I, J, Xp, Yp) -> str:
    """``"tc"`` or ``"tf32"``: the kernel K1 launches for CUDA tensors.

    A ligand box with X, Y <= 128 and even I, J, X', Y' no larger than
    128 goes to the tensor cores: ``"tc"`` in bf16, ``"tf32"`` in
    float32.  Raises ``ValueError`` for any other dtype or shape: no
    kernel takes it.
    """
    route = _route(dtype, X, Y, I, J, Xp, Yp)
    if route is None:
        raise ValueError(
            f"fused_correlate: no kernel takes {dtype} at X={X}, Y={Y}, "
            f"I={I}, J={J}, X'={Xp}, Y'={Yp} (float32 or bfloat16, boxes "
            f"up to {_MAX_L}, even I, J, X', Y' up to {_MAX_L})")
    return route


def _up16(n) -> int:
    """``n`` rounded up to a multiple of 16."""
    return -(-n // 16) * 16


def _padded_box(X, Y) -> int:
    """P: the larger of X and Y rounded up to 16."""
    return _up16(max(X, Y))


def tc_operands(WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe, UyIm):
    """The tensor-core kernel's twiddles, zero-padded: ``Wy^T [J16, P]``
    and ``Wx^T [I16, P]`` (P = the larger of X and Y rounded up to 16),
    ``Ux^T [X'16, I16]`` and ``Uy^T [Y'16, J16]``, where N16 is N rounded
    up to 16; all contiguous.  Each is an MMA operand stored with its
    contraction axis innermost."""
    P = _padded_box(WyRe.shape[0], WxRe.shape[0])

    def pad_t(w, cols):
        """``w^T`` zero-padded to ``[rows rounded up to 16, cols]``."""
        n, k = w.shape[1], w.shape[0]
        return torch.nn.functional.pad(
            w.T, (0, cols - k, 0, _up16(n) - n)).contiguous()

    I16, J16 = _up16(WxRe.shape[1]), _up16(WyRe.shape[1])
    return (pad_t(WyRe, P), pad_t(WyIm, P), pad_t(WxRe, P), pad_t(WxIm, P),
            pad_t(UxRe, I16), pad_t(UxIm, I16), pad_t(UyRe, J16),
            pad_t(UyIm, J16))


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` float32 with ``x ~ hi + lo``: ``hi`` is ``x`` rounded
    to TF32 (10 mantissa bits; to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``; the low 13 bits zero) and ``lo`` the rest
    rounded the same way."""
    def rna(v):
        u = v.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def tf32_plan(X, Y, J, I, Xp, Yp):
    """The tf32 kernel's tile plan (``Plan`` in
    ``csrc/fused_correlate_tf32.cu``): ``(P, T, kL, kNI, ring)`` -- the
    padded box P (the larger of X and Y rounded up to 16), A's tile edge
    T = min(P, 64), the grid edge kL that J, I, X' and Y' are padded to
    (64, or 128 if any of them or P is above 64), the columns of i per
    stage-2 chunk and the number of slots in the twiddles' ring."""
    P = _padded_box(X, Y)
    T = min(P, _TILE)
    kL = 64 if max(J, I, Xp, Yp, P) <= 64 else 128
    kNI = 64 if kL == 128 and T < _TILE else 32
    ring = 2 if T == 64 else 3 if (T == 48 and kL == 128) else 4
    return P, T, kL, kNI, ring


def tf32_tiles(m: torch.Tensor, slots: bool) -> torch.Tensor:
    """``[N, K]`` float32 (N, K multiples of 8) -> the tf32 kernel's
    tiles of its K/8 steps, ``[K/8, 2, N/8, 2, 8, 4]``: per 8-deep step
    of k, the hi and the lo part (:func:`tf32_split`) of the step's N x
    8 block, each 8-row group as two 8 x 4 core matrices (k 0-3, k 4-7;
    the K-major layout ``wgmma`` reads without swizzle).  ``slots``: each
    step's k in the kernel's slot order (slot s holds k ``_SLOT[s]``),
    for a product whose other operand's fragments hold k = 2t in slot t
    and 2t+1 in slot t+4."""
    N, K = m.shape
    if slots:
        m = m.index_select(1, torch.tensor(
            [8 * (q // 8) + _SLOT[q % 8] for q in range(K)],
            device=m.device))
    return torch.stack([
        p.reshape(N // 8, 8, K // 8, 2, 4).permute(2, 0, 3, 1, 4)
        for p in tf32_split(m)], dim=1).contiguous()


def tf32_operands(WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe, UyIm):
    """The tf32 kernel's twiddles as the images of its ring's steps
    (:func:`tf32_tiles` of the zero-padded transposes; P, kL, kNI from
    :func:`tf32_plan`): ``Wy^T [kL, P]`` as ``[P/8, 16 kL]`` (one step a
    row, k = y in natural order), ``Wx^T [kL, P]`` in chunks of kNI rows
    as ``[kL/kNI * P/8, 16 kNI]`` (chunk-major, k = x in slot order),
    ``Ux^T [kL, kL]`` and ``Uy^T [kL, kL]`` as ``[kL/8, 16 kL]`` (k = i,
    j in slot order); all contiguous."""
    P, _, kL, kNI, _ = tf32_plan(WxRe.shape[0], WyRe.shape[0],
                                 WyRe.shape[1], WxRe.shape[1],
                                 UxRe.shape[1], UyRe.shape[1])

    def padded_t(w, rows, cols):
        """``w^T`` zero-padded to ``[rows, cols]``."""
        return torch.nn.functional.pad(
            w.T, (0, cols - w.shape[0], 0, rows - w.shape[1]))

    def wy(w):
        return tf32_tiles(padded_t(w, kL, P), False).reshape(P // 8, -1)

    def wx(w):
        chunks = padded_t(w, kL, P).reshape(kL // kNI, kNI, P)
        return torch.stack([tf32_tiles(c, True) for c in chunks]).reshape(
            kL // kNI * P // 8, -1)

    def u(w):
        return tf32_tiles(padded_t(w, kL, kL), True).reshape(kL // 8, -1)

    return (wy(WyRe), wy(WyIm), wx(WxRe), wx(WxIm), u(UxRe), u(UxIm),
            u(UyRe), u(UyIm))


def layout_shapes(route, X, Y, J, I, Xp, Yp):
    """The shapes of :func:`twiddle_layouts`' eight tensors for
    ``route``."""
    if route == "tc":
        P, J16, I16 = _padded_box(X, Y), _up16(J), _up16(I)
        return (((J16, P),) * 2 + ((I16, P),) * 2
                + ((_up16(Xp), I16),) * 2 + ((_up16(Yp), J16),) * 2)
    P, _, kL, kNI, _ = tf32_plan(X, Y, J, I, Xp, Yp)
    return (((P // 8, 16 * kL),) * 2 + ((kL // kNI * P // 8, 16 * kNI),) * 2
            + ((kL // 8, 16 * kL),) * 4)


def twiddle_layouts(WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe, UyIm):
    """The twiddles in the layouts of the kernel :func:`k1_route` picks
    for their dtype and shapes: :func:`tc_operands` for ``"tc"``,
    :func:`tf32_operands` for ``"tf32"``; None where no kernel takes
    them (the plain version reads them as they are).  Made as normal
    tensors outside autograd, so they may be kept across inference and
    training calls."""
    tw = (WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe, UyIm)
    route = _route(WyRe.dtype, WxRe.shape[0], WyRe.shape[0],
                   WxRe.shape[1], WyRe.shape[1], UxRe.shape[1],
                   UyRe.shape[1])
    if route is None:
        return None
    with torch.inference_mode(False), torch.no_grad():
        return tc_operands(*tw) if route == "tc" else tf32_operands(*tw)


def tc_smem_bytes(X, Y, J, I, Xp) -> int:
    """Dynamic shared memory of one tc-kernel block (``smem_bytes`` in
    ``csrc/fused_correlate_tc.cu``), bf16 (re, im): two buffers of the x
    tile of the ligand slab ``[T, P+8]`` (T = min(P, 64) rows, the whole
    padded y range; one is filled by cp.async while the other is read),
    G ``[J16, I16+8]`` and C^T ``[X'16, J16+8]`` (N16: N rounded up to
    16)."""
    P = _padded_box(X, Y)
    J, I, Xp = _up16(J), _up16(I), _up16(Xp)
    return 2 * 2 * (2 * min(P, _TILE) * (P + 8) + J * (I + 8)
                    + Xp * (J + 8))


def tf32_smem_bytes(X, Y, J, I, Xp, Yp) -> int:
    """Dynamic shared memory of one tf32-kernel block (``Plan::kSmem`` in
    ``csrc/fused_correlate_tf32.cu``; :func:`tf32_plan`): G ``[kL, kL]``
    float32 (re, im; C^T later in its place), A's tile ``[T, T]`` (re and
    im, hi and lo), the ring's slots (re and im halves of 16 kL floats)
    and a full and an empty mbarrier per slot."""
    _, T, kL, _, ring = tf32_plan(X, Y, J, I, Xp, Yp)
    return 4 * (2 * kL * kL + 4 * T * T + 2 * ring * 16 * kL) + 16 * ring


def _launch_tc(ops, dims, Dre, Dim):
    """``csrc/fused_correlate_tc.cu`` (bf16) on ``ops``: A and H as
    :func:`fused_correlate` takes them, then the twiddles in
    :func:`tc_operands`' layouts.  Raises before the launch if a block
    would need more shared memory than Hopper gives one."""
    global launches, launches_tc
    _, _, _, X, Y, J, I, Xp, _ = dims
    smem = tc_smem_bytes(X, Y, J, I, Xp)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"fused_correlate: the tc kernel needs {smem} B of shared "
            f"memory per block at X={X}, Y={Y}, J={J}, I={I}, X'={Xp}, "
            f"more than the {SMEM_OPTIN_BYTES} B a block may have")
    with torch.cuda.device(ops[0].device):
        err = _build.library().dlpd_fused_correlate_tc(
            *(t.data_ptr() for t in ops), Dre.data_ptr(), Dim.data_ptr(),
            *dims, h_groups(ops[2], dims[0]), _build.stream(ops[0]))
    _build.check(err, "fused_correlate_tc")
    launches += 1
    launches_tc += 1


def _launch_tf32(ops, dims, Dre, Dim):
    """``csrc/fused_correlate_tf32.cu`` (float32) on ``ops``: A and H as
    :func:`fused_correlate` takes them, then the twiddles in
    :func:`tf32_operands`' layouts.  Raises before the launch if a block
    would need more shared memory than Hopper gives one, or if H is not
    8-byte aligned (the kernel reads it in pairs)."""
    global launches, launches_tf32
    b, _, _, X, Y, J, I, Xp, Yp = dims
    smem = tf32_smem_bytes(X, Y, J, I, Xp, Yp)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"fused_correlate: the tf32 kernel needs {smem} B of shared "
            f"memory per block at X={X}, Y={Y}, J={J}, I={I}, X'={Xp}, "
            f"Y'={Yp}, more than the {SMEM_OPTIN_BYTES} B a block may have")
    for name, h in (("Hre", ops[2]), ("Him", ops[3])):
        if h.data_ptr() % 8:
            raise ValueError(f"fused_correlate: {name} is not 8-byte "
                             f"aligned")
    with torch.cuda.device(ops[0].device):
        err = _build.library().dlpd_fused_correlate_tf32(
            *(t.data_ptr() for t in ops), Dre.data_ptr(), Dim.data_ptr(),
            *dims, h_groups(ops[2], b), _build.stream(ops[0]))
    _build.check(err, "fused_correlate_tf32")
    launches += 1
    launches_tf32 += 1


def fused_correlate(Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm,
                    UxRe, UxIm, UyRe, UyIm, layouts=None):
    """``(Dre, Dim) [b, K, X', Y']`` float32.

    ``Are/Aim [b, K, C, X, Y]`` z-transformed ligand volumes;
    ``Hre/Him [K, C, J, I]`` coupled receptor spectrum
    (``DFTCorrelator.prep_H``), or ``[G, K, C, J, I]`` with G dividing b
    (row ``bb`` correlates against ``H[bb // (b/G)]``); twiddles
    ``Wy [Y, J]``, ``Wx [X, I]``, ``Ux [I, X']``, ``Uy [J, Y']``; all of
    one dtype (float32 or bfloat16) and device.  ``layouts``:
    :func:`twiddle_layouts` of these twiddles, made once by a caller
    that launches often; made here when not given.
    """
    args = (Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm, UxRe, UxIm, UyRe,
            UyIm)
    h_groups(Hre, Are.shape[0])
    if Are.device.type == "cpu":
        return fused_correlate_reference(*args)
    if Are.device.type != "cuda":
        raise ValueError(f"fused_correlate: no kernel for device "
                         f"{Are.device}")
    b, K, C, X, Y = Are.shape
    J, I = WyRe.shape[1], WxRe.shape[1]
    Xp, Yp = UxRe.shape[1], UyRe.shape[1]
    if Are.dtype not in _ROUTES:
        raise TypeError(f"fused_correlate: kernel takes float32 or "
                        f"bfloat16, got {Are.dtype}")
    if max(I, Xp, Yp, J) > _MAX_L:
        raise ValueError(f"fused_correlate: kernel takes L <= {_MAX_L}, "
                         f"got J={J}, I={I}, X'={Xp}, Y'={Yp}")
    names = ("Are", "Aim", "Hre", "Him", "WyRe", "WyIm", "WxRe", "WxIm",
             "UxRe", "UxIm", "UyRe", "UyIm")
    h_shape = tuple(Hre.shape[:-4]) + (K, C, J, I)
    shapes = ((b, K, C, X, Y),) * 2 + (h_shape,) * 2 + (
        (Y, J),) * 2 + ((X, I),) * 2 + ((I, Xp),) * 2 + ((J, Yp),) * 2
    _build.check_tensors("fused_correlate", Are.device, Are.dtype,
                         zip(names, args, shapes))
    Dre = torch.empty((b, K, Xp, Yp), dtype=torch.float32,
                      device=Are.device)
    Dim = torch.empty_like(Dre)
    dims = (b, K, C, X, Y, J, I, Xp, Yp)
    route = k1_route(Are.dtype, X, Y, I, J, Xp, Yp)
    if layouts is None:
        layouts = twiddle_layouts(*args[4:])
    _build.check_tensors("fused_correlate", Are.device, Are.dtype, zip(
        ("WyTre", "WyTim", "WxTre", "WxTim", "UxTre", "UxTim", "UyTre",
         "UyTim"), layouts, layout_shapes(route, X, Y, J, I, Xp, Yp)))
    launch = _launch_tc if route == "tc" else _launch_tf32
    launch(args[:4] + tuple(layouts), dims, Dre, Dim)
    return Dre, Dim
