"""K1's float32 tensor-core kernel (``csrc/fused_correlate_tf32.cu``) on
the CPU.

The CUDA kernel cannot run here, so this file holds its formulation:
``k1_route``'s float32 edges, the TF32 split (``fused.tf32_split``) and
the zero-padded split layout of the twiddles (``fused.tf32_operands``),
the kernel's shared-memory rule (``fused.tf32_smem_bytes``, every box up
to 128 at every even L), a lane-level model of its m16n8k8 fragments
(loads, the k order, the chaining of one stage's sums into the next
stage's A operand), and a torch emulation of what it computes -- J, I,
X' and Y' padded to multiples of 16 (H read as 0 past J and I, D
cropped), every operand split into hi + lo by bit masking, every
contraction's k axis in the kernel's slot order on both sides, each real
product as hi*hi + hi*lo + lo*hi with float32 sums, boxes above 64 in
64 x 64 tiles of A (B^T summed over the y tiles, each x tile's F folded
into G) -- against the plain version (``fused_correlate_reference``) and
the JAX kernel in interpret mode, with one receptor spectrum and with
G = 2.

Tolerance: 5e-6 relative to max |D|.  3xTF32 drops only lo*lo (2^-22
relative per product) and rounds lo to TF32 (again ~2^-22 of x); over
the five stages and contractions of up to 128 terms, float32 summation
order included, that measured 2.9e-7 to 4.4e-7 at these shapes, so 5e-6
is ~10x the measured error and ~100x below single-pass TF32 (lo
dropped: 4.4e-4 to 6.7e-4); a sign, layout or k-order fault is O(1).
The kernel itself is held against the plain version on a card at 1e-4
by ``tests/test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_tc import nan_pad, pad_h
from torch_parity import np_, t_

from deeplocalproteindocking_torch.correlate import fused as tfused
from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_tpu.correlate import pallas_fused as jfused

TOL = 5e-6
SLOT = [0, 2, 4, 6, 1, 3, 5, 7]   # slot s of an 8-deep step holds k = SLOT[s]


# ---- the route ----

@pytest.mark.parametrize("box,L,want", [
    (64, 128, "tf32"),     # the largest tf32 box
    (32, 128, "tf32"),     # the bench box
    (40, 64, "tf32"),      # the v9p checkpoint's config
    (24, 64, "tf32"),      # band 100's boxes
    (16, 32, "tf32"),
    (65, 128, "tf32"),     # boxes above 64: 2 x 2 tiles of A
    (72, 128, "tf32"),
    (96, 128, "tf32"),
    (128, 128, "tf32"),
    (32, 120, "tf32"),     # L padded to 128 in the kernel
    (96, 120, "tf32"),
    (72, 120, "tf32"),     # the grid-120 float32 request's box
    (32, 72, "tf32"),
    (40, 98, "tf32")])     # L = 2 mod 4: D's rows 8-byte aligned only
def test_k1_route_float32(box, L, want):
    assert tfused.k1_route(torch.float32, box, box, L, L, L, L) == want


def test_k1_route_float32_checks_each_axis():
    f = torch.float32
    assert tfused.k1_route(f, 64, 16, 32, 32, 32, 32) == "tf32"
    assert tfused.k1_route(f, 16, 65, 32, 32, 32, 32) == "tf32"
    assert tfused.k1_route(f, 96, 128, 128, 128, 128, 128) == "tf32"
    assert tfused.k1_route(f, 16, 16, 24, 32, 32, 32) == "tf32"
    assert tfused.k1_route(f, 16, 16, 32, 32, 32, 8) == "tf32"
    for dtype, shape in ((f, (32, 32, 144, 144, 144, 144)),
                         (f, (16, 16, 32, 32, 32, 7)),
                         (torch.float64, (16, 16, 32, 32, 32, 32))):
        with pytest.raises(ValueError, match="no kernel takes"):
            tfused.k1_route(dtype, *shape)


# ---- the split and the layout ----

def test_tf32_split():
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.normal(size=4096)
                         * 10.0 ** rng.uniform(-6, 6, size=4096))
                        .astype(np.float32))
    hi, lo = tfused.tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    # Rounding to nearest, ties away from zero (cvt.rna), on both signs.
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                        1 + 3 * 2 ** -12])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10])
    assert torch.equal(tfused.tf32_split(tie)[0], want)


def decode(layout):
    """A split layout ``[N, 2K]`` -> (hi, lo) ``[N, K]`` as the kernel
    reads it: column pair q of a row at floats 4q..4q+3 = hi(2q),
    hi(2q+1), lo(2q), lo(2q+1)."""
    q = layout.reshape(layout.shape[0], -1, 4)
    return (q[..., :2].reshape(layout.shape[0], -1),
            q[..., 2:].reshape(layout.shape[0], -1))


def _twiddles(corr):
    return (corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm, corr.UxRe,
            corr.UxIm, corr.UyRe, corr.UyIm)


@pytest.mark.parametrize("L,Ls", [(32, 16), (32, 24), (64, 40), (128, 64),
                                  (120, 72), (98, 40)])
def test_tf32_operands_layout(L, Ls):
    corr = get_correlator(L, Ls, "float32")
    tw = _twiddles(corr)
    ops = tfused.tf32_operands(*tw)
    P, L16 = -(-Ls // 16) * 16, -(-L // 16) * 16
    assert [tuple(o.shape) for o in ops] == ([(L16, 2 * P)] * 4
                                             + [(L16, 2 * L16)] * 4)
    assert all(o.is_contiguous() and o.dtype == torch.float32 for o in ops)
    for o, w in zip(ops, tfused.tc_operands(*tw)):
        hi, lo = decode(o)
        assert torch.equal(hi, tfused.tf32_split(w)[0])
        assert torch.equal(lo, tfused.tf32_split(w)[1])
        assert ((hi + lo - w).abs() <= 2.0 ** -21 * w.abs()).all()
    for o, w in zip(ops, tw):                   # zero-padded
        n, k = w.shape[1], w.shape[0]
        assert torch.allclose(sum(decode(o))[:n, :k], w.T, rtol=0,
                              atol=1e-7)
        assert not o[:, 2 * k:].any() and not o[n:].any()


@pytest.mark.parametrize("L,Ls,dtype_name,route", [
    (32, 16, "float32", "tf32"), (64, 40, "float32", "tf32"),
    (32, 16, "bfloat16", "tc"), (96, 72, "float32", "tf32"),
    (120, 72, "float32", "tf32"), (120, 32, "bfloat16", "tc")])
def test_k1_layouts_made_once(L, Ls, dtype_name, route):
    """A correlator makes its twiddles' layouts for K1's route once (the
    v9p config launches K1 813 times per request) and keeps them."""
    corr = get_correlator(L, Ls, dtype_name)
    first = corr.k1_layouts
    assert corr.k1_layouts is first
    make = tfused.tf32_operands if route == "tf32" else tfused.tc_operands
    for o, w in zip(first, make(*_twiddles(corr))):
        assert torch.equal(o, w) and not o.requires_grad


@pytest.mark.parametrize("L", [64, 128])
def test_tf32_smem_fits(L):
    sizes = [tfused.tf32_smem_bytes(box, box, L, L) for box in range(16, 65)]
    assert max(sizes) <= tfused.SMEM_OPTIN_BYTES
    # L = 128, P = 64: G 139,264 B + the split slab 73,728 B.
    assert tfused.tf32_smem_bytes(64, 64, 128, 128) == 212_992
    assert tfused.tf32_smem_bytes(20, 64, L, L) == sizes[-1]


def test_tf32_smem_fits_every_box_and_l():
    """Every box up to 128 at every even L <= 128 fits a Hopper block (J
    and I padded to 16: L = 128 is the largest): above 64 the slab holds
    one 64 x 64 tile, so the size is that of a box of 64."""
    for box in (16, 72, 128):
        assert (tfused.tf32_smem_bytes(box, box, 120, 120)
                == tfused.tf32_smem_bytes(box, box, 128, 128))
    for L in range(2, 129, 2):
        for box in range(1, 129):
            assert (tfused.tf32_smem_bytes(box, box, L, L)
                    <= tfused.SMEM_OPTIN_BYTES)
    for box in (65, 72, 96, 128):
        assert tfused.tf32_smem_bytes(box, box, 128, 128) == 212_992


# ---- a lane-level model of the kernel's m16n8k8 fragments ----

def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4                    # g, t


def mma_lanes(a, b, c):
    """``mma.sync.m16n8k8.row.col`` on per-lane registers (a [32, 4],
    b [32, 2], c [32, 4]) by the PTX fragment layouts; returns d."""
    g, t = _lanes()
    A, B, Cm = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a.T
    B[t, g], B[t + 4, g] = b.T
    Cm[g, 2 * t], Cm[g, 2 * t + 1], Cm[g + 8, 2 * t], Cm[g + 8, 2 * t + 1] = c.T
    D = A @ B + Cm
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                     D[g + 8, 2 * t + 1]], axis=1)


def load_a(m, r0, k0):
    """The kernel's A-fragment rule on a row-major matrix: (a0, a2) the
    pair k0+2t, k0+2t+1 of row r0+g; (a1, a3) the same of row r0+g+8."""
    g, t = _lanes()
    k = k0 + 2 * t
    return np.stack([m[r0 + g, k], m[r0 + g + 8, k], m[r0 + g, k + 1],
                     m[r0 + g + 8, k + 1]], axis=1)


def load_b(m, n0, k0):
    """The kernel's B-fragment rule on an n-major matrix: the pair
    k0+2t, k0+2t+1 of row n0+g."""
    g, t = _lanes()
    return np.stack([m[n0 + g, k0 + 2 * t], m[n0 + g, k0 + 2 * t + 1]],
                    axis=1)


def from_sums(c, order=(0, 2, 1, 3)):
    """The kernel's ``from_sums``: a tile of sums as the next A fragment."""
    return c[:, list(order)]


def test_fragments_compute_the_product():
    """Loaded by the kernel's pair rule (k = 2t in slot t, 2t+1 in slot
    t+4) on both sides, one MMA is the plain product."""
    rng = np.random.default_rng(1)
    P, Q = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))   # Q: [n, k]
    d = mma_lanes(load_a(P, 0, 0), load_b(Q, 0, 0), np.zeros((32, 4)))
    want = load_a_sums(P @ Q.T)
    np.testing.assert_allclose(d, want, rtol=1e-12, atol=1e-12)


def load_a_sums(S):
    """A 16 x 8 matrix in the sums layout (c0..c3 per lane)."""
    g, t = _lanes()
    return np.stack([S[g, 2 * t], S[g, 2 * t + 1], S[g + 8, 2 * t],
                     S[g + 8, 2 * t + 1]], axis=1)


@pytest.mark.parametrize("order,chains", [((0, 2, 1, 3), True),
                                          ((0, 1, 2, 3), False)])
def test_sums_chain_into_the_next_stage(order, chains):
    """Stage 1's sums (c0, c2, c1, c3) are stage 2's A fragment with the
    B operand loaded by the same pair rule; the natural register order
    (c0, c1, c2, c3) is a planted error."""
    rng = np.random.default_rng(2)
    W, A, V = (rng.normal(size=s) for s in [(16, 8), (8, 8), (8, 8)])
    s1 = mma_lanes(load_a(W, 0, 0), load_b(A, 0, 0), np.zeros((32, 4)))
    s2 = mma_lanes(from_sums(s1, order), load_b(V, 0, 0), np.zeros((32, 4)))
    want = load_a_sums((W @ A.T) @ V.T)
    assert np.allclose(s2, want, rtol=1e-12, atol=1e-12) == chains


def test_split_layout_loads_are_fragments():
    """The kernel's float4 loads at ``(r0+g) ld + 2 k0 + 4 t`` of a split
    layout give the hi and lo parts of ``load_a``'s elements (A role:
    u.x, u.y = a0, a2; rows +8 a1, a3) and of ``load_b``'s (B role)."""
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.normal(size=(32, 24)).astype(np.float32))
    flat = tfused.tf32_layout(M).numpy().reshape(-1)
    hi, lo = (p.numpy() for p in tfused.tf32_split(M))
    ld = 2 * M.shape[1]
    g, t = _lanes()
    for r0, k0 in ((0, 0), (16, 8), (8, 16)):
        u = [flat[(r0 + g) * ld + 2 * k0 + 4 * t + e] for e in range(4)]
        v = [flat[(r0 + g + 8) * ld + 2 * k0 + 4 * t + e] for e in range(4)]
        np.testing.assert_array_equal(
            np.stack([u[0], v[0], u[1], v[1]], axis=1), load_a(hi, r0, k0))
        np.testing.assert_array_equal(
            np.stack([u[2], v[2], u[3], v[3]], axis=1), load_a(lo, r0, k0))
        np.testing.assert_array_equal(np.stack(u[:2], axis=1),
                                      load_b(hi, r0, k0))
        np.testing.assert_array_equal(np.stack(u[2:], axis=1),
                                      load_b(lo, r0, k0))


# ---- a torch emulation of the kernel ----

def slots(m):
    """``m``'s last axis (the contraction's k, a multiple of 8) in the
    kernel's slot order."""
    n = m.shape[-1]
    idx = torch.tensor([8 * (i // 8) + SLOT[i % 8] for i in range(n)])
    return m.index_select(-1, idx)


def cmm3(p, q, lo=True, perm=(True, True)):
    """Complex ``sum_k p[.., m, k] q[.., n, k]`` as the kernel runs it:
    ``p``, ``q`` each ((re hi, re lo), (im hi, im lo)); k in slot order
    on both sides (on one side only if ``perm`` says so, a planted
    error); each real product hi hi + hi lo + lo hi (hi hi alone if
    ``lo`` is False), float32 sums.  Returns (re, im)."""
    (pr, pi), (qr, qi) = (tuple(tuple(slots(x) if on else x for x in part)
                                for part in side)
                          for side, on in zip((p, q), perm))

    def mm3(a, b):
        (ah, al), (bh, bl) = a, b
        out = ah @ bh.mT
        return out + al @ bh.mT + ah @ bl.mT if lo else out

    return mm3(pr, qr) - mm3(pi, qi), mm3(pr, qi) + mm3(pi, qr)


def emulate_tf32(Are, Aim, Hre, Him, *twiddles, lo=True, permute=True,
                 mutate=None):
    """What ``fused_correlate_tf32.cu`` computes, stage by stage, from the
    operands its wrapper hands it, J, I, X' and Y' padded to 16; ``lo``
    and ``permute`` False plant the errors of dropping the lo parts and
    of twiddles read outside the slot order, ``mutate`` one of
    ``pad_h``'s or ``nan_pad``'s errors (``test_torch_fused_tc.py``)."""
    tw = [decode(o) for o in tfused.tf32_operands(*twiddles)]
    WyT, WxT, UxT, UyT = ((tw[n], tw[n + 1]) for n in range(0, 8, 2))
    P = WyT[0][0].shape[1]
    J, I = Hre.shape[-2:]
    Xp, Yp = twiddles[4].shape[1], twiddles[6].shape[1]
    edges = [(0, P)] if P <= 64 else [(0, 64), (64, P)]   # A's tiles
    X, Y = Are.shape[-2:]
    b, G = Are.shape[0], 1 if Hre.ndim == 4 else Hre.shape[0]

    def split(re, im):
        return tfused.tf32_split(re), tfused.tf32_split(im)

    def pad(a):                                  # [.., X, Y] -> [.., P, P]
        return torch.nn.functional.pad(a, (0, P - Y, 0, P - X))

    def cols(m, e):
        """Columns [e[0], e[1]) of every part of an operand."""
        return tuple(tuple(x[..., e[0]:e[1]] for x in part) for part in m)

    # 1. B^T[c, j, x] = sum_y Wy^T[j, y] A[c, x, y] (the twiddle is p),
    #    float32 sums over the y tiles.
    A = split(pad(Are), pad(Aim))
    Btr = Bti = 0
    for e in edges:
        pr, pi = cmm3(cols(WyT, e), cols(A, e), lo=lo, perm=(permute, True))
        Btr, Bti = Btr + pr, Bti + pi
    # 2. Per x tile, F[c, j, i] = sum_x B^T[c, j, x] Wx^T[i, x] over the
    #    tile's x; G += H conj(F).
    kw = dict(lo=lo, perm=(True, permute))
    J16, I16 = WyT[0][0].shape[0], WxT[0][0].shape[0]
    Hr, Hi = (pad_h(h, J16, I16, mutate).reshape(
        (G, 1) + h.shape[-4:-2] + (J16, I16)) for h in (Hre, Him))
    Gre = Gim = 0
    for e in edges:
        Fre, Fim = cmm3(split(Btr[..., e[0]:e[1]], Bti[..., e[0]:e[1]]),
                        cols(WxT, e), **kw)
        grouped = (G, b // G) + Fre.shape[1:]
        Fre, Fim = Fre.reshape(grouped), Fim.reshape(grouped)
        Gre = Gre + (Hr * Fre + Hi * Fim).sum(dim=3).flatten(0, 1)
        Gim = Gim + (Hi * Fre - Hr * Fim).sum(dim=3).flatten(0, 1)
    # 3. C[j, x'] = sum_i G[j, i] Ux^T[x', i].
    Gre, Gim = (nan_pad(x, J, I, mutate) for x in (Gre, Gim))
    Cre, Cim = cmm3(split(Gre, Gim), UxT, **kw)
    # 4. D[x', y'] = sum_j C^T[x', j] Uy^T[y', j], stored at x' < X',
    #    y' < Y'.
    Dre, Dim = cmm3(split(Cre.mT, Cim.mT), UyT, **kw)
    return Dre[..., :Xp, :Yp], Dim[..., :Xp, :Yp]


def _args(L, Ls, C, b, G, seed):
    """K1's float32 arguments from numpy: random A and H (G spectra, or
    one in the 4-D form if G is None), the correlator's twiddles."""
    rng = np.random.default_rng(seed)
    K = L // 2 + 1
    lead = () if G is None else (G,)
    a = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
         for s in [(b, K, C, Ls, Ls)] * 2 + [lead + (K, C, L, L)] * 2]
    return tuple(a) + _twiddles(get_correlator(L, Ls, "float32"))


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("L,Ls,C,G", [(32, 16, 1, None), (32, 24, 3, None),
                                      (48, 40, 2, None), (32, 16, 2, 2),
                                      (32, 20, 3, 2)])
def test_emulation_matches_plain(L, Ls, C, G):
    args = _args(L, Ls, C, 4, G, seed=L + Ls + C)
    got = emulate_tf32(*args)
    want = tfused.fused_correlate_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("L,Ls,C,G,b", [(96, 72, 2, None, 1),
                                        (128, 96, 1, None, 1),
                                        (128, 128, 1, None, 1),
                                        (96, 80, 1, 2, 2)])
def test_tiled_emulation_matches_plain(L, Ls, C, G, b):
    """Boxes above 64 (A in 64 x 64 tiles, the last 16 or 32 wide at
    boxes 72 and 96) against the plain version."""
    args = _args(L, Ls, C, b, G, seed=L + Ls + C)
    got = emulate_tf32(*args)
    want = tfused.fused_correlate_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("Ls,C,G", [(16, 3, None), (24, 1, None),
                                    (16, 2, 2)])
def test_emulation_matches_pallas_interpret(Ls, C, G):
    _matches_pallas_interpret(32, Ls, C, G, 4)


@pytest.mark.parametrize("L,Ls,C,G,b", [(120, 72, 1, None, 1),
                                        (120, 32, 2, 2, 2),
                                        (72, 40, 2, None, 2),
                                        (98, 40, 1, None, 1),
                                        (50, 24, 3, 2, 4)])
def test_padded_emulation_matches_plain(L, Ls, C, G, b):
    """L not a multiple of 16 (120, 72, 98 = 2 mod 4, 50), J, I, X', Y'
    padded to 16 in the kernel, one receptor spectrum or two."""
    args = _args(L, Ls, C, b, G, seed=L + Ls + C)
    got = emulate_tf32(*args)
    want = tfused.fused_correlate_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("L,Ls,G", [(120, 32, None), (50, 24, 2)])
def test_padded_emulation_matches_pallas_interpret(L, Ls, G):
    _matches_pallas_interpret(L, Ls, 2, G, 2)


@pytest.mark.parametrize("mutate", ["h_padded_stride", "g_pad_nan"])
def test_padding_errors_move_the_emulation(mutate):
    """At L = 98: H read with the padded row stride moves D by O(1); G's
    padding left as stale NaN turns D into NaN."""
    args = _args(98, 24, 2, 1, None, seed=4)
    want = emulate_tf32(*args)
    got = emulate_tf32(*args, mutate=mutate)
    for g, w in zip(got, want):
        if mutate == "g_pad_nan":
            assert torch.isnan(g).any() and not torch.isnan(w).any()
        else:
            assert _rel(g, w) > 0.1


def test_tiled_emulation_matches_pallas_interpret():
    """A box above 64: L = 96, box 72 (2 x 2 tiles, the last 16 wide)."""
    _matches_pallas_interpret(96, 72, 1, None, 1)


def _matches_pallas_interpret(L, Ls, C, G, b):
    args = _args(L, Ls, C, b, G, seed=20 + Ls + C)
    jargs = [jnp.asarray(np_(a)) for a in args]
    if G is None:
        want = jfused.fused_correlate(*jargs, interpret=True)
    else:
        jargs[0] = jargs[0].reshape((G, b // G) + jargs[0].shape[1:])
        jargs[1] = jargs[1].reshape(jargs[0].shape)
        want = jax.vmap(lambda are, aim, hre, him: jfused.fused_correlate(
            are, aim, hre, him, *jargs[4:], interpret=True))(*jargs[:4])
    got = emulate_tf32(*args)
    for g, w in zip(got, want):
        assert _rel(g, t_(w).reshape(g.shape)) <= TOL


def test_planted_errors_move_the_emulation():
    """Dropping the lo parts (single-pass TF32) lands at least 10x farther
    from the plain version than 3xTF32, and over the tolerance; twiddles
    read outside the slot order give an O(1) error."""
    args = _args(32, 24, 3, 2, 2, seed=5)
    want = tfused.fused_correlate_reference(*args)
    full = max(_rel(g, w) for g, w in zip(emulate_tf32(*args), want))
    no_lo = max(_rel(g, w) for g, w in
                zip(emulate_tf32(*args, lo=False), want))
    unperm = max(_rel(g, w) for g, w in
                 zip(emulate_tf32(*args, permute=False), want))
    assert full <= TOL
    assert no_lo >= 10 * full and no_lo > TOL
    assert unperm > 0.1
