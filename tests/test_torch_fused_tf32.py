"""K1's float32 tensor-core kernel (``csrc/fused_correlate_tf32.cu``) on
the CPU.

The CUDA kernel cannot run here, so this file holds its formulation:
``k1_route``'s float32 edges, the TF32 split (``fused.tf32_split``), the
tile plan (``fused.tf32_plan``) and the images of the ring's steps that
the twiddles are handed in (``fused.tf32_operands``: per 8-deep step, hi
and lo tiles of 8-row groups of two 8 x 4 core matrices, k in the
kernel's slot order where the other operand comes from registers), the
kernel's shared-memory rule (``fused.tf32_smem_bytes``, every box up to
128 at every even L), the order in which its producer streams the
images through the ring, a lane-level model of the ``wgmma`` fragments
(A from registers in each warp's m16n8k8 layout, B read from a step's
tile by the core-matrix rule; the chaining of one stage's sums into the
next stage's A operand; G's swizzle), and a torch emulation of what it
computes -- J, I, X' and Y' padded to kL (64 or 128; H read as 0 past J
and I, D cropped), every operand split into hi + lo by bit masking, the
slot order on both sides of stages 2-4, each real product as hi*hi +
hi*lo + lo*hi with float32 sums, boxes above 64 in 64 x 64 tiles of A
(B^T summed over the y tiles, each x tile's F folded into G) -- against
the plain version (``fused_correlate_reference``) and the JAX kernel in
interpret mode, with one receptor spectrum and with G = 2.

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


# ---- the split, the plan and the step images ----

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


def tile_at(r, k):
    """The kernel's ``tile_at``: float offset of (row r, slot k < 8) in a
    step's tile (8-row groups of two 8 x 4 core matrices)."""
    return (((r >> 3) * 2 + (k >> 2)) * 8 + (r & 7)) * 4 + (k & 3)


def untile(img, rows, depth):
    """A ``[.., 16 rows]``-per-step image of ``depth / 8`` steps -> (hi,
    lo) ``[rows, depth]``, column q the k the kernel's slot q of its step
    holds (in slot order where the image is)."""
    x = img.reshape(depth // 8, 2, rows // 8, 2, 8, 4)
    return tuple(x[:, h].permute(1, 3, 0, 2, 4).reshape(rows, depth)
                 for h in (0, 1))


def untile_wx(img, kL, kNI, P):
    """Wx^T's image (chunks of kNI rows) -> (hi, lo) ``[kL, P]``."""
    parts = [untile(c, kNI, P) for c in img.reshape(kL // kNI, -1)]
    return tuple(torch.cat([p[h] for p in parts]) for h in (0, 1))


def _twiddles(corr):
    return (corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm, corr.UxRe,
            corr.UxIm, corr.UyRe, corr.UyIm)


def decoded(twiddles):
    """``fused.tf32_operands``' images as (hi, lo) matrices: Wy^T [kL,
    P] (natural order), Wx^T [kL, P], Ux^T and Uy^T [kL, kL] (slot
    order), re and im each."""
    Y, J = twiddles[0].shape
    X, I = twiddles[2].shape
    Xp, Yp = twiddles[4].shape[1], twiddles[6].shape[1]
    P, _, kL, kNI, _ = tfused.tf32_plan(X, Y, J, I, Xp, Yp)
    ops = tfused.tf32_operands(*twiddles)
    return ([untile(o, kL, P) for o in ops[:2]]
            + [untile_wx(o, kL, kNI, P) for o in ops[2:4]]
            + [untile(o, kL, kL) for o in ops[4:]])


@pytest.mark.parametrize("L,Ls", [(32, 16), (32, 24), (64, 40), (128, 64),
                                  (120, 72), (98, 40)])
def test_tf32_operands_layout(L, Ls):
    corr = get_correlator(L, Ls, "float32")
    tw = _twiddles(corr)
    ops = tfused.tf32_operands(*tw)
    assert [tuple(o.shape) for o in ops] == list(
        tfused.layout_shapes("tf32", Ls, Ls, L, L, L, L))
    assert all(o.is_contiguous() and o.dtype == torch.float32 for o in ops)
    P, _, kL, _, _ = tfused.tf32_plan(Ls, Ls, L, L, L, L)
    for n, ((hi, lo), w) in enumerate(zip(decoded(tw), tw)):
        if n >= 2:                                # slot order: undo it
            hi, lo = unslots(hi), unslots(lo)
        want = torch.zeros((kL, P if n < 4 else kL))
        want[:w.shape[1], :w.shape[0]] = w.T      # zero-padded transpose
        assert torch.equal(hi, tfused.tf32_split(want)[0])
        assert torch.equal(lo, tfused.tf32_split(want)[1])
        assert ((hi + lo - want).abs() <= 2.0 ** -21 * want.abs()).all()


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


@pytest.mark.parametrize("box,L,plan", [
    (40, 128, (48, 48, 128, 64, 3)),      # the full-sweep shape
    (48, 128, (48, 48, 128, 64, 3)),
    (40, 64, (48, 48, 64, 32, 4)),        # the v9p checkpoint's
    (32, 128, (32, 32, 128, 64, 4)),      # the bench box
    (16, 32, (16, 16, 64, 32, 4)),
    (64, 128, (64, 64, 128, 32, 2)),
    (72, 64, (80, 64, 128, 32, 2)),       # a box above 64: kL = 128
    (72, 120, (80, 64, 128, 32, 2)),
    (40, 98, (48, 48, 128, 64, 3))])
def test_tf32_plan(box, L, plan):
    assert tfused.tf32_plan(box, box, L, L, L, L) == plan


@pytest.mark.parametrize("L", [64, 128])
def test_tf32_smem_fits(L):
    sizes = [tfused.tf32_smem_bytes(box, box, L, L, L, L)
             for box in range(16, 65)]
    assert max(sizes) <= tfused.SMEM_OPTIN_BYTES
    # L = 128, box 40-48: G 131,072 B + A's tile 36,864 + 3 slots of
    # 16,384 + 6 barriers.
    assert tfused.tf32_smem_bytes(40, 40, 128, 128, 128, 128) == 217_136
    assert tfused.tf32_smem_bytes(20, 64, L, L, L, L) == sizes[-1]


def test_tf32_smem_fits_every_box_and_l():
    """Every box up to 128 at every even L <= 128 fits a Hopper block,
    and a kL = 64 block (boxes up to 64 at L up to 64) fits two to an
    SM (228 KiB, 1 KiB reserved a block); above 64 the tile is 64 x 64,
    so the size is that of a box of 64."""
    for box in (16, 72, 128):
        assert (tfused.tf32_smem_bytes(box, box, 120, 120, 120, 120)
                == tfused.tf32_smem_bytes(box, box, 128, 128, 128, 128))
    for L in range(2, 129, 2):
        for box in range(1, 129):
            n = tfused.tf32_smem_bytes(box, box, L, L, L, L)
            assert n <= tfused.SMEM_OPTIN_BYTES
            if tfused.tf32_plan(box, box, L, L, L, L)[2] == 64:
                assert 2 * (n + 1024) <= 228 * 1024
    for box in (65, 72, 96, 128):
        assert (tfused.tf32_smem_bytes(box, box, 128, 128, 128, 128)
                == 229_408)


def ring_steps(X, Y, J, I, Xp, Yp, C):
    """The producer's loads, in order: ``(image, first float, floats)``
    of each step (the kernel's producer loop), re and im alike."""
    P, T, kL, kNI, _ = tfused.tf32_plan(X, Y, J, I, Xp, Yp)
    NT = -(-P // T)
    per = kL // kNI                      # x steps a Wx slot
    steps = []
    for _ in range(C):
        for xt in range(NT):
            xw = T if xt + 1 < NT else P - T * (NT - 1)
            for yt in range(NT):
                yw = T if yt + 1 < NT else P - T * (NT - 1)
                steps += [("wy", (T * yt // 8 + ky) * 16 * kL, 16 * kL)
                          for ky in range(yw // 8)]
            for ic in range(kL // kNI):
                for q0 in range(0, xw // 8, per):
                    nq = min(per, xw // 8 - q0)
                    steps.append(("wx", (ic * (P // 8) + T * xt // 8 + q0)
                                  * 16 * kNI, nq * 16 * kNI))
    steps += [("ux", ki * 16 * kL, 16 * kL) for ki in range(kL // 8)]
    steps += [("uy", kj * 16 * kL, 16 * kL) for kj in range(kL // 8)]
    return steps


@pytest.mark.parametrize("L,Ls,C", [(128, 40, 2), (64, 40, 3), (120, 72, 1),
                                    (128, 128, 1), (98, 40, 1), (32, 16, 1)])
def test_ring_streams_each_image_once_a_channel(L, Ls, C):
    """The producer's steps fit a slot (16 kL floats a half), lie inside
    their image, and cover each image: Wy^T and Wx^T once a channel and x
    tile (Wy^T once a y tile), Ux^T and Uy^T once; 16-byte aligned."""
    P, T, kL, kNI, _ = tfused.tf32_plan(Ls, Ls, L, L, L, L)
    ops = dict(zip(("wy", "wx", "ux", "uy"),
                   tfused.tf32_operands(*_twiddles(get_correlator(
                       L, Ls, "float32")))[::2]))
    seen = {name: torch.zeros(o.numel(), dtype=torch.int64)
            for name, o in ops.items()}
    for name, first, n in ring_steps(Ls, Ls, L, L, L, L, C):
        assert 0 < n <= 16 * kL and first % 4 == 0 and n % 4 == 0
        assert first + n <= ops[name].numel()
        seen[name][first:first + n] += 1
    NT = -(-P // T)
    assert (seen["wy"] == C * NT).all() and (seen["wx"] == C).all()
    assert (seen["ux"] == 1).all() and (seen["uy"] == 1).all()


# ---- a lane-level model of the kernel's wgmma fragments ----

def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4                    # g, t


def wgmma_lanes(a, tile, c):
    """``wgmma.m64nNk8`` (tf32, A from registers) on per-thread registers:
    ``a [128, 4]`` (warp w's rows 16w.. in the m16n8k8 layout), ``tile``
    the B operand's step tile as the kernel's descriptor reads it (N rows
    x 8 k, :func:`tile_at`), ``c [128, N/2]``; returns d."""
    g, t = _lanes()
    N = tile.size // 8
    A, B, Cm = np.zeros((64, 8)), np.zeros((N, 8)), np.zeros((64, N))
    for w in range(4):
        r, lanes = 16 * w + g, slice(32 * w, 32 * w + 32)
        (A[r, t], A[r + 8, t], A[r, t + 4],
         A[r + 8, t + 4]) = a[lanes].T
    for n in range(N):
        for k in range(8):
            B[n, k] = tile[tile_at(n, k)]
    rows, cols = _acc_positions(N)
    Cm[rows, cols] = c
    D = A @ B.T + Cm
    return D[rows, cols]


def _acc_positions(N):
    """(row, column) of each thread's accumulator e of a 64 x N tile: row
    16w + g (+8 for e % 4 >= 2), column 8 (e // 4) + 2t + e % 2."""
    lane = np.arange(128)
    w, g, t = lane // 32, (lane % 32) // 4, lane % 4
    e = np.arange(N // 2)
    rows = (16 * w + g)[:, None] + 8 * ((e // 2) % 2)[None, :]
    cols = 8 * (e // 4)[None, :] + 2 * t[:, None] + (e % 2)[None, :]
    return rows, cols


def load_f32(m, r0, k0):
    """The kernel's ``load_f32`` on a [64, K] matrix (its swizzle aside):
    thread (w, g, t) takes the pair k0+2t, k0+2t+1 of rows 16w+g and
    16w+g+8 as (a0, a2) and (a1, a3): k = 2t in slot t, 2t+1 in slot
    t+4."""
    lane = np.arange(128)
    w, g, t = lane // 32, (lane % 32) // 4, lane % 4
    r, k = r0 + 16 * w + g, k0 + 2 * t
    return np.stack([m[r, k], m[r + 8, k], m[r, k + 1], m[r + 8, k + 1]],
                    axis=1)


def image_tile(m, slots):
    """An [N, 8] block as a step's tile (``fused.tf32_tiles``' hi part,
    the values exact in TF32)."""
    tiles = tfused.tf32_tiles(torch.as_tensor(m, dtype=torch.float32),
                              slots)
    return tiles[0, 0].reshape(-1).numpy().astype(np.float64)


def test_fragments_compute_the_product():
    """A fragment loaded by the kernel's pair rule (k = 2t in slot t,
    2t+1 in slot t+4) against a tile in slot order is the plain product
    (stages 3 and 4); against a tile in natural order it is not."""
    rng = np.random.default_rng(1)
    Pm = rng.integers(-8, 9, size=(64, 8)).astype(np.float64)
    Q = rng.integers(-8, 9, size=(32, 8)).astype(np.float64)   # [n, k]
    rows, cols = _acc_positions(32)
    want = (Pm @ Q.T)[rows, cols]
    d = wgmma_lanes(load_f32(Pm, 0, 0), image_tile(Q, True),
                    np.zeros((128, 16)))
    np.testing.assert_allclose(d, want, rtol=0, atol=0)
    d = wgmma_lanes(load_f32(Pm, 0, 0), image_tile(Q, False),
                    np.zeros((128, 16)))
    assert np.abs(d - want).max() > 1


def from_sums(c, order=(0, 2, 1, 3)):
    """The kernel's ``from_sums`` on 8 columns of sums ``c [128, 4]``."""
    return c[:, list(order)]


@pytest.mark.parametrize("order,chains", [((0, 2, 1, 3), True),
                                          ((0, 1, 2, 3), False)])
def test_sums_chain_into_the_next_stage(order, chains):
    """Stage 1's sums (c0, c2, c1, c3 of each 8 columns) are stage 2's A
    fragments against Wx^T's tile in slot order; the natural register
    order (c0, c1, c2, c3) is a planted error."""
    rng = np.random.default_rng(2)
    W = rng.integers(-4, 5, size=(64, 8)).astype(np.float64)
    A = rng.integers(-4, 5, size=(16, 8)).astype(np.float64)   # [x, y]
    V = rng.integers(-4, 5, size=(16, 16)).astype(np.float64)  # [i, x]
    s1 = wgmma_lanes(load_natural(W), image_tile(A, False),
                     np.zeros((128, 8)))
    s2 = np.zeros((128, 8))
    for q in range(2):                           # the two 8-deep x steps
        s2 = wgmma_lanes(from_sums(s1[:, 4 * q:4 * q + 4], order),
                         image_tile(V[:, 8 * q:8 * q + 8], True), s2)
    rows, cols = _acc_positions(16)
    want = ((W @ A.T) @ V.T)[rows, cols]
    assert np.allclose(s2, want, rtol=0, atol=0) == chains


def load_natural(m):
    """A fragment with k in natural order (a0 k = t, a2 k = t + 4), as the
    kernel's ``load_tile`` gives stage 1's Wy^T."""
    lane = np.arange(128)
    w, g, t = lane // 32, (lane % 32) // 4, lane % 4
    r = 16 * w + g
    return np.stack([m[r, t], m[r + 8, t], m[r, t + 4], m[r + 8, t + 4]],
                    axis=1)


@pytest.mark.parametrize("r0", [0, 16, 48, 64, 112])
def test_tile_loads_are_fragments(r0):
    """The kernel's ``load_tile`` (rows r0.., thread (g, t) of a warp at
    r0/8 * 64 + 4g + t, then +64, +32, +96 for a1, a2, a3, the lo tile
    8 kL floats on) on a step of Wy^T's image gives the natural-order
    fragments of the step's hi and lo parts."""
    kL, P = 128, 48
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.normal(size=(kL, P)).astype(np.float32))
    img = tfused.tf32_tiles(M, False).reshape(P // 8, -1).numpy()
    hi, lo = (p.numpy() for p in tfused.tf32_split(M))
    g, t = _lanes()
    for ky in range(P // 8):
        base = (r0 >> 3) * 64 + 4 * g + t
        for part, want in ((0, hi), (8 * kL, lo)):
            got = np.stack([img[ky, part + base + o]
                            for o in (0, 64, 32, 96)], axis=1)
            r, k = r0 + g, 8 * ky + t
            np.testing.assert_array_equal(got, np.stack(
                [want[r, k], want[r + 8, k], want[r, k + 4],
                 want[r + 8, k + 4]], axis=1))


def swz(r, c, ld):
    """The kernel's ``swz``: G's and C^T's 8-column groups XOR-swizzled by
    row."""
    return r * ld + (c ^ ((r & 3) << 3))


@pytest.mark.parametrize("kL", [64, 128])
def test_g_swizzle_is_conflict_free(kL):
    """``swz`` permutes each row, keeps a fragment's pair (2t, 2t+1)
    adjacent, and the half-warps' 8-byte accesses of the fold and of
    ``load_f32`` (rows g, g + 8; columns k0 + 2t, +1) hit 32 distinct
    banks; unswizzled they meet 4-way."""
    r = np.arange(kL)[:, None]
    c = np.arange(kL)[None, :]
    idx = swz(r, c, kL)
    assert (np.sort(idx % kL, axis=1) == np.arange(kL)).all()
    assert (idx // kL == r).all()
    lane = np.arange(16)                        # a half-warp of 8-byte loads
    g, t = lane // 4, lane % 4
    for r0 in range(0, kL, 16):
        for k0 in range(0, kL, 8):
            for half in (0, 8):
                rows = r0 + g + half
                banks = np.concatenate([swz(rows, k0 + 2 * t, kL) % 32,
                                        swz(rows, k0 + 2 * t + 1, kL) % 32])
                assert len(set(banks)) == 32
                plain = np.concatenate([(rows * kL + k0 + 2 * t) % 32,
                                        (rows * kL + k0 + 2 * t + 1) % 32])
                assert len(set(plain)) == 8


# ---- a torch emulation of the kernel ----

def slots(m):
    """``m``'s last axis (the contraction's k, a multiple of 8) in the
    kernel's slot order."""
    n = m.shape[-1]
    idx = torch.tensor([8 * (i // 8) + SLOT[i % 8] for i in range(n)])
    return m.index_select(-1, idx)


def unslots(m):
    """The inverse of :func:`slots`."""
    n = m.shape[-1]
    idx = torch.tensor([8 * (i // 8) + SLOT.index(i % 8) for i in range(n)])
    return m.index_select(-1, idx)


def cmm3(p, q, lo=True, perm=False):
    """Complex ``sum_k p[.., m, k] q[.., n, k]`` as the kernel runs it:
    ``p``, ``q`` each ((re hi, re lo), (im hi, im lo)); ``q`` as the
    image holds it; ``perm``: ``p``'s k put in slot order (the register
    side of a product with a slot-ordered image); each real product hi
    hi + hi lo + lo hi (hi hi alone if ``lo`` is False), float32 sums.
    Returns (re, im)."""
    if perm:
        p = tuple(tuple(slots(x) for x in part) for part in p)
    (pr, pi), (qr, qi) = p, q

    def mm3(a, b):
        (ah, al), (bh, bl) = a, b
        out = ah @ bh.mT
        return out + al @ bh.mT + ah @ bl.mT if lo else out

    return mm3(pr, qr) - mm3(pi, qi), mm3(pr, qi) + mm3(pi, qr)


def emulate_tf32(Are, Aim, Hre, Him, *twiddles, lo=True, permute=True,
                 mutate=None):
    """What ``fused_correlate_tf32.cu`` computes, stage by stage, from the
    operands its wrapper hands it, J, I, X' and Y' padded to kL; ``lo``
    and ``permute`` False plant the errors of dropping the lo parts and
    of the register side read outside the slot order, ``mutate`` one of
    ``pad_h``'s or ``nan_pad``'s errors (``test_torch_fused_tc.py``)."""
    tw = decoded(twiddles)
    WyT, WxT, UxT, UyT = ((tw[n], tw[n + 1]) for n in range(0, 8, 2))
    kL, P = WyT[0][0].shape
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

    # 1. B^T[c, j, x] = sum_y Wy^T[j, y] A[c, x, y] (k = y in natural
    #    order on both sides), float32 sums over the y tiles.
    A = split(pad(Are), pad(Aim))
    Btr = Bti = 0
    for e in edges:
        pr, pi = cmm3(cols(WyT, e), cols(A, e), lo=lo)
        Btr, Bti = Btr + pr, Bti + pi
    # 2. Per x tile, F[c, j, i] = sum_x B^T[c, j, x] Wx^T[i, x] over the
    #    tile's x; G += H conj(F).
    kw = dict(lo=lo, perm=permute)
    Hr, Hi = (pad_h(h, kL, kL, mutate).reshape(
        (G, 1) + h.shape[-4:-2] + (kL, kL)) for h in (Hre, Him))
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
