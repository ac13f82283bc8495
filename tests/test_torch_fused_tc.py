"""K1's tensor-core decomposition (``csrc/fused_correlate_tc.cu``) on
the CPU.

The CUDA kernel cannot run here, so this file holds its formulation:
``k1_route``'s rule over every box and even L it takes (its float32
edges are in ``tests/test_torch_fused_tf32.py``), the zero-padded
twiddle layouts of ``tc_operands``, the kernel's shared-memory rule
(``tc_smem_bytes``) at every even L, and a torch emulation of what the
kernel computes -- the box zero-padded to P, J, I, X' and Y' padded to
multiples of 16 (H read as 0 past J and I, D cropped to X' x Y'), the
forward y pass formed as B^T over every y and rounded once, F formed per
x tile of 64 rows and folded into G in float32 (boxes above 64), every
complex product as one real product with the block matrix ``[[Qre,
Qim], [-Qim, Qre]]``, B, G and C rounded to the operand type, float32
sums -- against the plain version (``fused_correlate_reference``) and
the JAX kernel in interpret mode, with planted errors (B^T rounded at a
y-tile boundary; H read with the padded row stride; G's padding left
NaN) that must move it.

Tolerances: float32, 2e-4 relative to max |D| (summation order only; a
sign, layout or padding error is O(1)); bf16, 2e-2 relative to max |D|
(the rounding points are the same on both sides, but another summation
order can move each rounded element of B, G or C by one bf16 ulp,
2^-8 relative).  The kernel itself is held against the plain version on
a card by ``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_, t_

from deeplocalproteindocking_torch.correlate import fused as tfused
from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_tpu.correlate import pallas_fused as jfused

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype,box,L,want", [
    (torch.bfloat16, 64, 128, "tc"),       # the largest tc box
    (torch.bfloat16, 32, 128, "tc"),       # the main path
    (torch.bfloat16, 40, 64, "tc"),
    (torch.bfloat16, 16, 32, "tc"),
    (torch.bfloat16, 72, 128, "tc"),       # boxes above 64: two x tiles
    (torch.bfloat16, 96, 128, "tc"),
    (torch.bfloat16, 128, 128, "tc"),      # the largest box
    (torch.float32, 32, 128, "tf32"),      # float32: its own kernel
    (torch.bfloat16, 32, 120, "tc"),       # L padded to 128 in the kernel
    (torch.bfloat16, 72, 120, "tc"),
    (torch.bfloat16, 40, 72, "tc"),
    (torch.bfloat16, 24, 50, "tc")])       # L = 2 mod 4
def test_k1_route(dtype, box, L, want):
    assert tfused.k1_route(dtype, box, box, L, L, L, L) == want


@pytest.mark.parametrize("dtype,box,L", [
    (torch.float64, 32, 128),              # no kernel takes the dtype
    (torch.bfloat16, 32, 144),             # L above 128
    (torch.bfloat16, 136, 128),            # a box above 128
    (torch.bfloat16, 16, 33)])             # an odd L
def test_k1_route_raises_where_no_kernel_takes_it(dtype, box, L):
    with pytest.raises(ValueError, match="no kernel takes"):
        tfused.k1_route(dtype, box, box, L, L, L, L)


def test_k1_route_checks_each_axis():
    bf = torch.bfloat16
    assert tfused.k1_route(bf, 64, 16, 32, 32, 32, 32) == "tc"
    assert tfused.k1_route(bf, 16, 65, 32, 32, 32, 32) == "tc"
    assert tfused.k1_route(bf, 128, 72, 128, 128, 128, 128) == "tc"
    assert tfused.k1_route(bf, 16, 16, 32, 24, 32, 32) == "tc"
    assert tfused.k1_route(bf, 16, 16, 32, 32, 40, 32) == "tc"
    for shape in ((16, 16, 32, 32, 32, 9), (16, 16, 32, 130, 32, 32),
                  (16, 16, 0, 32, 32, 32), (129, 16, 32, 32, 32, 32)):
        with pytest.raises(ValueError, match="no kernel takes"):
            tfused.k1_route(bf, *shape)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tc"),
                                        (torch.float32, "tf32")])
def test_k1_route_takes_every_box_to_the_tensor_cores(dtype, want):
    """Every box 1..L (X and Y apart) at every even L = 2..128 goes to
    the dtype's tensor-core kernel; another dtype raises."""
    for L in range(2, 129, 2):
        for box in range(1, L + 1):
            assert tfused.k1_route(dtype, box, box, L, L, L, L) == want
            assert tfused.k1_route(dtype, box, L, L, L, L, L) == want
            assert tfused.k1_route(dtype, L, box, L, L, L, L) == want
        with pytest.raises(ValueError, match="no kernel takes"):
            tfused.k1_route(torch.float64, L, L, L, L, L, L)


def test_tc_smem_fits():
    """The tc kernel's shared memory fits a Hopper block for every box up
    to 128 at every even L <= 128 (J, I, X' padded to 16: L = 128 is the
    largest): above 64 each of the slab's two buffers holds one x tile of
    64 rows."""
    for L in range(2, 129, 2):
        for box in range(1, 129):
            assert (tfused.tc_smem_bytes(box, box, L, L, L)
                    <= tfused.SMEM_OPTIN_BYTES)
    # Padded sizes: L = 120 takes L = 128's G_s and C_s, L = 50 L = 64's.
    for box in (16, 32, 72, 128):
        assert (tfused.tc_smem_bytes(box, box, 120, 120, 120)
                == tfused.tc_smem_bytes(box, box, 128, 128, 128))
        assert (tfused.tc_smem_bytes(box, box, 50, 50, 50)
                == tfused.tc_smem_bytes(box, box, 64, 64, 64))
    # L = 128: G_s and C_s 69,632 B each, A's two buffers 18,432 B each at
    # P = 64 and 34,816 B each at P = 128 (64 rows of 136).
    assert tfused.tc_smem_bytes(64, 64, 128, 128, 128) == 176_128
    assert tfused.tc_smem_bytes(128, 128, 128, 128, 128) == 208_896
    assert tfused.tc_smem_bytes(72, 20, 128, 128, 128) == 4 * (
        2 * 64 * 88 + 2 * 128 * 136)


def _args(L, Ls, C, b, dtype_name, seed):
    """K1's arguments in ``dtype_name`` from numpy: random A and H, the
    correlator's twiddles."""
    rng = np.random.default_rng(seed)
    K = L // 2 + 1
    corr = get_correlator(L, Ls, dtype_name)
    a = [torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(corr.dtype)
         for s in [(b, K, C, Ls, Ls)] * 2 + [(K, C, L, L)] * 2]
    return tuple(a) + (corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm,
                       corr.UxRe, corr.UxIm, corr.UyRe, corr.UyIm)


def _block_mm(Pre, Pim, Qre, Qim):
    """(Pre + i Pim)(Qre + i Qim) as the kernel's real MMAs: one real
    product of ``[Pre | Pim]`` with ``[[Qre, Qim], [-Qim, Qre]]``,
    operands upcast exactly, float32 sums.  Returns (re, im)."""
    lhs = torch.cat([Pre, Pim], dim=-1).float()
    rhs = torch.cat([torch.cat([Qre, Qim], dim=-1),
                     torch.cat([-Qim, Qre], dim=-1)], dim=-2).float()
    out = lhs @ rhs
    n = Qre.shape[-1]
    return out[..., :n], out[..., n:]


def tiles(P):
    """The kernels' tiles of a padded box edge P: ``(start, stop)`` of 64
    (the last P - 64 wide) above 64, else the whole edge."""
    return [(0, P)] if P <= 64 else [(0, 64), (64, P)]


def pad_h(H, J16, I16, mutate=None):
    """``H [.., J, I]`` as the kernels read it, ``[.., J16, I16]``: 0 at
    j >= J or i >= I.  ``"h_padded_stride"`` plants the error of reading
    row j of H at j I16 (the padded stride) instead of j I."""
    J, I = H.shape[-2:]
    if mutate == "h_padded_stride":
        flat = H.flatten(-2)
        flat = torch.nn.functional.pad(flat, (0, J16 * I16 - J * I))
        H = flat.unflatten(-1, (J16, I16))[..., :J, :I]
    return torch.nn.functional.pad(H, (0, I16 - I, 0, J16 - J))


def nan_pad(G, J, I, mutate):
    """``G [.., J16, I16]`` with its padding (j >= J or i >= I) set to NaN
    if ``mutate`` is ``"g_pad_nan"`` (stale shared memory), else as is."""
    if mutate != "g_pad_nan":
        return G
    G = G.clone()
    G[..., J:, :] = float("nan")
    G[..., :, I:] = float("nan")
    return G


def emulate_tc(Are, Aim, Hre, Him, *twiddles, round_y_tiles=False,
               mutate=None):
    """What ``fused_correlate_tc.cu`` computes, stage by stage, from the
    operands its wrapper hands it, J, I, X' and Y' padded to 16.
    ``round_y_tiles`` plants the error of rounding B^T's partial sum at
    each 64-wide y tile's end; ``mutate`` one of :func:`pad_h`'s or
    :func:`nan_pad`'s errors."""
    (WyTre, WyTim, WxTre, WxTim, UxTre, UxTim, UyTre,
     UyTim) = tfused.tc_operands(*twiddles)
    dt = Are.dtype
    P = WyTre.shape[1]
    X, Y = Are.shape[-2:]
    J, I = Hre.shape[-2:]
    Xp, Yp = twiddles[4].shape[1], twiddles[6].shape[1]

    def pad(a):                                   # [.., X, Y] -> [.., P, P]
        return torch.nn.functional.pad(a, (0, P - Y, 0, P - X))

    # 1. B^T[c, j, x] = Wy^T[j, y] A[c, x, y] over every y, float32 sums,
    #    rounded once (planted: rounded per y tile, summed, rounded).
    At = (pad(Are).mT, pad(Aim).mT)               # [.., y, x]
    if round_y_tiles:
        Btre = Btim = 0
        for y0, y1 in tiles(P):
            pr, pi = _block_mm(WyTre[:, y0:y1], WyTim[:, y0:y1],
                               At[0][..., y0:y1, :], At[1][..., y0:y1, :])
            Btre, Btim = Btre + pr.to(dt).float(), Btim + pi.to(dt).float()
    else:
        Btre, Btim = _block_mm(WyTre, WyTim, *At)
    Btre, Btim = Btre.to(dt), Btim.to(dt)
    # 2. Per x tile, F[c, j, i] = B^T[c, j, x] Wx[x, i] over the tile's x,
    #    folded into G = sum_c H conj(F) in float32; G rounded once.
    J16, I16 = WyTre.shape[0], WxTre.shape[0]
    Hr, Hi = (pad_h(h.float(), J16, I16, mutate) for h in (Hre, Him))
    Gre = Gim = 0
    for x0, x1 in tiles(P):
        Fre, Fim = _block_mm(Btre[..., x0:x1], Btim[..., x0:x1],
                             WxTre[:, x0:x1].mT, WxTim[:, x0:x1].mT)
        Gre = Gre + (Hr * Fre + Hi * Fim).sum(dim=2)
        Gim = Gim + (Hi * Fre - Hr * Fim).sum(dim=2)
    Gre, Gim = (nan_pad(x.to(dt), J, I, mutate) for x in (Gre, Gim))
    # 3. C[j, x'] = G[j, i] Ux[i, x'], rounded.
    Cre, Cim = _block_mm(Gre, Gim, UxTre.mT, UxTim.mT)
    Cre, Cim = Cre.to(dt), Cim.to(dt)
    # 4. D[x', y'] = C[j, x'] Uy[j, y'] over j, float32; stored at x' < X',
    #    y' < Y'.
    Dre, Dim = _block_mm(Cre.mT, Cim.mT, UyTre.mT, UyTim.mT)
    return Dre[..., :Xp, :Yp], Dim[..., :Xp, :Yp]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("L,Ls", [(32, 16), (32, 24), (48, 40), (120, 32),
                                  (72, 40), (50, 24)])
def test_tc_operands_layout(L, Ls):
    """Wy^T, Wx^T [L16, P] and Ux^T, Uy^T [L16, L16] (L16: L rounded up
    to 16): the transposed twiddles in the top-left corner, zeros in
    every padded row and column."""
    corr = get_correlator(L, Ls, "bfloat16")
    tw = (corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm, corr.UxRe, corr.UxIm,
          corr.UyRe, corr.UyIm)
    ops = tfused.tc_operands(*tw)
    P, L16 = -(-Ls // 16) * 16, -(-L // 16) * 16
    assert [tuple(o.shape) for o in ops] == [(L16, P)] * 4 + [(L16, L16)] * 4
    assert all(o.is_contiguous() and o.dtype == torch.bfloat16 for o in ops)
    for o, w in zip(ops, tw):
        n, k = w.shape[1], w.shape[0]
        assert torch.equal(o[:n, :k], w.T)
        assert not o[n:].any() and not o[:, k:].any()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("Ls,C", [(16, 1), (24, 3), (16, 2)])
def test_emulation_matches_plain(dtype_name, Ls, C):
    args = _args(32, Ls, C, 2, dtype_name, seed=Ls + C)
    got = emulate_tc(*args)
    want = tfused.fused_correlate_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype_name]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,Ls,C", [(96, 72, 2), (128, 96, 1),
                                    (128, 128, 1)])
def test_tiled_emulation_matches_plain(dtype_name, L, Ls, C):
    """Boxes above 64: two x tiles of F folded into G, B^T over both y
    tiles before its rounding."""
    args = _args(L, Ls, C, 1, dtype_name, seed=L + Ls + C)
    got = emulate_tc(*args)
    want = tfused.fused_correlate_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype_name]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("Ls,C", [(16, 3), (24, 1)])
def test_emulation_matches_pallas_interpret(dtype_name, Ls, C):
    _matches_pallas_interpret(dtype_name, 32, Ls, C, 2)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tiled_emulation_matches_pallas_interpret(dtype_name):
    """A box above 64: L = 96, box 72 (two x tiles, the last 16 rows)."""
    _matches_pallas_interpret(dtype_name, 96, 72, 1, 1)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,Ls,C,b", [(120, 32, 2, 2), (72, 40, 1, 2),
                                      (50, 24, 2, 3), (120, 72, 1, 1)])
def test_padded_emulation_matches_plain(dtype_name, L, Ls, C, b):
    """L not a multiple of 16 (120 and 72 padded to 128 and 80; 50 = 2
    mod 4, padded to 64): the kernel's padded stages, cropped, against
    the plain version."""
    args = _args(L, Ls, C, b, dtype_name, seed=L + Ls)
    got = emulate_tc(*args)
    want = tfused.fused_correlate_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype_name]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,Ls", [(120, 32), (50, 24)])
def test_padded_emulation_matches_pallas_interpret(dtype_name, L, Ls):
    _matches_pallas_interpret(dtype_name, L, Ls, 2, 1)


@pytest.mark.parametrize("mutate", ["h_padded_stride", "g_pad_nan"])
def test_padding_errors_move_the_emulation(mutate):
    """At L = 120: H read with the padded row stride moves D by O(1); G's
    padding left as stale NaN (not the exact zeros the kernel writes)
    turns D into NaN, though every padded twiddle is 0."""
    args = _args(120, 32, 2, 1, "bfloat16", seed=3)
    want = emulate_tc(*args)
    got = emulate_tc(*args, mutate=mutate)
    for g, w in zip(got, want):
        if mutate == "g_pad_nan":
            assert torch.isnan(g).any() and not torch.isnan(w).any()
        else:
            assert _rel(g, w) > 0.1


def _matches_pallas_interpret(dtype_name, L, Ls, C, b):
    args = _args(L, Ls, C, b, dtype_name, seed=10 + Ls + C)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    jargs = tuple(jnp.asarray(np_(a.float())).astype(jdt) for a in args)
    want = jfused.fused_correlate(*jargs, interpret=True)
    got = emulate_tc(*args)
    for g, w in zip(got, want):
        assert _rel(g, t_(w)) <= TOL[dtype_name]


def test_rounding_at_a_y_tile_boundary_moves_the_emulation():
    """B^T rounded to bf16 at the end of the first y tile as well as
    after the last (a rounding point the TPU kernel does not have) lands
    at least 5x farther from the plain version than the kernel's order,
    which differs from it only in float32 summation order; in float32 the
    same change moves nothing past 2e-6 (there is no rounding to move)."""
    args = _args(128, 96, 2, 1, "bfloat16", seed=11)
    want = tfused.fused_correlate_reference(*args)
    good = max(_rel(g, w) for g, w in zip(emulate_tc(*args), want))
    bad = max(_rel(g, w) for g, w in
              zip(emulate_tc(*args, round_y_tiles=True), want))
    assert good <= TOL["bfloat16"] and bad >= 5 * good
    f32 = tuple(a.float() for a in args)
    moved = max(_rel(g, w) for g, w in zip(
        emulate_tc(*f32, round_y_tiles=True), emulate_tc(*f32)))
    assert moved <= 2e-6


def test_emulation_rounds_where_the_kernel_rounds():
    """In bf16 the emulation differs from its float32 self on the same
    bf16 inputs (the cast points are there) by no more than bf16
    rounding."""
    args = _args(32, 24, 3, 2, "bfloat16", seed=7)
    got = emulate_tc(*args)
    want = emulate_tc(*(a.float() for a in args))
    for g, w in zip(got, want):
        assert 0 < (g - w).abs().max() <= TOL["bfloat16"] * w.abs().max()
