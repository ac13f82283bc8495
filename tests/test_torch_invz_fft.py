"""K2's FFT route (``csrc/invz_blockmax_fft.cu``) on the CPU, and the
port's entry points defaulting to the card.

The CUDA kernel cannot run here, so this file holds its formulation: a
torch emulation of its stages -- the Hermitian packing of the half
spectrum into a complex sequence of length M = L/2, the M = 8 x Q split
(radix-8 butterflies over k1, the twiddle e^{+2 pi i k2 n1 / M}, radix-Q
over k2 -- Q = 2, 4, 6 or 8 at L = 32, 64, 96 or 128, radix 6 as two
radix-3 DFTs and a radix-2 step -- output digit n = n1 + 8 n2), the
even/odd interleave with 1/L, the bias and the 32-wide block max --
against the plain version (``invz_blockmax_reference``, the dense Mz
contraction) and the JAX kernel in interpret mode; a sign or index error
in the packing or in the radix-2 and radix-3 stages moves the result by
O(1); and ``k2_route``'s rule (L = 32, 64, 96, 128; other L raise).

Tolerance: 1e-5 relative to max |finite block max| (float32; the FFT
and the dense contraction round in another order, O(1e-6) at L = 128).
The kernel itself is held against the plain version on a card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fft_emulation import c2r_columns
from torch_parity import np_, t_

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate import invz_topk as tinvz
from deeplocalproteindocking_torch.correlate.dft import (
    get_correlator, hermitian_inverse_z)
from deeplocalproteindocking_torch.pipeline import (DockingPipeline,
                                                    dock_score_mask)
from deeplocalproteindocking_torch.serving import DockingService
from deeplocalproteindocking_tpu.correlate import dft as jdft
from deeplocalproteindocking_tpu.correlate import pallas_invz_topk as jinvz

TOL = 1e-5


def emulate_fft(Dre, Dim, bias, mutate=None):
    """What ``invz_blockmax_fft.cu`` computes, stage by stage, in
    complex64: the c2r along kz (``fft.cuh``), then the bias and the
    block max.  ``mutate`` plants one error (for the O(1) test)."""
    b, K, X, Y = Dre.shape
    L = 2 * (K - 1)
    D = torch.complex(Dre, Dim).reshape(b, K, X * Y)
    S = c2r_columns(D, mutate).reshape(b, L, X, Y)
    S = S.permute(0, 2, 3, 1)                          # [b, X, Y, z]
    G = bias.shape[0]
    S = S.reshape(G, b // G, X, Y, L) + bias[:, None]
    return S.reshape(b, X, Y // tinvz.YB, tinvz.YB, L).amax(dim=3)


def _inputs(L, b, G, X=8, Y=64, seed=0):
    """Random D (numpy float32, imaginary parts at kz = 0 and L/2
    included), the c2r Mz, and a bias of G groups that masks about 40%
    of the cells and one whole 32-wide y run."""
    rng = np.random.default_rng(seed)
    K = L // 2 + 1
    Dre, Dim = (rng.normal(size=(b, K, X, Y)).astype(np.float32)
                for _ in range(2))
    MzRe, MzIm = hermitian_inverse_z(L)
    bias = np.where(rng.random((G, X, Y, L)) < 0.6, 0.0,
                    -np.inf).astype(np.float32)
    bias[0, 3, 0:32, 5] = -np.inf
    return Dre, Dim, MzRe, MzIm, bias


def _assert_close(got, want):
    got, want = np_(got), np_(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert got[0, 3, 0, 5] == -np.inf
    err = np.abs(got[fin] - want[fin]).max() / np.abs(want[fin]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("L", [32, 64, 96, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_emulation_matches_plain(L, G):
    Dre, Dim, MzRe, MzIm, bias = _inputs(L, 4, G, seed=L + G)
    want = tinvz.invz_blockmax_reference(t_(Dre), t_(Dim), t_(MzRe),
                                         t_(MzIm), t_(bias))
    got = emulate_fft(t_(Dre), t_(Dim), t_(bias))
    assert got.shape == want.shape == (4, 8, 2, L)
    _assert_close(got, want)


@pytest.mark.parametrize("L", [32, 64, 96, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_emulation_matches_pallas_interpret(L, G):
    Dre, Dim, MzRe, MzIm, bias = _inputs(L, 2, G, seed=10 + L + G)
    want = jinvz.invz_blockmax(*(jnp.asarray(a) for a in
                                 (Dre, Dim, MzRe, MzIm, bias)),
                               interpret=True)
    got = emulate_fft(t_(Dre), t_(Dim), t_(bias))
    _assert_close(got, t_(want))


@pytest.mark.parametrize("mutate", ["no_conj", "minus_i", "mirror_index",
                                    "digit_order"])
def test_packing_errors_move_the_result(mutate):
    """The emulation is sharp: one planted error moves the block maxima
    by O(1) of their scale, far outside TOL."""
    Dre, Dim, _, _, _ = _inputs(128, 2, 1, seed=3)
    bias = torch.zeros(1, 8, 64, 128)
    want = emulate_fft(t_(Dre), t_(Dim), bias)
    got = emulate_fft(t_(Dre), t_(Dim), bias, mutate=mutate)
    assert ((got - want).abs().max() / want.abs().max()).item() > 0.1


@pytest.mark.parametrize("mutate", ["radix3_sign", "radix6_digit_order"])
def test_radix3_errors_move_the_result(mutate):
    """At L = 96 the radix-Q pass is ``idft<6>``: the cube root of unity
    with the wrong sign, or its 2 x 3 split's outputs in the wrong digit
    order, moves the block maxima by O(1) of their scale."""
    Dre, Dim, _, _, _ = _inputs(96, 2, 1, seed=6)
    bias = torch.zeros(1, 8, 64, 96)
    want = emulate_fft(t_(Dre), t_(Dim), bias)
    got = emulate_fft(t_(Dre), t_(Dim), bias, mutate=mutate)
    assert ((got - want).abs().max() / want.abs().max()).item() > 0.1


@pytest.mark.parametrize("mutate", ["radix2_sign", "radix2_digit_order"])
def test_radix2_errors_move_the_result(mutate):
    """At L = 32 the radix-Q pass is ``idft<2>``, one butterfly: its
    difference with the wrong sign, or its two outputs swapped, moves the
    block maxima by O(1) of their scale."""
    Dre, Dim, _, _, _ = _inputs(32, 2, 1, seed=8)
    bias = torch.zeros(1, 8, 64, 32)
    want = emulate_fft(t_(Dre), t_(Dim), bias)
    got = emulate_fft(t_(Dre), t_(Dim), bias, mutate=mutate)
    assert ((got - want).abs().max() / want.abs().max()).item() > 0.1


def test_kz_edge_imaginary_parts_are_ignored():
    """irfft, the dense Mz (sine row 0 at kz = 0) and the kernel take
    X[0] and X[L/2] by their real parts."""
    Dre, Dim, MzRe, MzIm, _ = _inputs(64, 2, 1, seed=4)
    bias = torch.zeros(1, 8, 64, 64)
    Dim0 = Dim.copy()
    Dim0[:, [0, 32]] = 0.0
    a = emulate_fft(t_(Dre), t_(Dim), bias)
    b = emulate_fft(t_(Dre), t_(Dim0), bias)
    assert torch.equal(a, b)
    c = tinvz.invz_blockmax_reference(t_(Dre), t_(Dim0), t_(MzRe), t_(MzIm),
                                      bias)
    assert ((a - c).abs().max() / c.abs().max()).item() <= TOL


@pytest.mark.parametrize("L,want", [
    (128, "fft"),       # the main path
    (64, "fft"),        # the card-vs-CPU phases
    (96, "fft"),        # grid 96: the rep-score and train presets
    (32, "fft"),        # grid 32: the smallest L % 32 == 0
    (160, None), (256, None)])     # no kernel: K1 refuses L > 128
def test_k2_route(L, want):
    if want is None:
        with pytest.raises(ValueError, match=f"no kernel for L={L}"):
            tinvz.k2_route(L)
    else:
        assert tinvz.k2_route(L) == want


def test_launch_outside_the_fft_grids_raises():
    """The wrapper refuses an L that no kernel takes before it reaches
    the library (so no card is needed to see it)."""
    Dre, Dim, MzRe, MzIm, bias = _inputs(48, 2, 1, X=4, Y=32)
    with pytest.raises(ValueError, match="no kernel for L=48"):
        tinvz._launch_fft(*(t_(a) for a in (Dre, Dim, MzRe, MzIm, bias)))


@pytest.mark.parametrize("L", [32, 64, 96, 128])
def test_hermitian_inverse_z_is_the_correlators_mz(L):
    MzRe, MzIm = hermitian_inverse_z(L)
    corr = get_correlator(L, 16)
    assert torch.equal(corr.MzRe, t_(MzRe))
    assert torch.equal(corr.MzIm, t_(MzIm))
    jc = jdft.get_correlator(L, 16)
    np.testing.assert_array_equal(MzRe, np.float32(jc.MzRe))
    np.testing.assert_array_equal(MzIm, np.float32(jc.MzIm))
    # It is irfft along kz as a matrix.
    rng = np.random.default_rng(L)
    X = rng.normal(size=L // 2 + 1) + 1j * rng.normal(size=L // 2 + 1)
    np.testing.assert_allclose(X.real @ MzRe - X.imag @ MzIm,
                               np.fft.irfft(X, n=L), atol=1e-6)


def test_require_c2r():
    MzRe, MzIm = (t_(m) for m in hermitian_inverse_z(64))
    tinvz.require_c2r(MzRe, MzIm)
    with pytest.raises(ValueError, match="MzRe is not its matrix"):
        tinvz.require_c2r(MzRe * 1.01, MzIm)
    with pytest.raises(ValueError, match="MzIm is not its matrix"):
        tinvz.require_c2r(MzRe, MzRe)
    with pytest.raises(ValueError, match="at L=128"):
        tinvz.require_c2r(torch.zeros(33, 128), MzIm)


@pytest.mark.parametrize("fn", [DockingPipeline.__init__,
                                DockingService.__init__, dock_score_mask])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds on it")
    cfg = DockConfig(grid_size=32, rep_features=(8,))
    with pytest.raises((AssertionError, RuntimeError)):
        DockingPipeline(cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        DockingService(cfg)
