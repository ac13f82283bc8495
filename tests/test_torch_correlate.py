"""Torch port vs JAX package: the correlator and its two kernels.

K1 (``correlate/fused.py``) and K2 + drill-down
(``correlate/invz_topk.py``) run here through their plain versions,
because the tensors lie on the CPU; the JAX side runs its Pallas kernels
in interpret mode, as ``tests/test_pallas_*.py`` do.  Tolerances are
those of ``tests/test_pallas_invz_topk.py`` (float32, summation order).
The CUDA kernels themselves are held against the plain versions on a
card by ``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_same_multiset, np_, t_

from deeplocalproteindocking_torch.correlate import dft as tdft
from deeplocalproteindocking_torch.correlate import fft as tfft
from deeplocalproteindocking_torch.correlate import fused as tfused
from deeplocalproteindocking_torch.correlate import invz_topk as tinvz
from deeplocalproteindocking_torch.sweep import resplat as tres
from deeplocalproteindocking_torch.sweep import topk as ttopk
from deeplocalproteindocking_tpu.correlate import dft as jdft
from deeplocalproteindocking_tpu.correlate import fft as jfft
from deeplocalproteindocking_tpu.correlate import pallas_fused as jfused
from deeplocalproteindocking_tpu.correlate import pallas_invz_topk as jinvz
from deeplocalproteindocking_tpu.sweep import topk as jtopk

L, LS, C, B, K = 32, 16, 3, 2, 8
TOL = dict(rtol=2e-4, atol=1e-3)


def _inputs(seed=0, c=C, b=B):
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(L, L, L, c)).astype(np.float32)
    reps = rng.normal(size=(b, LS, LS, LS, c)).astype(np.float32)
    cpl = rng.normal(size=(c, c)).astype(np.float32)
    return rec, reps, cpl


def _spectra(rec, cpl=None):
    jH = jfft.receptor_transform(jnp.asarray(rec),
                                 None if cpl is None else jnp.asarray(cpl))
    tH = tfft.receptor_transform(t_(rec), None if cpl is None else t_(cpl))
    return jH, tH


def test_receptor_transform():
    rec, _, cpl = _inputs(0)
    for c in (None, cpl):
        jH, tH = _spectra(rec, c)
        assert tH.dtype == torch.complex64
        np.testing.assert_allclose(np_(tH), np_(jH), rtol=1e-4, atol=2e-3)


def test_dft_scores_and_ligand_spectrum():
    rec, reps, cpl = _inputs(1)
    jH, tH = _spectra(rec, cpl)
    jc, tc = jdft.get_correlator(L, LS), tdft.get_correlator(L, LS)
    jf = jc.ligand_spectrum(jnp.asarray(reps))
    tf = tc.ligand_spectrum(t_(reps))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-4, atol=1e-3)
    want = jc.scores(jnp.asarray(np_(jH).real), jnp.asarray(np_(jH).imag),
                     jnp.asarray(reps))
    got = tc.scores(tH.real.contiguous(), tH.imag.contiguous(), t_(reps))
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


def _k1_args(seed, dtype):
    rec, reps, cpl = _inputs(seed)
    jH, tH = _spectra(rec, cpl)
    jc = jdft.get_correlator(L, LS, dtype)
    tc = tdft.get_correlator(L, LS, dtype)
    f32 = jnp.float32
    v = jnp.asarray(reps).astype(jc.dtype)
    Are = jnp.einsum("bxyzc,zk->bkcxy", v, jnp.asarray(jc.WzRe, jc.dtype),
                     preferred_element_type=f32).astype(jc.dtype)
    Aim = jnp.einsum("bxyzc,zk->bkcxy", v, jnp.asarray(jc.WzIm, jc.dtype),
                     preferred_element_type=f32).astype(jc.dtype)
    jargs = (Are, Aim) + jc.prep_H(jH) + jc._cast(
        jc.WyRe, jc.WyIm, jc.WxRe, jc.WxIm, jc.UxRe, jc.UxIm, jc.UyRe,
        jc.UyIm)
    tdt = tc.dtype
    targs = tuple(t_(np.asarray(a.astype(f32)), torch.float32).to(tdt)
                  for a in jargs)
    return jargs, targs, tc, tH


def test_k1_plain_matches_pallas_interpret():
    jargs, targs, _, _ = _k1_args(2, "float32")
    want = jfused.fused_correlate(*jargs, interpret=True)
    got = tfused.fused_correlate(*targs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, L // 2 + 1, L, L)
        np.testing.assert_allclose(np_(g), np_(w), **TOL)


def test_k1_plain_bf16_rounding_points():
    """bf16 operands (XLA on the CPU has no bf16 x bf16 -> f32 dot, so
    the JAX kernel cannot run here in bf16): the bf16 plain version
    stays within bf16 rounding (2^-8 relative per cast point) of the
    float32 plain version on the same bf16-representable inputs."""
    _, targs, _, _ = _k1_args(2, "float32")
    targs = tuple(a.to(torch.bfloat16) for a in targs)
    got = tfused.fused_correlate(*targs)
    want = tfused.fused_correlate(*(a.float() for a in targs))
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 2e-2 * w.abs().max()
        assert (g - w).abs().max() > 0      # the cast points are there


def test_scores_fused_matches_jax_scores():
    rec, reps, cpl = _inputs(3)
    jH, tH = _spectra(rec, cpl)
    jc, tc = jdft.get_correlator(L, LS), tdft.get_correlator(L, LS)
    want = jc.scores(jnp.asarray(np_(jH).real), jnp.asarray(np_(jH).imag),
                     jnp.asarray(reps))
    got = tc.scores_fused(*tc.prep_H(tH), t_(reps))
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


def _D(seed):
    """The same D (numpy float32) for both packages, from the JAX
    correlator's fused_D in interpret mode."""
    rec, reps, cpl = _inputs(seed)
    jH, _ = _spectra(rec, cpl)
    jc = jdft.get_correlator(L, LS)
    Dre, Dim = jc.fused_D(*jc.prep_H(jH), jnp.asarray(reps),
                          interpret=True)
    S = jc.scores(jnp.asarray(np_(jH).real), jnp.asarray(np_(jH).imag),
                  jnp.asarray(reps))
    return np_(Dre), np_(Dim), jc, np_(S)


@pytest.mark.parametrize("groups", [0, 1, 2])
def test_k2_plain_matches_pallas_interpret(groups):
    Dre, Dim, jc, _ = _D(4)
    f32 = np.float32
    MzRe, MzIm = np.asarray(jc.MzRe, f32), np.asarray(jc.MzIm, f32)
    rng = np.random.default_rng(5)
    if groups == 0:
        bias = np.zeros((L, L, L), f32)
    else:
        bias = np.where(rng.random((groups, L, L, L)) < 0.7, 0.0,
                        -np.inf).astype(f32)
        if groups == 1:
            bias = bias[0]
    # One run fully masked: its block max must be -inf, not NaN.
    bias = np.array(bias)
    bias[..., 3, 0:32, 5] = -np.inf
    want = jinvz.invz_blockmax(*(jnp.asarray(a) for a in
                                 (Dre, Dim, MzRe, MzIm, bias)),
                               interpret=True)
    got = tinvz.invz_blockmax(t_(Dre), t_(Dim), t_(MzRe), t_(MzIm),
                              t_(bias))
    assert got.shape == (B, L, L // 32, L)
    g, w = np_(got), np_(want)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    assert not np.isnan(g).any()
    assert np.all(g[:, 3, 0, 5] == -np.inf)
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_k2_drill_topk_matches_jax(masked):
    Dre, Dim, jc, S = _D(6)
    f32 = np.float32
    MzRe, MzIm = np.asarray(jc.MzRe, f32), np.asarray(jc.MzIm, f32)
    mask = (np.random.default_rng(7).random((L, L, L)) < 0.7
            if masked else None)
    bias = (np.where(mask, 0.0, -np.inf).astype(f32) if masked
            else np.zeros((L, L, L), f32))
    bias_flat = bias.reshape(-1) if masked else None
    jb = jinvz.invz_blockmax(*(jnp.asarray(a) for a in
                               (Dre, Dim, MzRe, MzIm, bias)), interpret=True)
    want_v, _ = jinvz.drill_topk(
        jnp.asarray(Dre), jnp.asarray(Dim), jnp.asarray(MzRe),
        jnp.asarray(MzIm), None if bias_flat is None
        else jnp.asarray(bias_flat), jb, K)
    tb = tinvz.invz_blockmax(t_(Dre), t_(Dim), t_(MzRe), t_(MzIm), t_(bias))
    got_v, got_f = tinvz.drill_topk(
        t_(Dre), t_(Dim), t_(MzRe), t_(MzIm),
        None if bias_flat is None else t_(bias_flat), tb, K)
    assert_same_multiset(got_v, want_v, **TOL)
    # Flat indices address the claimed scores in the true volume, in the
    # x*L^2 + y*L + z convention; no masked cell leaks in.
    Sf = np.where(mask[None], S, -np.inf) if masked else S
    looked = np.take_along_axis(Sf.reshape(B, -1), np_(got_f), axis=1)
    np.testing.assert_allclose(looked, np_(got_v), **TOL)
    assert np.all(np.isfinite(looked))


def test_drill_topk_per_group_bias():
    """Bias ``[G, X*Y*Z]``: each run of b//G rows is masked by its own
    group, as K2 groups rows, and the drill-down equals exact_block_topk
    on each row's own masked score volume."""
    rec, reps, cpl = _inputs(12, b=4)
    _, tH = _spectra(rec, cpl)
    tc = tdft.get_correlator(L, LS)
    Dre, Dim = tc.fused_D(*tc.prep_H(tH), t_(reps))
    S = (torch.einsum("bkxy,kz->bxyz", Dre, tc.MzRe)
         - torch.einsum("bkxy,kz->bxyz", Dim, tc.MzIm))
    rng = np.random.default_rng(13)
    G = 2
    mask = t_(rng.random((G, L, L, L)) < 0.5)
    bias = torch.where(mask, 0.0, float("-inf"))
    bmax = tinvz.invz_blockmax(Dre, Dim, tc.MzRe, tc.MzIm, bias)
    got_v, got_f = tinvz.drill_topk(Dre, Dim, tc.MzRe, tc.MzIm,
                                    bias.reshape(G, -1), bmax, K)
    rows_mask = mask.repeat_interleave(4 // G, dim=0)       # [b, L, L, L]
    Sm = torch.where(rows_mask, S, float("-inf")).reshape(4, -1)
    want_v, _ = ttopk.exact_block_topk(Sm, K)
    assert_same_multiset(got_v, want_v, **TOL)
    looked = torch.gather(Sm, 1, got_f)
    np.testing.assert_allclose(np_(looked), np_(got_v), **TOL)
    assert torch.isfinite(looked).all()
    with pytest.raises(ValueError, match="bias groups"):
        tinvz.drill_topk(Dre, Dim, tc.MzRe, tc.MzIm,
                         torch.zeros(3, L ** 3), bmax, K)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_correlate_topk_matches_jax_score_volume(masked):
    rec, reps, cpl = _inputs(8)
    jH, tH = _spectra(rec, cpl)
    tc = tdft.get_correlator(L, LS)
    mask = (np.random.default_rng(9).random((L, L, L)) < 0.6
            if masked else None)
    jc = jdft.get_correlator(L, LS)
    S = jc.scores(jnp.asarray(np_(jH).real), jnp.asarray(np_(jH).imag),
                  jnp.asarray(reps))
    if masked:
        S = jnp.where(jnp.asarray(mask)[None], S, -jnp.inf)
    want_v, _ = jtopk.exact_block_topk(S.reshape(B, -1), K)
    got_v, got_f = tres._fused_correlate_topk(
        tc.prep_H(tH), t_(reps), L, LS, "float32",
        None if mask is None else t_(mask), K)
    assert_same_multiset(got_v, want_v, **TOL)
    looked = np.take_along_axis(np_(S).reshape(B, -1), np_(got_f), axis=1)
    np.testing.assert_allclose(looked, np_(got_v), **TOL)


@pytest.mark.parametrize("shape,k,ties", [
    ((3, 4096), 64, False),       # one level
    ((2, 32768), 16, False),      # two levels
    ((2, 32768), 64, True),       # two levels, heavy ties
    ((2, 256), 16, False)])       # fewer blocks than k
def test_exact_block_topk_value_multiset(shape, k, ties):
    rng = np.random.default_rng(10)
    x = rng.normal(size=shape).astype(np.float32)
    if ties:
        x = np.round(x * 4.0) / 4.0
    x[0, 5:900] = -np.inf
    got_v, got_i = ttopk.exact_block_topk(t_(x), k)
    want_v, _ = jtopk.exact_block_topk(jnp.asarray(x), k)
    assert_same_multiset(got_v, want_v, rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.take_along_axis(x, np_(got_i), axis=1), np_(got_v))
    np.testing.assert_array_equal(np.sort(np_(got_v), axis=1),
                                  np.sort(np.sort(x, axis=1)[:, -k:],
                                          axis=1))


def test_kernel_wrappers_check_inputs():
    _, targs, _, _ = _k1_args(11, "float32")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfused.fused_correlate(*(a.to("meta") for a in targs))
    with pytest.raises(ValueError, match="Y % 32"):
        tinvz.invz_blockmax(torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16),
                            torch.zeros(3, 8), torch.zeros(3, 8),
                            torch.zeros(8, 16, 8))
    with pytest.raises(ValueError, match="G dividing"):
        tinvz.invz_blockmax_reference(
            torch.zeros(3, 3, 8, 32), torch.zeros(3, 3, 8, 32),
            torch.zeros(3, 8), torch.zeros(3, 8), torch.zeros(2, 8, 32, 8))


def test_fused_topk_engage_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tres.fused_topk_engaged(None, "dft_fused", "exact", 128, cuda)
    assert not tres.fused_topk_engaged(None, "dft_fused", "exact", 128, cpu)
    assert tres.fused_topk_engaged(True, "dft_fused", "exact", 64, cpu)
    assert not tres.fused_topk_engaged(False, "dft_fused", "exact", 128,
                                       cuda)
    assert not tres.fused_topk_engaged(None, "dft", "exact", 128, cuda)
    assert not tres.fused_topk_engaged(None, "dft_fused", "exact", 48, cuda)
    assert not tres.fused_topk_engaged(True, "dft_fused", "approx", 128,
                                       cuda)
