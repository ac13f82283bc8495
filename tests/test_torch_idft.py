"""Torch port vs JAX package: K3 and the ``dft_pallas`` engine.

K3 (``correlate/idft.py``) runs here through its plain version, because
the tensors lie on the CPU; the JAX side runs its Pallas kernel in
interpret mode, as ``tests/test_pallas_idft.py`` does.  Tolerance: max
|port - JAX| <= 1e-4 max |JAX| (float32, summation order).  The CUDA
kernel itself is held against the plain version on a card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_, t_

from deeplocalproteindocking_torch.correlate import dft as tdft
from deeplocalproteindocking_torch.correlate import fft as tfft
from deeplocalproteindocking_torch.correlate import idft as tidft
from deeplocalproteindocking_torch.correlate._contract import mm
from deeplocalproteindocking_torch.sweep import resplat as tres
from deeplocalproteindocking_tpu.correlate import dft as jdft
from deeplocalproteindocking_tpu.correlate import fft as jfft
from deeplocalproteindocking_tpu.correlate import pallas_idft as jidft
from deeplocalproteindocking_tpu.sweep import resplat as jres

TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    return err


@pytest.mark.parametrize("L", [16, 32])
def test_k3_plain_matches_pallas_interpret(L):
    rng = np.random.default_rng(L)
    B, Kz = 2, L // 2 + 1
    gre = rng.normal(size=(B, L, L, Kz)).astype(np.float32)
    gim = rng.normal(size=(B, L, L, Kz)).astype(np.float32)
    c = jdft.get_correlator(L, 8)
    tw = (c.UxRe, c.UxIm, c.UyRe, c.UyIm, c.MzRe, c.MzIm)
    want = jidft.pallas_inverse(jnp.asarray(gre), jnp.asarray(gim),
                                *(jnp.asarray(a) for a in tw),
                                interpret=True)
    n0 = tidft.launches
    for fn in (tidft.pallas_inverse, tidft.pallas_inverse_reference):
        _close(fn(t_(gre), t_(gim), *(t_(a) for a in tw)), want)
    assert tidft.launches == n0           # CPU tensors: the plain version
    # Both equal the einsum inverse of the same spectrum.
    _close(c.inverse(jnp.asarray(gre), jnp.asarray(gim)), want)


def test_k3_rejects_grid_not_multiple_of_16():
    for L in (24, 20):
        g = torch.zeros(1, L, L, L // 2 + 1)
        u, mz = torch.zeros(L, L), torch.zeros(L // 2 + 1, L)
        for fn in (tidft.pallas_inverse, tidft.pallas_inverse_reference):
            with pytest.raises(ValueError, match="divisible by 8 and 16"):
                fn(g, g, u, u, u, u, mz, mz)
        e = torch.zeros(1, L, L, L, device="meta")
        with pytest.raises(ValueError, match="divisible by 8 and 16"):
            tidft.idft_bc(e, e, *(u.to("meta"),) * 4)
    e = torch.zeros(1, 16, 16, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tidft.idft_bc(e, e, *(torch.zeros(16, 16, device="meta"),) * 4)


class _JaxBf16(jdft.DFTCorrelator):
    """The JAX correlator at ``dft_dtype="bfloat16"``, runnable here.

    XLA's CPU backend has no bf16 x bf16 -> float32 dot, so each cast to
    bf16 is a rounding to bf16 values kept in float32: the same numbers,
    since bf16 -> float32 is exact and every contraction accumulates in
    float32 either way.  K3 still gets the float32 twiddles and G, as
    ``correlator_pallas_inverse`` hands them over.
    """

    def _cast(self, *xs):
        return tuple(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
                     for x in xs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correlate_batch_dft_pallas_matches_jax(dtype):
    rng = np.random.default_rng(3)
    L, Ls, C = 32, 16, 3
    rec = rng.normal(size=(L, L, L, C)).astype(np.float32)
    reps = rng.normal(size=(2, Ls, Ls, Ls, C)).astype(np.float32)
    reps = np_(t_(reps).to(torch.bfloat16).float())   # bf16-representable
    jH = np_(jfft.receptor_transform(jnp.asarray(rec)))
    tH = tfft.receptor_transform(t_(rec))
    if dtype == "float32":
        want = jres._correlate_batch(jnp.asarray(jH), jnp.asarray(reps), L,
                                     "dft_pallas", dtype)
    else:
        want = _JaxBf16(L, Ls).scores(
            jnp.asarray(jH.real), jnp.asarray(jH.imag), jnp.asarray(reps),
            inverse_impl="pallas")
    got = tres._correlate_batch(tH, t_(reps), L, "dft_pallas", dtype)
    _close(got, want)
    if dtype == "bfloat16":
        # The trap the float32 twiddles avoid: K3 fed the bf16 copies
        # lands ~2e-3 away, far outside the tolerance.
        tc = tdft.get_correlator(L, Ls, dtype)
        fre, fim = tc._cast(*tc.ligand_spectrum(t_(reps)))
        hr, hi = tc._cast(tH.real, tH.imag)
        gre = mm("ijkc,bijkc->bijk", hr, fre) + mm("ijkc,bijkc->bijk", hi,
                                                    fim)
        gim = mm("ijkc,bijkc->bijk", hi, fre) - mm("ijkc,bijkc->bijk", hr,
                                                    fim)
        trap = tidft.pallas_inverse(gre, gim, tc.UxRe, tc.UxIm, tc.UyRe,
                                    tc.UyIm, tc.MzRe, tc.MzIm)
        with pytest.raises(AssertionError):
            _close(trap, want, tol=10 * TOL)
