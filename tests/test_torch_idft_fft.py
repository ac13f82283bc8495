"""K3's FFT route (``csrc/idft_fft.cu``) on the CPU, and the port's own
``DockConfig``.

The CUDA kernel cannot run here, so this file holds its formulation: a
torch emulation of its stages -- the z axis in runs of 32 columns (the
last one half full and masked at L = 48, 80 and 112), pass 1's complex
inverse FFT along ky (L = P x Q with (P, Q) = (16, 8) at L = 128 and
P = 8 below: Q = 4, 6, 8, 10, 12, 14 at L = 32, 48, 64, 80, 96, 112;
radix-P
butterflies over k1, the twiddle e^{+2 pi i k2 n1 / L}, radix-Q over k2,
output digit y = n1 + P n2), the Hermitian fold h[kx] = (g[kx] + conj
g[L-kx]) / 2 for kx <= L/2, and pass 2's c2r along kx (``fft.cuh``:
packing, radix-8 then radix-Q = L/16 passes, even/odd interleave), and
at L = 16 the single pass (the rotation's E in shared planes padded to
272 floats, idft<16> along ky in place, then along kx, the real part)
-- against the plain version (``idft_bc_reference``, the dense
contractions) and the JAX kernel in interpret mode at every L it
serves; planted errors in the fold, the ky FFT, the packing, the
radix-2, 3, 5 and 7 stages, the half z run and L = 16's single pass
move the result by O(1);
and ``k3_route``, ``inverse_dft`` and the wrapper's check of
``Ux``/``Uy``.

Tolerance: 1e-5 relative to max |S| (float32; the FFTs and the dense
contractions round in another order, O(1e-7) relative).  The kernel
itself is held against the plain version on a card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fft_emulation import c2r_columns, idft, twiddles
from torch_parity import V9P_CKPT, np_, t_

from deeplocalproteindocking_torch import config as tconfig
from deeplocalproteindocking_torch.correlate import dft as tdft
from deeplocalproteindocking_torch.correlate import idft as tidft
from deeplocalproteindocking_tpu import config as jconfig
from deeplocalproteindocking_tpu.correlate import dft as jdft
from deeplocalproteindocking_tpu.correlate import pallas_idft as jidft

TOL = 1e-5
RUN = 32        # z columns of a run: one lane each (kCols)


def pass1_split(L):
    """Pass 1's radices (P, Q), L = P x Q, as ``idft_fft.cu`` takes them:
    (16, 8) at L = 128, P = 8 below (8 x 4, 8 x 6, 8 x 8, 8 x 10, 8 x 12,
    8 x 14 at L = 32, 48, 64, 80, 96, 112)."""
    P = 16 if L == 128 else 8
    return P, L // P


def emulate_idft_fft(Ere, Eim, mutate=None):
    """What ``idft_fft.cu`` computes, stage by stage, in complex64:
    ``E (re, im) [b, L, L, Z]`` (kx, ky, z) -> ``S [b, L, L, Z]`` float32,
    z in runs of 32 columns: ceil(Z / 32) runs, each run's columns at or
    past Z read as zeros and never stored.  ``mutate`` plants one error
    (for the O(1) tests): ``"half_run_dropped"`` launches Z // 32 runs,
    ``"half_run_shifted"`` reads a half-full run 16 columns early,
    ``"half_run_unguarded"`` stores a half-full run's columns past Z too
    (after its others), where the kernel's flat index puts them: into
    the next row of S.  At L = 16 it is ``emulate_idft16``."""
    if Ere.shape[1] == 16:
        return emulate_idft16(Ere, Eim, mutate)
    Z = Ere.shape[-1]
    S = torch.zeros(Ere.shape, dtype=torch.float32)
    runs = Z // RUN if mutate == "half_run_dropped" else -(-Z // RUN)
    for z0 in range(0, RUN * runs, RUN):
        cols = torch.arange(z0, z0 + RUN)
        valid = cols < Z
        read = cols - RUN // 2 if (mutate == "half_run_shifted"
                                   and not valid.all()) else cols
        tile = [torch.where(valid, e[..., read.clamp(max=Z - 1)], 0.0)
                for e in (Ere, Eim)]
        run = _emulate_run(*tile, mutate)
        S[..., cols[valid]] = run[..., valid]
        if mutate == "half_run_unguarded" and not valid.all():
            b, X, Y, _ = S.shape
            rows = torch.arange(X * Y).reshape(X, Y, 1) * Z
            at = rows + cols[~valid]                   # [X, Y, past Z]
            inside = at < X * Y * Z
            S.view(b, -1)[:, at[inside]] = run[..., ~valid][:, inside]
    return S


def emulate_idft16(Ere, Eim, mutate=None):
    """What ``idft16_kernel`` computes, in complex64: each rotation's E
    ``[16 kx][16 ky][16 z]`` copied into shared planes of 272 floats a
    kx, the inverse DFT along ky in place (thread (kx, z)), then along kx
    (thread (y, z)), the real part with 1/256.  ``mutate``:
    ``"l16_plane_stride"`` indexes the planes by 256 floats where the
    copies wrote 272, ``"l16_ky_sign"`` takes the forward DFT along ky,
    or ``idft``'s ``"radix16_digit_order"``."""
    b, L = Ere.shape[:2]
    pad = L * L + 16
    stride = L * L if mutate == "l16_plane_stride" else pad
    tile = torch.zeros(b, L * pad, dtype=torch.complex64)
    E = torch.complex(Ere, Eim).reshape(b, L, L * L)
    for kx in range(L):
        tile[:, kx * pad:kx * pad + L * L] = E[:, kx]
    n = torch.arange(L)
    # at[a, k, z]: plane a, row k, column z.
    at = (n[:, None, None] * stride + n[None, :, None] * L + n[None, None, :])
    v = tile[:, at]                                    # [b, kx, ky, z]
    cols = [v[:, :, k] for k in range(L)]
    if mutate == "l16_ky_sign":
        g = [c.conj() for c in idft([c.conj() for c in cols])]
    else:
        g = idft(cols, mutate)                         # g[y]: [b, kx, z]
    tile[:, at] = torch.stack(g, dim=2)                # [b, kx, y, z]
    v = tile[:, at]
    s = idft([v[:, k] for k in range(L)], mutate)      # s[x]: [b, y, z]
    return torch.stack(s, dim=1).real / (L * L)


def _emulate_run(Ere, Eim, mutate=None):
    """One z run of ``emulate_idft_fft``: ``[b, L, L, 32]`` -> ``S``."""
    b, L, _, Z = Ere.shape
    K = L // 2 + 1
    P, Q = pass1_split(L)
    tw = twiddles(L)
    E = torch.complex(Ere, Eim)
    # Pass 1, radix-P: task k2 takes rows ky = Q k1 + k2 over k1, then
    # the twiddle e^{+2 pi i k2 n1 / L}.
    Ek = E.reshape(b, L, P, Q, Z)                      # [b, kx, k1, k2, z]
    v = idft([Ek[:, :, k1] for k1 in range(P)])        # v[n1]: [b, kx, k2, z]
    sign = -1 if mutate == "ky_twiddle_sign" else 1
    k2 = torch.arange(Q)
    A = torch.stack([v[n1] * tw[(sign * k2 * n1) % L, None]
                     for n1 in range(P)], dim=2)       # [b, kx, n1, k2, z]
    # Radix-Q: warp n1 takes A[n1, k2] over k2: g[n1 + P n2].
    u = idft([A[:, :, :, j] for j in range(Q)], mutate)  # [b, kx, n1, z]
    g = torch.stack(u, dim=2)                          # [b, kx, n2, n1, z]
    if mutate == "ky_digit_order":
        g = g.transpose(2, 3)
    g = g.reshape(b, L, L, Z)
    # The fold with scale 1/(2L).
    kx = torch.arange(K)
    partner = (L - kx - 1) % L if mutate == "fold_partner" else (L - kx) % L
    gp = g[:, partner] if mutate == "fold_no_conj" else g[:, partner].conj()
    h = (g[:, kx] + gp) * (0.5 / L)                    # [b, K, y, z]
    # Pass 2: the c2r along kx.
    S = c2r_columns(h.reshape(b, K, L * Z), mutate)
    return S.reshape(b, L, L, Z)


def _e_inputs(L, b, Z=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, L, L, Z or L)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _rel(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _z(L):
    """The z extent a test emulates at L: 32 (one whole run) where
    L % 32 == 0, else all of L (whole runs and a half-full one)."""
    return 32 if L % RUN == 0 else L


@pytest.mark.parametrize("L", [16, 32, 48, 64, 80, 96, 112, 128])
def test_emulation_matches_plain(L):
    Ere, Eim = _e_inputs(L, 2, Z=_z(L), seed=L)
    ux = [t_(a) for a in tdft.inverse_dft(L)]
    want = tidft.idft_bc_reference(t_(Ere), t_(Eim), *ux, *ux)
    got = emulate_idft_fft(t_(Ere), t_(Eim))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    # And both are Re ifft2 over (kx, ky).
    lib = np.fft.ifft2(Ere + 1j * Eim, axes=(1, 2)).real
    assert _rel(got, lib) <= TOL


@pytest.mark.parametrize("L", [16, 32, 48, 64, 80, 96, 112, 128])
def test_emulation_matches_pallas_interpret(L):
    """The same G into JAX ``pallas_inverse`` (interpret mode) and into
    pass A then the emulation."""
    rng = np.random.default_rng(20 + L)
    gre, gim = (rng.normal(size=(1, L, L, L // 2 + 1)).astype(np.float32)
                for _ in range(2))
    c = jdft.get_correlator(L, 8)
    tw = (c.UxRe, c.UxIm, c.UyRe, c.UyIm, c.MzRe, c.MzIm)
    want = jidft.pallas_inverse(jnp.asarray(gre), jnp.asarray(gim),
                                *(jnp.asarray(a) for a in tw), interpret=True)
    mz = [t_(a) for a in tdft.hermitian_inverse_z(L)]
    ere, eim = tidft._pass_a(t_(gre), t_(gim), *mz)
    assert _rel(emulate_idft_fft(ere, eim), want) <= TOL


@pytest.mark.parametrize("mutate", [
    "fold_partner", "fold_no_conj", "ky_twiddle_sign", "ky_digit_order",
    "minus_i", "mirror_index", "digit_order"])
def test_planted_errors_move_the_result(mutate):
    """The emulation is sharp: one planted error moves S by O(1) of its
    scale, far outside TOL."""
    Ere, Eim = _e_inputs(64, 1, Z=32, seed=5)
    want = emulate_idft_fft(t_(Ere), t_(Eim))
    got = emulate_idft_fft(t_(Ere), t_(Eim), mutate=mutate)
    assert _rel(got, want) > 0.1


@pytest.mark.parametrize("L,want", [
    (128, "fft"),       # the screening path
    (64, "fft"),        # the card-vs-CPU phase
    (96, "fft"),        # grid 96: the rep-score and train presets
    (48, "fft"), (80, "fft"), (112, "fft"),   # a half-full last z run
    (32, "fft"),        # grid 32: the smoke's small dft_pallas dock
    (16, "fft"),        # one half-full z run, the only one
    (160, None), (24, None)])      # no kernel: dft_pallas refuses them
def test_k3_route(L, want):
    if want is None:
        with pytest.raises(ValueError, match=f"no kernel for L={L}"):
            tidft.k3_route(L)
    else:
        assert tidft.k3_route(L) == want


@pytest.mark.parametrize("L,mutate", [
    (80, "radix5_sign"),            # pass 1's radix 10, the c2r's radix 5
    (112, "radix7_sign"),           # pass 1's radix 14, the c2r's radix 7
    (80, "radix10_digit_order"),
    (112, "radix14_digit_order"),
    (48, "half_run_dropped"),       # ceil(L / 32) runs are needed
    (80, "half_run_shifted"),
    (48, "half_run_unguarded")])
def test_radix5_7_and_half_run_errors_move_the_result(L, mutate):
    """A radix-5 or radix-7 inverse DFT with the conjugate root, a 2 x 5
    or 2 x 7 split's outputs in the wrong digit order, the half-full last
    z run not launched, read 16 columns early or stored past L: each
    moves S by O(1)."""
    Ere, Eim = _e_inputs(L, 1, Z=L, seed=L + 3)
    want = emulate_idft_fft(t_(Ere), t_(Eim))
    got = emulate_idft_fft(t_(Ere), t_(Eim), mutate=mutate)
    assert _rel(got, want) > 0.1


@pytest.mark.parametrize("L,mutate", [
    (32, "radix2_sign"),            # the c2r's radix 2 (M = 8 x 2)
    (32, "radix2_digit_order"),
    (16, "l16_plane_stride"),       # the single pass's padded planes
    (16, "l16_ky_sign"),
    (16, "radix16_digit_order")])
def test_radix2_and_grid16_errors_move_the_result(L, mutate):
    """At L = 32 the radix-2 butterfly with its difference's sign flipped
    or its outputs swapped; at L = 16 the single pass reading its tile
    with the unpadded plane stride, taking the forward DFT along ky, or
    its idft<16>'s outputs in the wrong digit order: each moves S by
    O(1)."""
    Ere, Eim = _e_inputs(L, 1, Z=_z(L), seed=L + 9)
    want = emulate_idft_fft(t_(Ere), t_(Eim))
    got = emulate_idft_fft(t_(Ere), t_(Eim), mutate=mutate)
    assert _rel(got, want) > 0.1


@pytest.mark.parametrize("mutate", ["radix3_sign", "radix6_digit_order"])
def test_radix3_errors_move_the_result(mutate):
    """At L = 96 pass 1's radix-12 and pass 2's radix-6 run through
    ``idft<6>``: the cube root of unity with the wrong sign, or its 2 x 3
    split's outputs in the wrong digit order, moves S by O(1)."""
    Ere, Eim = _e_inputs(96, 1, Z=32, seed=7)
    want = emulate_idft_fft(t_(Ere), t_(Eim))
    got = emulate_idft_fft(t_(Ere), t_(Eim), mutate=mutate)
    assert _rel(got, want) > 0.1


@pytest.mark.parametrize("L", [16, 32, 64, 96, 128])
def test_inverse_dft_is_the_correlators_matrix(L):
    UxRe, UxIm = tdft.inverse_dft(L)
    corr = tdft.get_correlator(L, 16)
    for t in (corr.UxRe32, corr.UxRe):
        assert torch.equal(t, t_(UxRe))
    assert torch.equal(corr.UxIm32, t_(UxIm))
    jc = jdft.get_correlator(L, 16)
    np.testing.assert_array_equal(UxRe, np.float32(jc.UxRe))
    np.testing.assert_array_equal(UxIm, np.float32(jc.UyIm))
    # It is ifft along the first axis as a matrix.
    rng = np.random.default_rng(L)
    x = rng.normal(size=L) + 1j * rng.normal(size=L)
    np.testing.assert_allclose(x @ (UxRe + 1j * UxIm), np.fft.ifft(x),
                               atol=1e-6)


def test_require_idft():
    u = [t_(a) for a in tdft.inverse_dft(64)]
    tidft.require_idft(*u, *u)
    with pytest.raises(ValueError, match="UxRe is not its matrix"):
        tidft.require_idft(u[0] * 1.001, u[1], *u)
    with pytest.raises(ValueError, match="UyIm is not its matrix"):
        tidft.require_idft(*u, u[0], -u[1])
    # The bf16-rounded matrix is not the matrix either.
    with pytest.raises(ValueError, match="not its matrix"):
        tidft.require_idft(*u, u[0].bfloat16().float(), u[1])
    with pytest.raises(ValueError, match="at L=128"):
        tidft.require_idft(torch.zeros(64, 128), u[1], *u)


# ---- the port's own DockConfig, held in step with the JAX package's ----

def test_config_fields_match_the_jax_package():
    tf = dataclasses.fields(tconfig.DockConfig)
    jf = dataclasses.fields(jconfig.DockConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert (a.type, a.default) == (b.type, b.default), a.name
    assert tconfig.DockConfig.__module__ == "deeplocalproteindocking_torch.config"


def test_config_presets_match_the_jax_package():
    assert tconfig.PRESETS.keys() == jconfig.PRESETS.keys()
    for name, cfg in tconfig.PRESETS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jconfig.PRESETS[name])), name


def test_config_json_round_trips_both_ways():
    cfg = tconfig.DockConfig(grid_size=64, rep_features=(32, 14),
                             lig_grid_size=40, coupling_rank=3,
                             dft_dtype="bfloat16")
    j = jconfig.DockConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(j) == dataclasses.asdict(cfg)
    back = tconfig.DockConfig.from_json(j.to_json())
    assert back == cfg and back.to_json() == cfg.to_json() == j.to_json()
    with open(os.path.join(V9P_CKPT, "config.json")) as f:
        text = f.read()
    assert (tconfig.DockConfig.from_json(text).to_json()
            == jconfig.DockConfig.from_json(text).to_json())

