"""K1's tensor-core decomposition (``csrc/fused_correlate_tc.cu``) on
the CPU.

The CUDA kernel cannot run here, so this file holds its formulation:
``k1_route``'s rule, the twiddle layouts of ``tc_operands``, and a torch
emulation of what the kernel computes -- the box zero-padded to P, the
forward y pass formed as B^T, every complex product as one real product
with the block matrix ``[[Qre, Qim], [-Qim, Qre]]``, B, G and C rounded
to the operand type, float32 sums -- against the plain version
(``fused_correlate_reference``) and the JAX kernel in interpret mode.

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
    (torch.bfloat16, 72, 128, "simt"),     # box above 64
    (torch.float32, 32, 128, "simt"),      # float32 stays SIMT
    (torch.bfloat16, 32, 120, "simt"),     # L not a multiple of 16
    (torch.bfloat16, 32, 144, "simt")])    # L above 128
def test_k1_route(dtype, box, L, want):
    assert tfused.k1_route(dtype, box, box, L, L, L, L) == want


def test_k1_route_checks_each_axis():
    bf = torch.bfloat16
    assert tfused.k1_route(bf, 64, 16, 32, 32, 32, 32) == "tc"
    assert tfused.k1_route(bf, 16, 65, 32, 32, 32, 32) == "simt"
    assert tfused.k1_route(bf, 16, 16, 32, 24, 32, 32) == "simt"
    assert tfused.k1_route(bf, 16, 16, 32, 32, 40, 32) == "simt"
    assert tfused.k1_route(bf, 16, 16, 32, 32, 32, 8) == "simt"


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


def emulate_tc(Are, Aim, Hre, Him, *twiddles):
    """What ``fused_correlate_tc.cu`` computes, stage by stage, from the
    operands its wrapper hands it."""
    (WyTre, WyTim, WxTre, WxTim, UxTre, UxTim, UyTre,
     UyTim) = tfused.tc_operands(*twiddles)
    dt = Are.dtype
    P = WyTre.shape[1]
    X, Y = Are.shape[-2:]

    def pad(a):                                   # [.., X, Y] -> [.., P, P]
        return torch.nn.functional.pad(a, (0, P - Y, 0, P - X))

    # 1. B^T[c, j, x] = Wy^T[j, y] A[c, x, y] over y, rounded.
    Btre, Btim = _block_mm(WyTre, WyTim, pad(Are).mT, pad(Aim).mT)
    Btre, Btim = Btre.to(dt), Btim.to(dt)
    # 2. F[c, j, i] = B^T[c, j, x] Wx[x, i]; G = sum_c H conj(F), rounded.
    Fre, Fim = _block_mm(Btre, Btim, WxTre.mT, WxTim.mT)
    Hr, Hi = Hre.float(), Him.float()
    Gre = (Hr * Fre + Hi * Fim).sum(dim=2).to(dt)
    Gim = (Hi * Fre - Hr * Fim).sum(dim=2).to(dt)
    # 3. C[j, x'] = G[j, i] Ux[i, x'], rounded.
    Cre, Cim = _block_mm(Gre, Gim, UxTre.mT, UxTim.mT)
    Cre, Cim = Cre.to(dt), Cim.to(dt)
    # 4. D[x', y'] = C[j, x'] Uy[j, y'] over j, float32.
    return _block_mm(Cre.mT, Cim.mT, UyTre.mT, UyTim.mT)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("L,Ls", [(32, 16), (32, 24), (48, 40)])
def test_tc_operands_layout(L, Ls):
    corr = get_correlator(L, Ls, "bfloat16")
    tw = (corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm, corr.UxRe, corr.UxIm,
          corr.UyRe, corr.UyIm)
    ops = tfused.tc_operands(*tw)
    P = -(-Ls // 16) * 16
    assert [tuple(o.shape) for o in ops] == [(L, P)] * 4 + [(L, L)] * 4
    assert all(o.is_contiguous() and o.dtype == torch.bfloat16 for o in ops)
    for o, w in zip(ops[:4], tw[:4]):
        assert torch.equal(o[:, :Ls], w.T)
        assert not o[:, Ls:].any()
    for o, w in zip(ops[4:], tw[4:]):
        assert torch.equal(o, w.T)


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
@pytest.mark.parametrize("Ls,C", [(16, 3), (24, 1)])
def test_emulation_matches_pallas_interpret(dtype_name, Ls, C):
    args = _args(32, Ls, C, 2, dtype_name, seed=10 + Ls + C)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    jargs = tuple(jnp.asarray(np_(a.float())).astype(jdt) for a in args)
    want = jfused.fused_correlate(*jargs, interpret=True)
    got = emulate_tc(*args)
    for g, w in zip(got, want):
        assert _rel(g, t_(w)) <= TOL[dtype_name]


def test_emulation_rounds_where_the_kernel_rounds():
    """In bf16 the emulation differs from its float32 self on the same
    bf16 inputs (the cast points are there) by no more than bf16
    rounding."""
    args = _args(32, 24, 3, 2, "bfloat16", seed=7)
    got = emulate_tc(*args)
    want = emulate_tc(*(a.float() for a in args))
    for g, w in zip(got, want):
        assert 0 < (g - w).abs().max() <= TOL["bfloat16"] * w.abs().max()
