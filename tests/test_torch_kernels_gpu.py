"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``gpu``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: max |kernel - plain| <= 1e-4 max |plain| in float32 (sums in
another order), 2e-2 in bf16 (the same rounding points, where one bf16
ulp is 2^-8 relative).  K1 runs bf16 boxes up to 64 on its tensor-core
kernel and the rest on its SIMT kernel (``fused.k1_route``); both are
held here, with one receptor spectrum or G of them, as are K2's and
K3's FFT kernels (L = 64, 128) and dense kernels (other L;
``invz_topk.k2_route``, ``idft.k3_route``).  K2 and K3 are float32
only.
"""
import numpy as np
import pytest
import torch

from torch_parity import cuda_device  # noqa: F401

from deeplocalproteindocking_torch.correlate import fused, idft, invz_topk
from deeplocalproteindocking_torch.correlate._contract import mm
from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_torch.correlate.fft import receptor_transform
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _no_tf32():
    mm_flag = torch.backends.cuda.matmul.allow_tf32
    conv_flag = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = mm_flag
    torch.backends.cudnn.allow_tf32 = conv_flag


def _k1_args(dev, L, Ls, C, b, dtype_name, seed=0, groups=None):
    """K1's arguments; ``groups``: that many receptor spectra ``[G, K, C,
    J, I]`` instead of one."""
    g = torch.Generator().manual_seed(seed)
    corr = get_correlator(L, Ls, dtype_name, dev)
    lead = () if groups is None else (groups,)
    H = receptor_transform(torch.randn(lead + (L, L, L, C),
                                       generator=g).to(dev))
    v = torch.randn(b, Ls, Ls, Ls, C, generator=g).to(dev, corr.dtype)
    are = mm("bxyzc,zk->bkcxy", v, corr.WzRe).to(corr.dtype).contiguous()
    aim = mm("bxyzc,zk->bkcxy", v, corr.WzIm).to(corr.dtype).contiguous()
    Ht = corr.prep_H(H)
    return corr, (are, aim, Ht[0], Ht[1], corr.WyRe, corr.WyIm, corr.WxRe,
                  corr.WxIm, corr.UxRe, corr.UxIm, corr.UyRe, corr.UyIm)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("L,Ls,C,b,dtype_name,tol", [
    (128, 32, 3, 4, "float32", 1e-4),
    (128, 32, 3, 4, "bfloat16", 2e-2),
    (64, 40, 16, 3, "float32", 1e-4),     # full-rank channels, odd box
    (32, 16, 2, 5, "bfloat16", 2e-2),
    (128, 16, 3, 2, "bfloat16", 2e-2),
    (128, 40, 3, 2, "bfloat16", 2e-2),
    (128, 64, 3, 2, "bfloat16", 2e-2),    # the largest tensor-core box
    (64, 40, 16, 3, "bfloat16", 2e-2),
    (128, 72, 3, 2, "bfloat16", 2e-2),    # bf16 on the SIMT kernel
    (128, 96, 3, 2, "float32", 1e-4),     # boxes the SIMT kernel refused
    (128, 128, 3, 1, "float32", 1e-4)])   # before A left shared memory
def test_k1_matches_plain(cuda_device, L, Ls, C, b, dtype_name, tol):
    _, args = _k1_args(cuda_device, L, Ls, C, b, dtype_name)
    tc = fused.k1_route(args[0].dtype, Ls, Ls, L, L, L, L) == "tc"
    assert tc == (dtype_name == "bfloat16" and Ls <= 64)
    n0, tc0 = fused.launches, fused.launches_tc
    got = fused.fused_correlate(*args)
    torch.cuda.synchronize()
    assert fused.launches == n0 + 1
    assert fused.launches_tc == tc0 + int(tc)
    want = fused.fused_correlate_reference(*args)
    for gt, wt in zip(got, want):
        assert _rel(gt, wt) <= tol


@pytest.mark.parametrize("L,Ls,C,b,dtype_name,tol", [
    (128, 32, 3, 8, "bfloat16", 2e-2),    # tensor cores, the batched step
    (64, 40, 16, 4, "bfloat16", 2e-2),
    (128, 32, 3, 8, "float32", 1e-4),     # SIMT
    (64, 72, 2, 4, "bfloat16", 2e-2)])    # SIMT in bf16 (box above 64)
def test_k1_groups_match_plain(cuda_device, L, Ls, C, b, dtype_name, tol):
    """Both K1 routes with G = 4 receptor spectra (rows [g b/4, (g+1)
    b/4) against H[g]) against the plain version."""
    _, args = _k1_args(cuda_device, L, Ls, C, b, dtype_name, groups=4)
    assert args[2].shape == (4, L // 2 + 1, C, L, L)
    tc = fused.k1_route(args[0].dtype, Ls, Ls, L, L, L, L) == "tc"
    n0, tc0 = fused.launches, fused.launches_tc
    got = fused.fused_correlate(*args)
    torch.cuda.synchronize()
    assert (fused.launches, fused.launches_tc) == (n0 + 1, tc0 + int(tc))
    want = fused.fused_correlate_reference(*args)
    for gt, wt in zip(got, want):
        assert _rel(gt, wt) <= tol
    # Each group's rows differ from what H[0] gives them.
    alone = fused.fused_correlate(args[0], args[1], args[2][0], args[3][0],
                                  *args[4:])
    assert _rel(alone[0][b // 4:], want[0][b // 4:]) > 10 * tol
    with pytest.raises(ValueError, match="do not divide"):
        fused.fused_correlate(args[0][:b - 1], args[1][:b - 1], *args[2:])


def _k2_inputs(dev, L, b, groups, source, seed=3):
    """D [b, L/2+1, X, L] (``source`` "k1": from the float32 K1, X = L;
    "random": X = 16), the correlator's Mz, and a bias of ``groups``
    groups masking ~40% of the cells and one whole y run."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if source == "k1":
        corr, args = _k1_args(dev, L, 16, 3, b, "float32", seed=1)
        D, X = fused.fused_correlate(*args), L
    else:
        corr, X = get_correlator(L, 16, "float32", dev), 16
        D = [torch.randn((b, L // 2 + 1, X, L), generator=g, device=dev)
             for _ in range(2)]
    keep = torch.rand((groups, X, L, L), generator=g, device=dev) < 0.6
    bias = torch.where(keep, 0.0, float("-inf"))
    bias[0, 3, 0:32, 5] = float("-inf")
    return D, corr, bias


@pytest.mark.parametrize("L,b,groups,source,route", [
    (64, 4, 1, "k1", "fft"), (64, 4, 2, "k1", "fft"),
    (64, 4, 4, "k1", "fft"), (128, 4, 1, "random", "fft"), (128, 3, 1, "random", "fft"),
    (128, 6, 3, "random", "fft"), (128, 5, 5, "random", "fft"),
    (64, 4, 2, "random", "fft"), (64, 7, 1, "random", "fft"),
    (96, 4, 2, "random", "dense")])
def test_k2_matches_plain(cuda_device, L, b, groups, source, route):
    """Both K2 kernels against the plain version: the FFT kernel at
    L = 64 and 128 (odd b: a block's second rotation missing; G = b:
    every rotation its own group), the dense kernel at L = 96."""
    (Dre, Dim), corr, bias = _k2_inputs(cuda_device, L, b, groups, source)
    assert invz_topk.k2_route(L) == route
    n0, f0 = invz_topk.launches, invz_topk.launches_fft
    got = invz_topk.invz_blockmax(Dre, Dim, corr.MzRe, corr.MzIm, bias)
    torch.cuda.synchronize()
    assert invz_topk.launches == n0 + 1
    assert invz_topk.launches_fft == f0 + int(route == "fft")
    want = invz_topk.invz_blockmax_reference(Dre, Dim, corr.MzRe,
                                             corr.MzIm, bias)
    assert got.shape == want.shape == (b, Dre.shape[2], L // 32, L)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert not torch.isnan(got).any()
    assert got[0, 3, 0, 5].item() == float("-inf")
    assert _rel(got[fin], want[fin]) <= 1e-4


def test_k2_fft_refuses_what_it_does_not_take(cuda_device):
    (Dre, Dim), corr, bias = _k2_inputs(cuda_device, 64, 2, 1, "random")
    with pytest.raises(ValueError, match="not its matrix"):
        invz_topk.invz_blockmax(Dre, Dim, corr.MzIm.clone(), corr.MzIm,
                                bias)
    flat = torch.empty(Dre.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(Dre.shape)            # 4-byte aligned only
    with pytest.raises(ValueError, match="16-byte"):
        invz_topk.invz_blockmax(shifted, Dim, corr.MzRe, corr.MzIm, bias)


def _k3_args(dev, L, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    corr = get_correlator(L, 16, "float32", dev)
    e = [torch.randn(b, L, L, L, generator=g).to(dev) for _ in range(2)]
    return (*e, corr.UxRe32, corr.UxIm32, corr.UxRe32, corr.UxIm32)


@pytest.mark.parametrize("L,b,route", [
    (64, 1, "fft"), (64, 2, "fft"), (64, 8, "fft"), (128, 1, "fft"),
    (128, 2, "fft"), (128, 3, "fft"), (128, 8, "fft"), (96, 2, "dense")])
def test_k3_matches_plain(cuda_device, L, b, route):
    """Both K3 kernels against the plain version: the FFT kernel at
    L = 64 and 128 (odd b: a pass-2 block's second rotation missing),
    the dense kernel at L = 96."""
    args = _k3_args(cuda_device, L, b)
    assert idft.k3_route(L) == route
    n0, f0 = idft.launches, idft.launches_fft
    got = idft.idft_bc(*args)
    torch.cuda.synchronize()
    assert idft.launches == n0 + 1
    assert idft.launches_fft == f0 + int(route == "fft")
    want = idft.idft_bc_reference(*args)
    assert got.shape == (b, L, L, L) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4


def test_k3_fft_refuses_what_it_does_not_take(cuda_device):
    ere, eim, uxr, uxi, _, _ = _k3_args(cuda_device, 64, 2)
    with pytest.raises(ValueError, match="UyRe is not its matrix"):
        idft.idft_bc(ere, eim, uxr, uxi, uxi.clone(), uxi)
    with pytest.raises(ValueError, match="not its matrix"):
        idft.idft_bc(ere, eim, uxr.bfloat16().float(), uxi, uxr, uxi)
    flat = torch.empty(ere.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(ere.shape)            # 4-byte aligned only
    with pytest.raises(ValueError, match="16-byte"):
        idft.idft_bc(shifted, eim, uxr, uxi, uxr, uxi)


def test_k3_refuses_what_it_does_not_take(cuda_device):
    args = _k3_args(cuda_device, 32, 2)
    with pytest.raises(TypeError):
        idft.idft_bc(*(a.to(torch.float64) for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        idft.idft_bc(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="divisible by 8 and 16"):
        idft.idft_bc(*_k3_args(cuda_device, 24, 1))
    with pytest.raises(ValueError, match="L <= 128"):
        idft.idft_bc(*_k3_args(cuda_device, 144, 1))


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    _, args = _k1_args(cuda_device, 32, 16, 2, 2, "float32")
    with pytest.raises(TypeError):
        fused.fused_correlate(*(a.to(torch.float64) for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_correlate(args[0].transpose(3, 4), *args[1:])
    with pytest.raises(ValueError, match="L <= 128"):
        _, big = _k1_args(cuda_device, 192, 16, 1, 1, "float32")
        fused.fused_correlate(*big)


@pytest.mark.parametrize("fft_impl", ["dft_fused", "dft_pallas"])
def test_sweep_card_matches_cpu(cuda_device, fft_impl):
    """The resplat sweep on the card (K1 -> K2 tail, or K3) gives the
    CPU sweep's top-K (plain versions, score-volume path)."""
    rng = np.random.default_rng(3)
    L, Ls, C = 64, 16, 3
    rec = torch.as_tensor(rng.normal(size=(L, L, L, C)), dtype=torch.float32)
    coords = torch.as_tensor(rng.normal(size=(20, 3)) * 3.0,
                             dtype=torch.float32)
    types = torch.as_tensor(rng.integers(0, 11, size=20), dtype=torch.int32)
    mask = torch.ones(20)
    w = torch.as_tensor(rng.normal(size=(11, C)), dtype=torch.float32)
    kw = dict(grid_size=L, lig_grid=Ls, resolution=1.25, sigma=1.0,
              num_types=11, top_k=16, chunk=8, fft_impl=fft_impl)
    out = {}
    for dev in ("cpu", cuda_device):
        H = receptor_transform(rec.to(dev))
        out[str(dev)] = dock_sweep_resplat(
            H, coords.to(dev), types.to(dev), mask.to(dev),
            super_fibonacci_rotations(20, dev), lambda v: v @ w.to(v.device),
            **kw)
    a, c = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(c.scores.cpu().numpy(), a.scores.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert c.rot_idx[0].item() == a.rot_idx[0].item()
    assert c.shifts[0].tolist() == a.shifts[0].tolist()
