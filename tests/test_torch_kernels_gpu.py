"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``gpu``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: max |kernel - plain| <= 1e-4 max |plain| in float32 (sums in
another order; 3xTF32 on the tensor cores), 2e-2 in bf16 (the same
rounding points, where one bf16 ulp is 2^-8 relative).  K1 runs every
box up to 128 at every even L up to 128 on the tensor cores (bf16 on
its tc kernel, float32 on its tf32 kernel; boxes above 64 in tiles of
A; L not a multiple of 16 padded to one in the kernel;
``fused.k1_route``); both are held here, with one receptor spectrum or
G of them, as are K2's FFT kernel (L = 32, 64, 96, 128) and K3's
(L = 16, 32, 48, 64, 80, 96, 112, 128), the only kernel of each
(``invz_topk.k2_route``, ``idft.k3_route``; other L raise).  K2 and K3
are float32 only.  One train step is held against the same step on the
CPU.

The splat kernel (``csrc/separable_splat.cu``) is held against the plain
version on the card voxel by voxel: |kernel - plain| <= 1e-5 |plain| +
2^-126.  Every term is positive and rounded as the plain version rounds
it, so only the order of the float32 sum differs (the kernel sums each
type's atoms in ascending order, as the bmm does: at the cells' shapes
the two are bit-equal; the plain version's atom chunks at n > 4096
reorder it); below the smallest normal float a value keeps only
absolute precision.
"""
import numpy as np
import pytest
import torch

from torch_parity import cuda_device  # noqa: F401

from deeplocalproteindocking_torch.correlate import fused, idft, invz_topk
from deeplocalproteindocking_torch.correlate._contract import mm
from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_torch.correlate.fft import receptor_transform
from deeplocalproteindocking_torch.grids import voxelize
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.refine import refine_poses
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
    (128, 32, 3, 4, "float32", 1e-4),     # tf32 at the bench box
    (128, 64, 3, 2, "float32", 1e-4),     # the largest tf32 box
    (128, 20, 2, 3, "float32", 1e-4),     # a box padded to 32
    (128, 32, 3, 4, "bfloat16", 2e-2),
    (64, 40, 16, 3, "float32", 1e-4),     # the v9p config: C = 16, box 40
    (32, 16, 1, 2, "float32", 1e-4),      # one warp pair, one channel
    (32, 16, 2, 5, "bfloat16", 2e-2),
    (128, 16, 3, 2, "bfloat16", 2e-2),
    (128, 40, 3, 2, "bfloat16", 2e-2),
    (128, 64, 3, 2, "bfloat16", 2e-2),    # the largest one-tile box
    (64, 40, 16, 3, "bfloat16", 2e-2),
    (128, 72, 3, 2, "bfloat16", 2e-2),    # boxes above 64: tiles of A
    (128, 96, 3, 2, "bfloat16", 2e-2),
    (128, 128, 3, 1, "bfloat16", 2e-2),
    (128, 71, 3, 2, "bfloat16", 2e-2),    # odd Y: A by plain loads
    (64, 33, 2, 2, "bfloat16", 2e-2),
    (128, 72, 3, 2, "float32", 1e-4),
    (128, 96, 3, 2, "float32", 1e-4),
    (128, 128, 3, 1, "float32", 1e-4),
    (96, 80, 16, 2, "float32", 1e-4),     # C = 16, the last tile 16 wide
    (120, 72, 3, 2, "float32", 1e-4),     # L not a multiple of 16: padded
    (120, 32, 2, 3, "bfloat16", 2e-2),
    (98, 40, 2, 2, "float32", 1e-4),      # L = 2 mod 4: D rows 8-byte
    (98, 40, 2, 2, "bfloat16", 2e-2),     # aligned
    (72, 71, 2, 2, "bfloat16", 2e-2),     # odd box, padded L
    (50, 24, 3, 3, "float32", 1e-4),
    (128, 40, 16, 2, "float32", 1e-4),    # the full-sweep chunk's shape
    (128, 48, 16, 2, "float32", 1e-4),
    (64, 40, 16, 16, "float32", 1e-4)])   # cell 2's chunk: b = 16
def test_k1_matches_plain(cuda_device, L, Ls, C, b, dtype_name, tol):
    _, args = _k1_args(cuda_device, L, Ls, C, b, dtype_name)
    route = fused.k1_route(args[0].dtype, Ls, Ls, L, L, L, L)
    assert route == ("tc" if dtype_name == "bfloat16" else "tf32")
    n0, tc0, tf0 = fused.launches, fused.launches_tc, fused.launches_tf32
    got = fused.fused_correlate(*args)
    torch.cuda.synchronize()
    assert fused.launches == n0 + 1
    assert fused.launches_tc == tc0 + int(route == "tc")
    assert fused.launches_tf32 == tf0 + int(route == "tf32")
    want = fused.fused_correlate_reference(*args)
    for gt, wt in zip(got, want):
        assert _rel(gt, wt) <= tol


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k1_takes_the_correlators_layouts(cuda_device, dtype_name):
    """The correlator's kept twiddle layouts give the launch that makes
    its own the same D, bit for bit; layouts of the other route's shape
    raise before the launch."""
    corr, args = _k1_args(cuda_device, 64, 40, 3, 2, dtype_name)
    made = fused.fused_correlate(*args)
    kept = fused.fused_correlate(*args, layouts=corr.k1_layouts)
    for m, k in zip(made, kept):
        assert torch.equal(m, k)
    other = (fused.tc_operands if dtype_name == "float32"
             else fused.tf32_operands)
    wrong = tuple(o.to(args[0].dtype) for o in other(
        *(w.float() for w in args[4:])))
    n0 = fused.launches
    with pytest.raises(ValueError, match="shape"):
        fused.fused_correlate(*args, layouts=wrong)
    assert fused.launches == n0


@pytest.mark.parametrize("X,Y,J,I,Xp,Yp,C", [
    (40, 48, 128, 128, 128, 128, 16),     # box 40 x 48 at the full sweep's L
    (24, 40, 64, 48, 32, 64, 3),          # every axis its own size
    (72, 40, 120, 96, 128, 100, 2),       # x tiles of A, kL = 128
    (16, 16, 32, 30, 64, 18, 1)])
def test_k1_tf32_takes_distinct_twiddles(cuda_device, X, Y, J, I, Xp, Yp, C):
    """Wy, Wx, Ux and Uy four different matrices of their own shapes (the
    correlator passes the same matrix for Wy and Wx, and for Ux and Uy):
    the kernel against the plain version."""
    g = torch.Generator().manual_seed(X + J + C)
    b, K = 3, 5

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(cuda_device)

    args = (rnd(b, K, C, X, Y), rnd(b, K, C, X, Y), rnd(K, C, J, I),
            rnd(K, C, J, I), rnd(Y, J), rnd(Y, J), rnd(X, I), rnd(X, I),
            rnd(I, Xp), rnd(I, Xp), rnd(J, Yp), rnd(J, Yp))
    assert fused.k1_route(torch.float32, X, Y, I, J, Xp, Yp) == "tf32"
    got = fused.fused_correlate(*args)
    want = fused.fused_correlate_reference(*args)
    for gt, wt in zip(got, want):
        assert gt.shape == (b, K, Xp, Yp)
        assert _rel(gt, wt) <= 1e-4


def test_k1_tf32_refuses_a_block_that_does_not_fit(cuda_device,
                                                   monkeypatch):
    """A shape the tf32 route takes, on a card that gave a block less
    shared memory than that shape needs: the wrapper raises before the
    launch (no count moves)."""
    _, args = _k1_args(cuda_device, 128, 64, 3, 1, "float32")
    need = fused.tf32_smem_bytes(64, 64, 128, 128, 128, 128)
    monkeypatch.setattr(fused, "SMEM_OPTIN_BYTES", need - 1)
    n0, tf0 = fused.launches, fused.launches_tf32
    with pytest.raises(ValueError, match="shared memory"):
        fused.fused_correlate(*args)
    assert (fused.launches, fused.launches_tf32) == (n0, tf0)


def test_k1_tc_refuses_a_block_that_does_not_fit(cuda_device,
                                                 monkeypatch):
    """The tc route at box 128 on a card that gave a block less shared
    memory than it needs: the wrapper raises before the launch."""
    _, args = _k1_args(cuda_device, 128, 128, 1, 1, "bfloat16")
    need = fused.tc_smem_bytes(128, 128, 128, 128, 128)
    monkeypatch.setattr(fused, "SMEM_OPTIN_BYTES", need - 1)
    n0, tc0 = fused.launches, fused.launches_tc
    with pytest.raises(ValueError, match="shared memory"):
        fused.fused_correlate(*args)
    assert (fused.launches, fused.launches_tc) == (n0, tc0)


def test_k1_tc_takes_a_2_byte_aligned_a(cuda_device):
    """A views 2 bytes off a 4-byte boundary: the tc kernel loads them
    with plain loads instead of cp.async, to the same D bit for bit."""
    _, args = _k1_args(cuda_device, 128, 72, 2, 2, "bfloat16")
    want = fused.fused_correlate(*args)
    shifted = []
    for a in args[:2]:
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda_device)
        view = flat[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 4 == 2
        shifted.append(view)
    got = fused.fused_correlate(*shifted, *args[2:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1_tf32_refuses_misaligned_h(cuda_device):
    """The tf32 kernel reads H in pairs: an H view 4 bytes off an 8-byte
    boundary raises before the launch."""
    _, args = _k1_args(cuda_device, 32, 16, 2, 2, "float32")
    flat = torch.empty(args[2].numel() + 1, device=cuda_device)
    shifted = flat[1:].view(args[2].shape)
    shifted.copy_(args[2])
    n0 = fused.launches
    with pytest.raises(ValueError, match="8-byte"):
        fused.fused_correlate(args[0], args[1], shifted, *args[3:])
    assert fused.launches == n0


@pytest.mark.parametrize("L,Ls,C,b,dtype_name,tol", [
    (128, 32, 3, 8, "bfloat16", 2e-2),    # tensor cores, the batched step
    (64, 40, 16, 4, "bfloat16", 2e-2),
    (128, 32, 3, 8, "float32", 1e-4),     # tf32
    (64, 40, 16, 4, "float32", 1e-4),     # tf32 at the v9p config
    (64, 72, 2, 4, "float32", 1e-4),      # tf32, box above 64 (2 x 2 tiles)
    (64, 72, 2, 4, "bfloat16", 2e-2),     # tc, box above 64 (two x tiles)
    (128, 96, 3, 8, "bfloat16", 2e-2),
    (128, 96, 3, 8, "float32", 1e-4),
    (120, 72, 2, 4, "float32", 1e-4),     # tf32, L padded to 128
    (120, 40, 2, 4, "bfloat16", 2e-2)])   # tc, L padded to 128
def test_k1_groups_match_plain(cuda_device, L, Ls, C, b, dtype_name, tol):
    """Every K1 route with G = 4 receptor spectra (rows [g b/4, (g+1)
    b/4) against H[g]) against the plain version."""
    _, args = _k1_args(cuda_device, L, Ls, C, b, dtype_name, groups=4)
    assert args[2].shape == (4, L // 2 + 1, C, L, L)
    route = fused.k1_route(args[0].dtype, Ls, Ls, L, L, L, L)
    n0, tc0, tf0 = fused.launches, fused.launches_tc, fused.launches_tf32
    got = fused.fused_correlate(*args)
    torch.cuda.synchronize()
    assert (fused.launches, fused.launches_tc, fused.launches_tf32) == (
        n0 + 1, tc0 + int(route == "tc"), tf0 + int(route == "tf32"))
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


@pytest.mark.parametrize("L,b,groups,source", [
    (64, 4, 1, "k1"), (64, 4, 2, "k1"), (64, 4, 4, "k1"),
    (128, 4, 1, "random"), (128, 3, 1, "random"), (128, 6, 3, "random"),
    (128, 5, 5, "random"), (64, 4, 2, "random"), (64, 7, 1, "random"),
    (96, 4, 2, "k1"), (96, 5, 5, "random"), (96, 3, 1, "random"),
    (32, 4, 2, "random"), (32, 3, 1, "random"), (32, 5, 5, "random"),
    (32, 4, 1, "k1")])
def test_k2_matches_plain(cuda_device, L, b, groups, source):
    """K2's FFT kernel against the plain version at L = 32, 64, 96 and
    128 (odd b: a block's second rotation missing; G = b: every rotation
    its own group)."""
    (Dre, Dim), corr, bias = _k2_inputs(cuda_device, L, b, groups, source)
    assert invz_topk.k2_route(L) == "fft"
    n0, f0 = invz_topk.launches, invz_topk.launches_fft
    got = invz_topk.invz_blockmax(Dre, Dim, corr.MzRe, corr.MzIm, bias)
    torch.cuda.synchronize()
    assert invz_topk.launches == n0 + 1
    assert invz_topk.launches_fft == f0 + 1
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
    # An L that no kernel takes (Y = 32 keeps the y runs whole).
    c48 = get_correlator(48, 16, "float32", cuda_device)
    d48 = torch.zeros((2, 25, 4, 32), device=cuda_device)
    with pytest.raises(ValueError, match="no kernel for L=48"):
        invz_topk.invz_blockmax(d48, d48, c48.MzRe, c48.MzIm,
                                torch.zeros((4, 32, 48), device=cuda_device))


def _k3_args(dev, L, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    corr = get_correlator(L, 16, "float32", dev)
    e = [torch.randn(b, L, L, L, generator=g).to(dev) for _ in range(2)]
    return (*e, corr.UxRe32, corr.UxIm32, corr.UxRe32, corr.UxIm32)


@pytest.mark.parametrize("L,b", [
    (64, 1), (64, 2), (64, 8), (128, 1), (128, 2), (128, 3), (128, 8),
    (96, 1), (96, 3), (96, 8), (48, 2), (48, 3), (80, 2), (80, 5),
    (112, 1), (112, 3), (32, 1), (32, 2), (32, 3), (16, 1), (16, 3),
    (16, 8)])
def test_k3_matches_plain(cuda_device, L, b):
    """K3's FFT kernel against the plain version at L = 16, 32, 48, 64,
    80, 96, 112 and 128 (odd b: a pass-2 block's second rotation
    missing; a half-full last z run at 48, 80 and 112, and at 16 the
    only run)."""
    args = _k3_args(cuda_device, L, b)
    assert idft.k3_route(L) == "fft"
    n0, f0 = idft.launches, idft.launches_fft
    got = idft.idft_bc(*args)
    torch.cuda.synchronize()
    assert idft.launches == n0 + 1
    assert idft.launches_fft == f0 + 1
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
    with pytest.raises(ValueError, match="no kernel for L=144"):
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


def test_train_step_matches_cpu(cuda_device):
    """One train step at the v9p model's widths (grid 32, box 24, 8
    decoys): the same host-built batch and params on the card and on the
    CPU give the loss within rtol 1e-4, every gradient within 1e-3 of
    its leaf's largest, and the updated params within 1e-2 lr (2 lr
    where a gradient is below 1e-3 of its leaf's largest: Adam's first
    step is lr times its sign)."""
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.data import synthetic_complex
    from deeplocalproteindocking_torch.train import Trainer
    from deeplocalproteindocking_torch.train.data_gen import (
        make_training_batch)
    lr = 1e-4
    cfg = DockConfig(grid_size=32, resolution=1.25, rep_features=(32, 14),
                     shape_prior=True, lig_grid_size=24, num_decoys=8,
                     batch_complexes=1, learning_rate=lr, weight_decay=1e-4,
                     lr_decay_steps=3000, near_native_rmsd=5.0,
                     hinge_margin=20.0, decoy_global_frac=0.5)
    cplx = [synthetic_complex(seed=s, n_res_rec=8, n_res_lig=4)
            for s in range(2)]
    batch = make_training_batch(torch.Generator().manual_seed(0), cplx, cfg,
                                device="cpu")
    state = Trainer(cfg, device="cpu").init_state(0)
    # A coupled learned block, so every leaf has a gradient.
    g = torch.Generator().manual_seed(1)
    state.params["coupling"] += 0.1 * torch.randn(
        state.params["coupling"].shape, generator=g)
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(cfg, device=dev)
        st = state.to(dev)
        loss, acc, grads = tr.value_and_grad(st.params, batch.to(dev))
        new = tr.apply_gradients(st, grads)
        out[str(dev)] = (loss.item(), acc.item(),
                         {k: v.cpu() for k, v in grads.items()},
                         {k: v.cpu() for k, v in new.params.items()})
    (l0, a0, g0, p0), (l1, a1, g1, p1) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    np.testing.assert_allclose(a1, a0, rtol=0, atol=1e-6)
    for k, w in g0.items():
        assert float(w.abs().max()) > 0, k
        assert (g1[k] - w).abs().max() <= 1e-3 * w.abs().max(), k
        small = w.abs() < 1e-3 * w.abs().max()
        tol = torch.where(small, 2 * lr, 1e-2 * lr)
        assert bool(((p1[k] - p0[k]).abs() <= tol).all()), k


# ---- the splat kernel ----

def _ligand_rows(dev, n_res, b, seed=0, bucket=128):
    """A polymer ligand of ``n_res`` residues (padded to ``bucket``
    atoms) rotated b ways: (coords [b, n, 3], types, mask) on ``dev``."""
    from deeplocalproteindocking_torch.data import (structure_to_device,
                                                    synthetic_complex)
    cplx = synthetic_complex(seed=seed, n_res_rec=300, n_res_lig=n_res,
                             backbone=True)
    c, t, m = structure_to_device(cplx.ligand.centered(), bucket=bucket)
    R = super_fibonacci_rotations(b, dev)
    return (torch.einsum("bij,nj->bni", R, c.to(dev)).contiguous(),
            t.to(dev), m.to(dev))


def _plain_splat(coords, types, mask, **kw):
    """``separable_splat``'s plain version on the card (coordinates that
    need a gradient take it)."""
    with torch.enable_grad():
        return voxelize.separable_splat(
            coords.detach().requires_grad_(True), types, mask,
            **kw).detach()


def _splat_close(got, want):
    err = (got - want).abs()
    return bool((err <= 1e-5 * want.abs() + 2.0 ** -126).all())


@pytest.mark.parametrize("case", ["cell1", "cell2", "receptor", "groups"])
def test_splat_kernel_matches_plain(cuda_device, case):
    """The serve config's chunk (b = 128, box 72, 2,176 atoms), the
    checkpoint config's (b = 16, box 40), the receptor at grid 128 with
    n > 4,096 atoms (two of the kernel's segments; the plain version's
    atom chunks) and per-complex types of a batched sweep step."""
    dev = cuda_device
    kw = dict(resolution=1.25, sigma=1.0, num_types=11)
    if case == "cell1":
        coords, types, mask = _ligand_rows(dev, 250, 128)
        kw.update(grid_size=72)
    elif case == "cell2":
        coords, types, mask = _ligand_rows(dev, 35, 16, seed=4, bucket=64)
        kw.update(grid_size=40)
    elif case == "receptor":
        from deeplocalproteindocking_torch.data import (structure_to_device,
                                                        synthetic_complex)
        rec = synthetic_complex(seed=1, n_res_rec=700, n_res_lig=20,
                                backbone=True).receptor
        coords, types, mask = (v.to(dev) for v in structure_to_device(
            rec, bucket=128))
        assert coords.shape[0] > 4096
        kw.update(grid_size=128, atom_chunk=4096)
    else:
        c, t, m = _ligand_rows(dev, 250, 8)
        coords = c.reshape(2, 4, *c.shape[1:])
        types = torch.stack([t, t.roll(7)])[:, None]
        mask = torch.stack([m, m.roll(7)])[:, None]
        kw.update(grid_size=72)
    l0, p0 = voxelize.launches, voxelize.plain_calls
    with torch.inference_mode():
        got = voxelize.separable_splat(coords, types, mask, **kw)
    torch.cuda.synchronize()
    assert (voxelize.launches - l0, voxelize.plain_calls - p0) == (1, 0)
    want = _plain_splat(coords, types, mask, **kw)
    assert got.shape == want.shape and got.stride() == want.stride()
    assert bool(torch.isfinite(got).all())
    assert _splat_close(got, want)


def test_splat_kernel_refuses_what_it_does_not_take(cuda_device):
    coords, types, mask = _ligand_rows(cuda_device, 20, 2, bucket=64)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32"):
            voxelize.separable_splat(coords.double(), types, mask)
        with pytest.raises(ValueError, match="atom types"):
            voxelize.separable_splat(coords, types, mask, num_types=17)
        with pytest.raises(ValueError, match="atom sets"):
            voxelize.separable_splat(
                coords[:1].expand(65536, -1, -1), types, mask)


def test_refine_poses_gets_gradients_through_the_plain_path(cuda_device):
    """refine_poses differentiates the splat in the coordinates: its steps
    take the plain version on the card (its scores before and after, with
    no gradient, the kernel) and give the CPU's refinement."""
    rng = np.random.default_rng(5)
    L, Ls, C = 32, 16, 3
    rec = torch.as_tensor(rng.normal(size=(L, L, L, C)), dtype=torch.float32)
    coords = torch.as_tensor(rng.normal(size=(20, 3)) * 3.0,
                             dtype=torch.float32)
    types = torch.as_tensor(rng.integers(0, 11, size=20), dtype=torch.int32)
    mask = torch.ones(20)
    w = torch.as_tensor(rng.normal(size=(11, C)), dtype=torch.float32)
    R = super_fibonacci_rotations(4)
    shifts = torch.as_tensor(rng.integers(-3, 4, size=(4, 3)),
                             dtype=torch.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        l0, p0 = voxelize.launches, voxelize.plain_calls
        res = refine_poses(receptor_transform(rec.to(dev)), coords.to(dev),
                           types.to(dev), mask.to(dev), R.to(dev),
                           shifts.to(dev), lambda v: v @ w.to(v.device),
                           grid_size=L, lig_grid=Ls, resolution=1.25,
                           sigma=1.0, num_types=11, steps=5)
        out[str(dev)] = (res, voxelize.launches - l0,
                         voxelize.plain_calls - p0)
    (a, la, pa), (c, lc, pc) = out["cpu"], out[str(cuda_device)]
    assert (la, pa) == (0, 7)
    assert (lc, pc) == (2, 5)
    np.testing.assert_allclose(c.scores.cpu().numpy(), a.scores.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c.translations.cpu().numpy(),
                               a.translations.numpy(), rtol=0, atol=1e-3)
