"""The splat kernel (``csrc/separable_splat.cu``) on the CPU, and the
route ``separable_splat`` takes.

The CUDA kernel cannot run here, so this file holds its formulation: a
torch emulation of its stages -- the tile of ``splat_tile`` (Yb y x Zb z
x Xb x, tiles overhanging L), one block per (row, tile, type), the
stable compaction of the type's atoms (masked atoms and types below 0
skipped, types above T - 1 clamped; a contiguous run of atoms per
thread, placed by an exclusive scan) in segments, chunks of 64 atoms,
the profiles with the kernel's own arithmetic, each type's sums stored
into the tile's output runs as [t][x] and the last block's rewrite of
each run as [x][t], overhanging voxels masked -- against the plain
version (``_contract``) and the JAX ``separable_splat``, with shared and
per-row types.  Planted errors (an atom in the wrong type, a masked atom
counted, the last overhanging tile dropped, the runs left as [t][x])
must move the result.

Tolerance: per voxel, |emulation - plain| <= 1e-5 |plain| + 1e-5 max
|plain|.  All terms are positive, so the reordered float32 sum stays
within a few ulps of the plain one.  The kernel divides by the
resolution as PyTorch's CUDA kernels do, times the float32 reciprocal,
where the CPU divides: the voxel centre g then differs by an ulp, which
moves a profile at distance d by d dg / sigma^2 of itself -- in these
cases up to 1.5e-4 of a voxel's own value (L = 128, where g reaches
128), 1.7e-5 above a tenth of the largest, and at most 5e-6 of the
largest.  The planted errors move the result by 1e-2 of the largest and
more.  The kernel itself is held against the plain version on a card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import contextlib
import math
import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_

from deeplocalproteindocking_torch.data import (structure_to_device,
                                                synthetic_complex)
from deeplocalproteindocking_torch.grids import voxelize
from deeplocalproteindocking_tpu.grids import voxelize as jvox

KC = 64          # atoms a profile chunk (kKC)
RTOL = 1e-5


def _profiles(c, idx, L, res, sigma):
    """The kernel's ``profile``: ``c [k]`` one axis of k atoms, ``idx
    [m]`` voxel indices -> ``[k, m]``, each operation rounded in float32
    as the kernel rounds it (the reciprocals made in float32)."""
    f = np.float32
    origin = torch.tensor(f(-0.5 * L * res))
    inv_res = torch.tensor(f(1.0) / f(res))
    inv2 = torch.tensor(f(1.0) / f(2.0 * sigma * sigma))
    g = (c[:, None] - origin) * inv_res - 0.5
    d = (g - idx.to(torch.float32)) * torch.tensor(f(res))
    return torch.exp(-((d * d) * inv2))


def _compact(hit, nwarps):
    """The kernel's stable compaction of one type: ``hit [sn]`` marks the
    segment's atoms of the type; warp w takes atoms ``[w per, (w+1) per)``
    (per a multiple of 32, one ballot a group of 32) and a scan over the
    warps places each warp's.  Returns their indices in the order the
    kernel lists them."""
    sn = hit.shape[0]
    per = -(-sn // (32 * nwarps)) * 32
    padded = torch.zeros((nwarps * per,), dtype=torch.bool)
    padded[:sn] = hit
    mine = padded.reshape(nwarps, per)
    offset = torch.cumsum(mine.sum(1), 0) - mine.sum(1)
    rank = torch.cumsum(mine.to(torch.int64), 1) - 1
    pos = (offset[:, None] + rank)[mine]
    out = torch.empty(int(mine.sum()), dtype=torch.int64)
    out[pos] = torch.arange(nwarps * per).reshape(nwarps, per)[mine]
    return out


def emulate(coords, types, mask, L, T, res=1.25, sigma=1.0, seg=None,
            mutate=None):
    """``separable_splat`` as the kernel computes it, for ``coords [...,
    n, 3]`` float32 with ``types``/``mask`` shared ``[n]`` or per row.
    ``mutate`` plants an error: ``"bucket"`` (one atom's type moved to the
    next), ``"masked"`` (masked atoms counted, at weight 1),
    ``"drop_last_tile"`` (the overhanging tiles of each axis left out),
    ``"swap_xt"`` (the runs left in the order [t][x])."""
    lead = tuple(coords.shape[:-2])
    n = coords.shape[-2]
    B = math.prod(lead)
    coords = coords.reshape(B, n, 3)
    trows, tper = voxelize._rows(types.to(torch.int32), lead, n)
    if mask is None:
        mrows, mper = torch.ones((1, n)), B
    else:
        mrows, mper = voxelize._rows(mask.to(torch.float32), lead, n)
    Yb, Zb, Xb = voxelize.splat_tile(L, T)
    nt = max(KC, -(-((Yb // 2) * (Zb // 4) * (Xb // 8)) // 32) * 32)
    seg = seg or min(max(n, 1), 4096)
    cdiv = (lambda a, b: a // b) if mutate == "drop_last_tile" else (
        lambda a, b: -(-a // b))
    ny, nz, nx = cdiv(L, Yb), cdiv(L, Zb), cdiv(L, Xb)
    yi, zi, xi = (torch.arange(m) for m in (ny * Yb, nz * Zb, nx * Xb))
    out = torch.full((B * L ** 3 * T,), float("nan"))
    for b in range(B):
        t_row, w_row = trows[b // tper].long(), mrows[b // mper]
        if mutate == "masked":
            w_row = torch.where(w_row != 0, w_row, 1.0)
        kind = torch.where((t_row < 0) | (w_row == 0), -1,
                           t_row.clamp(max=T - 1))
        if mutate == "bucket":
            first = int(torch.nonzero(kind == 1)[0])
            kind[first] = 2
        # Every tile's block of type t at once, on the padded grid: tile
        # (yt, zt, xt) is [yt Yb, +Yb) x [zt Zb, +Zb) x [xt Xb, +Xb).
        sums = torch.zeros((ny * Yb, nz * Zb, nx * Xb, T))
        for t in range(T):
            for s0 in range(0, n, seg):
                listed = s0 + _compact(kind[s0:s0 + seg] == t, nt // 32)
                for c0 in range(0, listed.shape[0], KC):
                    a = listed[c0:c0 + KC]
                    c = coords[b, a]
                    v = _profiles(c[:, 0], xi, L, res, sigma) * w_row[a, None]
                    pz = _profiles(c[:, 2], zi, L, res, sigma)
                    py = _profiles(c[:, 1], yi, L, res, sigma)
                    u = py[:, :, None] * pz[:, None, :]
                    sums[..., t] += torch.einsum("kyz,kx->yzx", u, v)
        # The tile's runs D[b, y, z, x0 : x0 + xn, :]: each type's plane
        # stored as [t][x]; then the last block moves word f of each run to
        # its table's place (f % xn) T + f // xn, the order [x][t].
        st = sums.reshape(ny, Yb, nz, Zb, nx, Xb, T)
        y = (torch.arange(ny)[:, None] * Yb + torch.arange(Yb)).reshape(
            ny, Yb, 1, 1, 1, 1, 1)
        z = (torch.arange(nz)[:, None] * Zb + torch.arange(Zb)).reshape(
            1, 1, nz, Zb, 1, 1, 1)
        x0 = (torch.arange(nx) * Xb).reshape(1, 1, 1, 1, nx, 1, 1)
        xx = torch.arange(Xb).reshape(1, 1, 1, 1, 1, Xb, 1)
        t = torch.arange(T).reshape(1, 1, 1, 1, 1, 1, T)
        xn = (L - x0).clamp(max=Xb)
        start = ((b * L + y) * L + z) * L * T + x0 * T
        keep = ((y < L) & (z < L) & (xx < xn)).expand(st.shape)
        f = (t * xn + xx).expand(st.shape)
        out[(start + f)[keep]] = st[keep]
        if mutate != "swap_xt":
            where = (f % xn) * T + f // xn
            words = out[(start + f)[keep]].clone()
            out[(start + where)[keep]] = words
    return out.reshape(B, L, L, L, T).permute(0, 3, 1, 2, 4).reshape(
        lead + (L, L, L, T))


def _ligand(n_lig, seed=3, bucket=None):
    """A synthetic ligand's (coords, types, mask), padded to ``bucket``."""
    lig = synthetic_complex(seed, 20, n_lig).ligand.centered()
    return structure_to_device(lig, bucket=bucket)


def _rotated(coords, B, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 4), generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(B, 3, 3)
    return torch.einsum("bij,nj->bni", R, coords).contiguous()


def _per_row(types, mask, B, seed):
    """Per-row atom sets: each row's types permuted among the real atoms,
    a few of its atoms masked and one type made -1."""
    g = torch.Generator().manual_seed(seed)
    ts, ms = [], []
    for _ in range(B):
        t = types.clone()
        m = mask.clone()
        real = torch.nonzero(m > 0)[:, 0]
        t[real] = t[real][torch.randperm(real.shape[0], generator=g)]
        m[real[torch.randint(real.shape[0], (3,), generator=g)]] = 0.0
        t[real[-1]] = -1
        ts.append(t)
        ms.append(m)
    return torch.stack(ts), torch.stack(ms)


def _close(got, want):
    """Per voxel within RTOL of itself plus RTOL of the largest value."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    return bool((err <= RTOL * np.abs(want)
                 + RTOL * np.abs(want).max()).all())


# (L, B, n_lig residues, per-row types, seg): the serve box (72) and the
# checkpoint's (40), the receptor grid (128) and the smallest box (16);
# L = 50 overhangs its z and x tiles, L = 58 all three (its 64-wide x
# tile 58 voxels full); seg below n runs the atoms in segments whose
# count does not divide n.
CASES = [
    (16, 3, 6, False, None),
    (40, 2, 20, True, 64),
    (72, 2, 30, False, None),
    (128, 1, 10, False, 40),
    (50, 2, 12, True, None),
    (58, 1, 12, False, 48),
]


def _inputs(L, B, n_lig, per_row, seed=0):
    coords, types, mask = _ligand(n_lig, seed=seed + 3, bucket=16)
    # Shift the ligand off the box's centre so tiles see unlike atoms.
    coords_b = _rotated(coords, B, seed) + torch.tensor([1.5, -2.0, 0.75])
    if per_row:
        types, mask = _per_row(types, mask, B, seed)
    return coords_b, types, mask


@pytest.mark.parametrize("L,B,n_lig,per_row,seg", CASES)
def test_emulation_matches_plain_and_jax(L, B, n_lig, per_row, seg):
    coords, types, mask = _inputs(L, B, n_lig, per_row)
    kw = dict(grid_size=L, resolution=1.25, sigma=1.0, num_types=11)
    got = emulate(coords, types, mask, L, 11, seg=seg)
    want = voxelize.separable_splat(coords, types, mask, **kw)
    assert got.stride() == want.stride()
    assert _close(got, want)
    if per_row:
        jax_out = jax.vmap(lambda c, t, m: jvox.separable_splat(
            c, t, m, **kw))(jnp.asarray(np_(coords)), jnp.asarray(
                np_(types)), jnp.asarray(np_(mask)))
    else:
        jax_out = jax.vmap(lambda c: jvox.separable_splat(
            c, jnp.asarray(np_(types)), jnp.asarray(np_(mask)), **kw))(
                jnp.asarray(np_(coords)))
    assert _close(got, jax_out)


@pytest.mark.parametrize("mutate,L", [
    ("bucket", 40), ("masked", 40), ("drop_last_tile", 50),
    ("drop_last_tile", 58), ("swap_xt", 16)])
def test_planted_errors_are_caught(mutate, L):
    coords, types, mask = _inputs(L, 2, 12, True, seed=1)
    kw = dict(grid_size=L, resolution=1.25, sigma=1.0, num_types=11)
    want = voxelize.separable_splat(coords, types, mask, **kw)
    assert _close(emulate(coords, types, mask, L, 11), want)
    bad = emulate(coords, types, mask, L, 11, mutate=mutate)
    bad = torch.nan_to_num(bad, nan=-1.0)
    assert not _close(bad, want)


def test_compaction_is_stable_and_complete():
    g = torch.Generator().manual_seed(5)
    for sn, nwarps in ((1, 2), (37, 2), (300, 3), (4096, 7), (100, 8)):
        kind = torch.randint(0, 4, (sn,), generator=g)
        kind[::7] = -1
        for t in range(4):
            assert torch.equal(_compact(kind == t, nwarps),
                               torch.nonzero(kind == t)[:, 0])


def test_clamped_and_negative_types():
    # Types above T - 1 count as T - 1; types below 0 and masked atoms
    # add nothing, whatever their coordinates.
    coords, types, mask = _ligand(6, bucket=16)
    T = 5
    types = types.clone() % 9 - 1
    coords = coords.clone()
    coords[mask == 0] = 1e3
    kw = dict(grid_size=16, resolution=1.25, sigma=1.0, num_types=T)
    want = voxelize.separable_splat(coords[None], types, mask, **kw)
    assert _close(emulate(coords[None], types, mask, 16, T), want)


def test_splat_tile_fits_a_block():
    for L in list(range(1, 129)) + [160, 256]:
        for T in (1, 11, 16):
            Yb, Zb, Xb = voxelize.splat_tile(L, T)
            assert Yb % 2 == 0 and Zb % 4 == 0 and Xb % 8 == 0
            assert 1 <= (Yb // 2) * (Zb // 4) * (Xb // 8) <= 256
            assert (voxelize.splat_smem_bytes(Yb, Zb, Xb, T, 4096) + 1024
                    <= voxelize.SMEM_OPTIN_BYTES)


def test_splat_tile_at_the_cells_boxes():
    # Tiles that cover the serve box (72) and the receptor grid (128)
    # without overhang.
    for L in (72, 128, 64):
        for edge in voxelize.splat_tile(L, 11):
            assert L % edge == 0
    assert voxelize.splat_tile(72, 11) == (24, 24, 24)
    assert voxelize.splat_smem_bytes(24, 24, 24, 11, 4096) == 59_936


@pytest.mark.parametrize("tshape,lead,R,per", [
    ((7,), (4,), 1, 4),                  # shared
    ((4, 7), (4,), 4, 1),                # per row
    ((2, 1, 7), (2, 3), 2, 3),           # per complex, rows of a chunk
    ((1, 3, 7), (2, 3), 6, 1),           # broadcast in front: expanded
    ((3, 7), (2, 3), 6, 1),
    ((7,), (), 1, 1),
])
def test_rows(tshape, lead, R, per):
    x = torch.arange(math.prod(tshape)).reshape(tshape)
    rows, rows_per = voxelize._rows(x, lead, 7)
    assert rows.shape == (R, 7) and rows_per == per and rows.is_contiguous()
    full = x.broadcast_to(lead + (7,)).reshape(-1, 7)
    for b in range(full.shape[0]):
        assert torch.equal(rows[b // rows_per], full[b])


# ---- the route ----

def test_cpu_calls_take_the_plain_version():
    coords, types, mask = _ligand(4, bucket=16)
    l0, p0 = voxelize.launches, voxelize.plain_calls
    voxelize.separable_splat(coords, types, mask, grid_size=16)
    assert (voxelize.launches, voxelize.plain_calls) == (l0, p0 + 1)


@pytest.mark.parametrize("device,grad,mode,kernel", [
    ("cuda", False, "grad", True),
    ("cuda", True, "grad", False),       # refine_poses: needs a gradient
    ("cuda", True, "no_grad", True),
    ("cuda", True, "inference", True),
    ("cpu", False, "grad", False),
    ("meta", False, "grad", False),
])
def test_kernel_route(device, grad, mode, kernel):
    stand_in = pytypes.SimpleNamespace(device=torch.device(device),
                                       requires_grad=grad)
    ctx = {"grad": contextlib.nullcontext(), "no_grad": torch.no_grad(),
           "inference": torch.inference_mode()}[mode]
    with ctx:
        assert voxelize.kernel_route(stand_in) is kernel


class _StubLibrary:
    """Records the C entry's arguments and returns success."""

    def __init__(self):
        self.calls = []

    def dlpd_separable_splat(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(voxelize._build, "library", lambda: lib)
    monkeypatch.setattr(voxelize._build, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(voxelize, "kernel_route", lambda c: True)
    return lib


def test_kernel_launch_arguments(stub):
    coords, types, mask = _ligand(5, bucket=16)
    B, n = 6, coords.shape[0]
    cb = _rotated(coords, B, 0).reshape(2, 3, n, 3)
    l0, p0 = voxelize.launches, voxelize.plain_calls
    out = voxelize.separable_splat(cb, types[None, None], mask,
                                   grid_size=72, resolution=1.25,
                                   sigma=1.0, num_types=11, atom_chunk=8)
    assert (voxelize.launches, voxelize.plain_calls) == (l0 + 1, p0)
    (args,) = stub.calls
    assert args[5:15] == (B, n, 72, 11, B, B, 24, 24, 24, n)
    f = np.float32
    assert args[15:19] == (float(f(-45.0)), float(f(1) / f(1.25)), 1.25,
                           0.5)
    plain = voxelize._contract(cb.reshape(B, n, 3), types.clamp(0).long(),
                               mask, 72, 11, 1.25, 1.0,
                               torch.full((3,), -45.0))
    assert out.shape == (2, 3, 72, 72, 72, 11)
    assert out.reshape(plain.shape).stride() == plain.stride()


def test_kernel_refuses_what_it_does_not_take(stub):
    coords, types, mask = _ligand(3, bucket=16)
    with pytest.raises(TypeError, match="float32"):
        voxelize.separable_splat(coords.double(), types, mask)
    with pytest.raises(ValueError, match="atom types"):
        voxelize.separable_splat(coords, types, mask, num_types=17)
    with pytest.raises(ValueError, match="atom sets"):
        voxelize.separable_splat(coords.expand(65536, -1, -1), types, mask)
    assert not stub.calls
