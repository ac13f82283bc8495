"""Torch port vs JAX package: batched and ensemble docking.

K1 with one receptor spectrum per group of rows (the plain version, held
against per-group calls and against ``jax.vmap`` of the JAX kernel in
interpret mode), ``separable_splat`` with per-row atom sets,
``parallel.batch_eval.dock_batch`` on every engine,
``DockingPipeline.dock_ensemble`` and ``evaluation.run_benchmark_batched``
against their JAX counterparts on the same inputs, at small sizes on the
CPU (kernels through their plain versions).  Top-K scores compare within
1e-4 relative, poses by (rotation, shift).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (jax_config, np_, t_, v9p_config, v9p_flat,
                          v9p_flax_params)

from deeplocalproteindocking_torch import evaluation as tev
from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate import fused as tfused
from deeplocalproteindocking_torch.correlate.dft import get_correlator
from deeplocalproteindocking_torch.correlate.fft import receptor_transform
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.parallel import batch_eval as tbe
from deeplocalproteindocking_torch.pipeline import (DockingPipeline,
                                                    ensemble_pair_batch)
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat
from deeplocalproteindocking_tpu import evaluation as jev
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.correlate import pallas_fused as jfused
from deeplocalproteindocking_tpu.correlate.fft import (
    receptor_transform as j_receptor_transform)
from deeplocalproteindocking_tpu.grids import voxelize as jvox
from deeplocalproteindocking_tpu.parallel import batch_eval as jbe
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations as j_super_fibonacci_rotations)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# ---- K1 with receptor groups ----

def _k1_args(L, Ls, C, b, G, dtype_name, seed):
    """K1's arguments with ``G`` random receptor spectra ``[G, K, C, J,
    I]``."""
    rng = np.random.default_rng(seed)
    K = L // 2 + 1
    corr = get_correlator(L, Ls, dtype_name)
    a = [torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(corr.dtype)
         for s in [(b, K, C, Ls, Ls)] * 2 + [(G, K, C, L, L)] * 2]
    return tuple(a) + (corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm,
                       corr.UxRe, corr.UxIm, corr.UyRe, corr.UyIm)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_k1_groups_equal_per_group_calls(G):
    """Rows [g b/G, (g+1) b/G) against H[g]: the grouped plain version
    equals one call per group, and G = 1 in the 5-D form equals the 4-D
    form."""
    b = 4
    args = _k1_args(16, 8, 2, b, G, "float32", seed=G)
    got = tfused.fused_correlate(*args)
    n = b // G
    for g in range(G):
        rows = slice(g * n, (g + 1) * n)
        want = tfused.fused_correlate(args[0][rows], args[1][rows],
                                      args[2][g], args[3][g], *args[4:])
        for gt, wt in zip(got, want):
            assert torch.equal(gt[rows], wt)


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
def test_k1_groups_match_vmapped_pallas_interpret(dtype_name, tol):
    """The grouped plain version against ``jax.vmap`` of the JAX kernel in
    interpret mode over a batched H (how K1 runs under JAX's
    ``dock_batch``)."""
    G, b = 2, 4
    args = _k1_args(32, 16, 2, b, G, dtype_name, seed=11)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    jargs = [jnp.asarray(np_(a.float())).astype(jdt) for a in args]
    jargs[0] = jargs[0].reshape((G, b // G) + jargs[0].shape[1:])
    jargs[1] = jargs[1].reshape(jargs[0].shape)
    want = jax.vmap(
        lambda are, aim, hre, him: jfused.fused_correlate(
            are, aim, hre, him, *jargs[4:], interpret=True))(*jargs[:4])
    got = tfused.fused_correlate(*args)
    for g, w in zip(got, want):
        assert _rel(g, t_(w).reshape(g.shape)) <= tol


def test_k1_wrapper_rejects_bad_groups():
    args = _k1_args(16, 8, 2, 4, 3, "float32", seed=0)
    with pytest.raises(ValueError, match="do not divide"):
        tfused.fused_correlate(*args)
    bad = args[2][None]                               # rank 6
    with pytest.raises(ValueError, match=r"\[G, K, C, J, I\]"):
        tfused.fused_correlate(args[0], args[1], bad, bad, *args[4:])
    with pytest.raises(ValueError, match=r"\[G, K, C, J, I\]"):
        tfused.fused_correlate(args[0], args[1], args[2][0, 0],
                               args[3][0, 0], *args[4:])


# ---- separable_splat with per-row atom sets ----

@pytest.mark.parametrize("atom_chunk", [None, 5])
def test_splat_per_row_types_matches_vmap(atom_chunk):
    rng = np.random.default_rng(4)
    B, n, L, T = 3, 12, 16, 4
    coords = rng.uniform(-6, 6, (B, n, 3)).astype(np.float32)
    types = rng.integers(-1, T, (B, n)).astype(np.int32)
    mask = (rng.random((B, n)) < 0.8).astype(np.float32)
    kw = dict(grid_size=L, resolution=1.0, sigma=1.0, num_types=T)
    want = jax.vmap(lambda c, t, m: jvox.separable_splat(c, t, m, **kw))(
        jnp.asarray(coords), jnp.asarray(types), jnp.asarray(mask))
    got = separable_splat(t_(coords), t_(types), t_(mask),
                          atom_chunk=atom_chunk, **kw)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-6)
    # Atom sets broadcast over leading axes (a batched sweep's rotated
    # copies of each complex's ligand).
    rows = separable_splat(t_(coords)[:, None].expand(B, 2, n, 3),
                           t_(types)[:, None], t_(mask)[:, None],
                           atom_chunk=atom_chunk, **kw)
    for r in range(2):
        np.testing.assert_allclose(np_(rows[:, r]), np_(got), rtol=1e-6,
                                   atol=1e-6)


# ---- dock_batch ----

def _batch_fixture(B=4, L=16, C=3, seed=0):
    """The JAX package's ``TestBatchEval._setup`` (tests/test_parallel.py):
    B receptors splatted from 8 random atoms, ligands the same atoms."""
    rng = np.random.default_rng(seed)
    H, lc, lt = [], [], []
    for _ in range(B):
        coords = rng.uniform(-2.5, 2.5, (8, 3)).astype(np.float32)
        types = rng.integers(0, C, 8).astype(np.int32)
        rec = jvox.separable_splat(jnp.asarray(coords) + 1.0,
                                   jnp.asarray(types), jnp.ones(8),
                                   grid_size=L, resolution=1.0, num_types=C)
        H.append(np.asarray(rec))
        lc.append(coords)
        lt.append(types)
    return (np.stack(H), np.stack(lc), np.stack(lt),
            np.ones((B, 8), np.float32))


def _batch_masks(B, L, seed=5):
    return np.random.default_rng(seed).random((B, L, L, L)) < 0.5


@pytest.mark.parametrize("fft_impl,L,masked", [
    ("dft", 16, False), ("dft", 16, True), ("dft_pallas", 16, True),
    ("xla", 16, False), ("xla", 16, True), ("dft_fused", 32, False),
    ("dft_fused", 32, True)])
def test_dock_batch_matches_jax(fft_impl, L, masked):
    """``dock_batch`` against JAX ``dock_batch(None, ...)`` (the vmapped
    sweep); on ``dft_fused`` the fused tail is forced, so K1 runs with 4
    receptor groups and K2 / ``drill_topk`` with 4 bias groups through
    their plain versions.  Each row also equals the port's own sweep of
    that complex alone."""
    rec, lc, lt, lm = _batch_fixture(L=L)
    B = rec.shape[0]
    sm = _batch_masks(B, L) if masked else None
    kw = dict(grid_size=L, lig_grid=12, resolution=1.0, sigma=1.0,
              num_types=3, top_k=4, chunk=2, fft_impl=fft_impl)
    want = jbe.dock_batch(
        None, jax.vmap(j_receptor_transform)(jnp.asarray(rec)),
        jnp.asarray(lc), jnp.asarray(lt), jnp.asarray(lm),
        j_super_fibonacci_rotations(6), lambda v: v,
        score_mask=None if sm is None else jnp.asarray(sm), **kw)
    H = receptor_transform(t_(rec))
    fused = fft_impl == "dft_fused" or None
    got = tbe.dock_batch(H, t_(lc), t_(lt), t_(lm),
                         super_fibonacci_rotations(6), lambda v: v,
                         score_mask=None if sm is None else t_(sm),
                         fused_topk=fused, **kw)
    assert got.scores.shape == (B, 4) and got.shifts.shape == (B, 4, 3)
    np.testing.assert_allclose(np_(got.scores), np_(want.scores), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(np_(got.rot_idx), np_(want.rot_idx))
    np.testing.assert_array_equal(np_(got.shifts), np_(want.shifts))
    for b in range(B):
        one = dock_sweep_resplat(
            H[b], t_(lc[b]), t_(lt[b]), t_(lm[b]),
            super_fibonacci_rotations(6), lambda v: v,
            score_mask=None if sm is None else t_(sm[b]), fused_topk=fused,
            **kw)
        np.testing.assert_allclose(np_(got.scores[b]), np_(one.scores),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np_(got.rot_idx[b]),
                                      np_(one.rot_idx))
        np.testing.assert_array_equal(np_(got.shifts[b]), np_(one.shifts))


def test_dock_batch_rejects_unbatched_inputs():
    rec, lc, lt, lm = _batch_fixture(B=2)
    H = receptor_transform(t_(rec))
    kw = dict(grid_size=16, lig_grid=12, resolution=1.0, sigma=1.0,
              num_types=3)
    rots = super_fibonacci_rotations(4)
    with pytest.raises(ValueError, match="H_batch"):
        tbe.dock_batch(H[0], t_(lc), t_(lt), t_(lm), rots, lambda v: v,
                       **kw)
    with pytest.raises(ValueError, match="2 receptor spectra for 1"):
        dock_sweep_resplat(H, t_(lc[:1]), t_(lt[:1]), t_(lm[:1]), rots,
                           lambda v: v, **kw)


# ---- dock_ensemble ----

def _ens_cfg(**kw):
    base = dict(grid_size=32, resolution=1.5, rep_features=(4,),
                num_rotations=6, rotation_chunk=4, top_k=8, nms_rmsd=3.0)
    base.update(kw)
    return DockConfig(**base)


def _jiggle(s, rng, scale=0.3):
    import dataclasses
    return dataclasses.replace(
        s, coords=(s.coords + rng.normal(0, scale, s.coords.shape)
                   ).astype(np.float32))


@pytest.fixture(scope="module")
def ensemble_models():
    c = synthetic_complex(seed=6, n_res_rec=6, n_res_lig=3)
    rng = np.random.default_rng(1)
    return ([c.receptor, _jiggle(c.receptor, rng)],
            [c.ligand, _jiggle(c.ligand, rng)])


@pytest.fixture(scope="module")
def v9p_ensemble_pipes():
    """The v9p model, rank-3 coupling folded into the last conv, on the
    ``dft_fused`` engine at grid 32 (continuous scores: no ties between
    pairs), in both packages."""
    cfg = v9p_config().replace(grid_size=32, num_rotations=6,
                               rotation_chunk=4, top_k=8, coupling_rank=3,
                               lig_grid_size=None, nms_rmsd=3.0)
    port = DockingPipeline(cfg, params=weights.params_from_numpy(v9p_flat()),
                           device="cpu")
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    ref.params = v9p_flax_params()
    return port, ref


@pytest.mark.parametrize("pairing,cluster", [("product", False),
                                             ("product", True),
                                             ("zip", True)])
def test_dock_ensemble_matches_jax(ensemble_models, v9p_ensemble_pipes,
                                   pairing, cluster):
    """2 x 2 ``"product"`` and 2 ``"zip"`` (K1 with one receptor group
    per pair): merged scores, the (receptor_model, ligand_model) tags,
    and after NMS the same survivors."""
    recs, ligs = ensemble_models
    port, ref = v9p_ensemble_pipes
    cfg = port.config
    got, gpairs = port.dock_ensemble(recs, ligs, pairing=pairing,
                                     cluster=cluster)
    want, wpairs = ref.dock_ensemble(recs, ligs, pairing=pairing,
                                     cluster=cluster)
    assert len(got) == len(want) == len(gpairs) > 0
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(gpairs, wpairs)
    np.testing.assert_array_equal(got.rot_idx, want.rot_idx)
    np.testing.assert_array_equal(got.shifts, want.shifts)
    if not cluster:
        assert len(got) == cfg.top_k * (4 if pairing == "product" else 2)


def test_dock_ensemble_preps_r_plus_l_and_scales_the_chunk(
        ensemble_models, monkeypatch):
    """R receptor halves are voxelized (not R x L); the 4 pairs sweep as
    one batch whose rotation chunk is ``rotation_chunk // 4``."""
    recs, ligs = ensemble_models
    pipe = DockingPipeline(_ens_cfg(rotation_chunk=2, fft_impl="dft"),
                           device="cpu")
    calls, chunks = [], []
    voxelize = pipe.voxelize

    def counted(*a, **k):
        calls.append(1)
        return voxelize(*a, **k)

    monkeypatch.setattr(pipe, "voxelize", counted)
    dock_batch = tbe.dock_batch

    def spy(H, *a, **k):
        chunks.append((H.shape[0], k["chunk"]))
        return dock_batch(H, *a, **k)

    monkeypatch.setattr(tbe, "dock_batch", spy)
    pipe.dock_ensemble(recs, ligs + ligs[:1])
    assert len(calls) == len(recs)
    assert chunks == [(6, 1)]
    pipe.dock_ensemble(recs, ligs, pair_batch=3)
    assert chunks[1:] == [(3, 1), (1, 2)]


def test_ensemble_pair_batch_and_pairing_errors(ensemble_models):
    """The budget rule on the JAX test's spectra (128^3 and 256^3 at 16
    channels, 32^3 at 2), and pairing validation."""
    def H(shape):
        return torch.empty(shape, dtype=torch.complex64, device="meta")
    assert 1 <= ensemble_pair_batch(H((128, 128, 65, 16))) <= 8
    assert ensemble_pair_batch(H((32, 32, 17, 2))) == 32
    assert ensemble_pair_batch(H((256, 256, 129, 16))) == 1
    recs, ligs = ensemble_models
    pipe = DockingPipeline(_ens_cfg(), device="cpu")
    with pytest.raises(ValueError, match="zip"):
        pipe.dock_ensemble(recs[:1], ligs, pairing="zip")
    with pytest.raises(ValueError, match="unknown pairing"):
        pipe.dock_ensemble(recs, ligs, pairing="outer")
    with pytest.raises(NotImplementedError):
        DockingPipeline(_ens_cfg(sweep_mode="resample"),
                        device="cpu").dock_ensemble(recs, ligs)


# ---- run_benchmark_batched ----

def _bench_cfg(**kw):
    base = dict(grid_size=32, resolution=1.25, num_rotations=8,
                rotation_chunk=8, top_k=8, nms_rmsd=3.0, rep_features=(8, 8))
    base.update(kw)
    return DockConfig(**base)


def _read(d, name):
    with open(d / f"{name}.json") as f:
        return json.load(f)


def _assert_results_equal(got, want, score_rtol=1e-4):
    assert got["hit_top1"] == want["hit_top1"]
    assert got["hit_top10"] == want["hit_top10"]
    assert got["num_poses"] == want["num_poses"] > 0
    for a, b in zip(got["poses"], want["poses"]):
        assert a["score"] == pytest.approx(b["score"], rel=score_rtol,
                                           abs=1e-6)
        assert abs(a["lrmsd"] - b["lrmsd"]) < 1e-3
        assert a["capri"] == b["capri"]


def test_run_benchmark_batched_matches_jax(tmp_path, monkeypatch):
    """Three complexes in groups of 2 (a full and a partial group), shape
    mode on ``dft_fused``: the graded pose lists and hit decisions equal
    JAX's; a second call recomputes nothing."""
    cfg = _bench_cfg()
    cplxs = [synthetic_complex(seed=s, n_res_rec=8, n_res_lig=4)
             for s in (30, 31, 32)]
    pipe = DockingPipeline(cfg, device="cpu")
    s_got = tev.run_benchmark_batched(pipe, cplxs, str(tmp_path / "t"),
                                      group_size=2)
    s_want = jev.run_benchmark_batched(
        jpipe.DockingPipeline(config=jax_config(cfg)), cplxs,
        str(tmp_path / "j"), group_size=2)
    assert s_got == s_want
    for c in cplxs:
        _assert_results_equal(_read(tmp_path / "t", c.name),
                              _read(tmp_path / "j", c.name))

    def no_dock(*a, **k):
        raise AssertionError("a finished complex was recomputed")

    monkeypatch.setattr(tbe, "dock_batch", no_dock)
    assert tev.run_benchmark_batched(pipe, cplxs, str(tmp_path / "t"),
                                     group_size=2) == s_got


def test_run_benchmark_batched_prep_is_batched_and_bucketed(tmp_path,
                                                            monkeypatch):
    """No host ``voxelize``; size-diverse groups share one shape bucket
    (padded atoms, ligand box)."""
    cfg = _bench_cfg(top_k=4, fft_impl="dft")
    pipe = DockingPipeline(cfg, device="cpu")
    cplxs = [synthetic_complex(seed=s, n_res_rec=6 + s % 3,
                               n_res_lig=3 + s % 2) for s in (40, 41, 42, 43)]
    host = []
    monkeypatch.setattr(pipe, "voxelize", lambda *a, **k: host.append(1))
    shapes = []
    dock_batch = tbe.dock_batch

    def spy(H, lc, *a, **k):
        shapes.append((H.shape[0], int(lc.shape[1]), k["lig_grid"],
                       k["chunk"]))
        return dock_batch(H, lc, *a, **k)

    monkeypatch.setattr(tbe, "dock_batch", spy)
    tev.run_benchmark_batched(pipe, cplxs, str(tmp_path / "b"), group_size=2)
    assert not host, "prep must not voxelize on the host"
    assert len(shapes) == 2 and len(set(shapes)) == 1, shapes
    assert shapes[0][0] == 2 and shapes[0][3] == cfg.rotation_chunk // 2


def test_run_benchmark_batched_rescore_matches_sequential(tmp_path):
    """``rescore_top=4``: the batched runner's poses equal the port's
    sequential ``run_benchmark``'s."""
    cfg = _bench_cfg(num_rotations=16, atom_bucket=64, fft_impl="dft")
    cplxs = [synthetic_complex(seed=s, n_res_rec=8, n_res_lig=4)
             for s in range(2)]
    pipe = DockingPipeline(cfg, device="cpu")
    s_seq = tev.run_benchmark(pipe, cplxs, str(tmp_path / "s"),
                              rescore_top=4)
    s_bat = tev.run_benchmark_batched(pipe, cplxs, str(tmp_path / "b"),
                                      group_size=2, rescore_top=4)
    assert s_seq == s_bat
    for c in cplxs:
        a, b = _read(tmp_path / "s", c.name), _read(tmp_path / "b", c.name)
        np.testing.assert_allclose([p["score"] for p in b["poses"]],
                                   [p["score"] for p in a["poses"]],
                                   rtol=2e-5)


def test_run_benchmark_batched_masks_wrapped_poses(tmp_path):
    """A ligand large for its box: the batched runner applies the
    wrap-around guard as the sequential one does (same poses), and no
    raw pose sits beyond the wrap cap."""
    cplx = synthetic_complex(seed=7, n_res_rec=12, n_res_lig=8)
    cfg = _bench_cfg(grid_size=24, resolution=1.5, top_k=16,
                     rep_features=(4,), fft_impl="dft")
    pipe = DockingPipeline(cfg, device="cpu")
    lig_c = cplx.ligand.centered()
    half = int(np.ceil((np.abs(lig_c.typed().coords).max() + 3.0 * cfg.sigma)
                       / cfg.resolution))
    wrap_cap = cfg.grid_size // 2 - half
    assert wrap_cap < cfg.grid_size // 2, "fixture must engage the guard"
    tev.run_benchmark_batched(pipe, [cplx], str(tmp_path / "b"),
                              group_size=1)
    tev.run_benchmark(pipe, [cplx], str(tmp_path / "s"))
    _assert_results_equal(_read(tmp_path / "b", cplx.name),
                          _read(tmp_path / "s", cplx.name), score_rtol=1e-5)
    raw = pipe.dock_complex(cplx, cluster=False)
    assert np.abs(raw.shifts).max() <= wrap_cap
