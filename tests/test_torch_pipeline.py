"""Torch port vs JAX package: the whole docking slice.

Shape mode reproduces the committed golden snapshot
(``tests/golden_sweep_resplat.json``, config of ``tests/test_golden.py``);
learned mode (v9p weights, rank-3 coupling folded into the last conv)
matches JAX ``DockingPipeline.dock`` on a small grid, with and without
clustering.  Top-K values compare as multisets and poses as
(rot_idx, shift) pairs per distinct score, since tied scores may come
out in either order.
"""
import json
import os

import numpy as np
import pytest

from torch_parity import (ROOT, jax_config, np_, t_, v9p_config, v9p_flat,
                          v9p_flax_params)

from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.fft import (
    receptor_transform, shift_to_flat_index)
from deeplocalproteindocking_torch.data import (structure_to_device,
                                                synthetic_complex)
from deeplocalproteindocking_torch.pipeline import (DockingPipeline,
                                                    dock_score_mask)
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.resplat import (
    auto_ligand_grid, dock_sweep_resplat)
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.sweep import resplat as jres


def _pose_groups(scores, rot_idx, shifts, decimals):
    """{rounded score: sorted list of (rot, shift)} for tie-aware checks."""
    out = {}
    for s, r, sh in zip(np.round(np.asarray(scores, np.float64), decimals),
                        rot_idx, shifts):
        out.setdefault(float(s), []).append((int(r), tuple(int(v)
                                                           for v in sh)))
    return {k: sorted(v) for k, v in out.items()}


def test_golden_shape_mode():
    cfg = DockConfig(grid_size=32, resolution=1.5, num_rotations=12,
                     rotation_chunk=4, top_k=8, rep_features=(8,),
                     sweep_mode="resplat")
    cplx = synthetic_complex(seed=42, n_res_rec=10, n_res_lig=5)
    poses = DockingPipeline(cfg, device="cpu").dock_complex(
        cplx, rotations=super_fibonacci_rotations(12), cluster=False)
    with open(os.path.join(ROOT, "tests", "golden_sweep_resplat.json")) as f:
        want = json.load(f)
    np.testing.assert_allclose(poses.scores, want["scores"], rtol=1e-3,
                               atol=2e-3)
    assert (_pose_groups(poses.scores, poses.rot_idx, poses.shifts, 0)
            == _pose_groups(want["scores"], want["rot_idx"],
                            want["shifts"], 0))


def _learned_cfg(**kw):
    return v9p_config().replace(
        grid_size=32, num_rotations=14, rotation_chunk=4, top_k=8,
        coupling_rank=3, lig_grid_size=None, **kw)


@pytest.fixture(scope="module")
def learned_pair():
    cfg = _learned_cfg()
    port = DockingPipeline(cfg, params=weights.params_from_numpy(v9p_flat()),
                           device="cpu")
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    ref.params = v9p_flax_params()
    cplx = jbench.synthetic_complex(seed=5, n_res_rec=20, n_res_lig=8,
                                    unbound_rmsd=1.0)
    return port, ref, cplx


@pytest.mark.parametrize("cluster", [False, True])
def test_learned_v9p_rank3_matches_jax(learned_pair, cluster):
    port, ref, cplx = learned_pair
    got = port.dock_complex(cplx, cluster=cluster)
    want = ref.dock_complex(cplx, cluster=cluster)
    assert len(got) == len(want) > 0
    assert np.all(np.isfinite(got.scores))
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                               atol=1e-3)
    assert (_pose_groups(got.scores, got.rot_idx, got.shifts, 2)
            == _pose_groups(want.scores, want.rot_idx, want.shifts, 2))
    np.testing.assert_allclose(got.rotations, want.rotations, atol=1e-6)
    np.testing.assert_array_equal(got.translations, want.translations)


def test_engine_reuse_and_fused_topk_tail(learned_pair):
    """One receptor half serves several ligand queries (the serving
    pattern), and the fused K1 -> K2 -> drill tail, forced on CPU
    tensors through the plain versions, gives the score-volume path's
    top-K."""
    port, _, cplx = learned_pair
    cfg = port.config
    prep = port._prepare(cplx.receptor, cplx.ligand)
    rec_c, lig_c, rep_rec, _, coupling = prep
    engine = port._engine_parts(rep_rec, coupling)
    a = port.dock(cplx.receptor, cplx.ligand, cluster=False)
    b = port.dock(cplx.receptor, cplx.ligand, cluster=False, prep=prep,
                  engine=engine)
    np.testing.assert_array_equal(a.scores, b.scores)
    impl, H, rep_fn = engine
    lc, lt, lm = structure_to_device(lig_c, bucket=cfg.atom_bucket)
    lig_grid = auto_ligand_grid(lig_c.typed().coords, cfg.resolution,
                                cfg.sigma, port._receptive_field(),
                                cfg.grid_size)
    mask = dock_score_mask(cfg, lig_c, max_shift=6.0,
                           translation_center=np.array([2, -1, 0]),
                           device="cpu")
    kw = dict(grid_size=cfg.grid_size, lig_grid=lig_grid,
              resolution=cfg.resolution, sigma=cfg.sigma, num_types=11,
              top_k=cfg.top_k, chunk=4, score_mask=mask,
              fft_impl="dft_fused")
    rots = super_fibonacci_rotations(10)
    plain = dock_sweep_resplat(H, lc, lt, lm, rots, rep_fn,
                               fused_topk=False, **kw)
    fused = dock_sweep_resplat(H, lc, lt, lm, rots, rep_fn,
                               fused_topk=True, **kw)
    np.testing.assert_allclose(np_(fused.scores), np_(plain.scores),
                               rtol=1e-5, atol=1e-3)
    assert (_pose_groups(np_(fused.scores), np_(fused.rot_idx),
                         np_(fused.shifts), 2)
            == _pose_groups(np_(plain.scores), np_(plain.rot_idx),
                            np_(plain.shifts), 2))
    assert np.all(np.isfinite(np_(fused.scores)))
    dft = dock_sweep_resplat(H, lc, lt, lm, rots, rep_fn, fused_topk=False,
                             **{**kw, "fft_impl": "dft"})
    np.testing.assert_allclose(np_(dft.scores), np_(plain.scores),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fft_impl", ["dft", "dft_pallas", "xla"])
def test_sweep_engines_match_jax(fft_impl):
    """Sweeps on the non-fused engines equal the JAX sweep on the same
    inputs (num_valid masks the identity padding)."""
    rng = np.random.default_rng(13)
    L, Ls, C = 16, 8, 2
    rec = rng.normal(size=(L, L, L, C)).astype(np.float32)
    coords = (rng.normal(size=(6, 3)) * 2.0).astype(np.float32)
    types = rng.integers(0, 11, size=6).astype(np.int32)
    mask = np.ones(6, np.float32)
    w = rng.normal(size=(11, C)).astype(np.float32)
    import jax.numpy as jnp
    from deeplocalproteindocking_tpu.correlate.fft import (
        receptor_transform as j_rt)
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations as j_sf)
    kw = dict(grid_size=L, lig_grid=Ls, resolution=1.5, sigma=1.0,
              num_types=11, top_k=8, chunk=4, fft_impl=fft_impl)
    want = jres.dock_sweep_resplat(
        j_rt(jnp.asarray(rec)), jnp.asarray(coords), jnp.asarray(types),
        jnp.asarray(mask), j_sf(7), lambda v: v @ jnp.asarray(w), **kw)
    got = dock_sweep_resplat(
        receptor_transform(t_(rec)), t_(coords), t_(types), t_(mask),
        super_fibonacci_rotations(7), lambda v: v @ t_(w), **kw)
    np.testing.assert_allclose(np_(got.scores), np_(want.scores),
                               rtol=1e-4, atol=1e-4)
    assert (_pose_groups(np_(got.scores), np_(got.rot_idx),
                         np_(got.shifts), 3)
            == _pose_groups(np_(want.scores), np_(want.rot_idx),
                            np_(want.shifts), 3))
    assert np_(got.rot_idx).max() < 7


def _sweep_inputs(L=32, Ls=16, C=2, seed=17):
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(L, L, L, C)).astype(np.float32)
    coords = (rng.normal(size=(10, 3)) * 2.5).astype(np.float32)
    types = rng.integers(0, 11, size=10).astype(np.int32)
    w = rng.normal(size=(11, C)).astype(np.float32)
    masks = rng.random((3, L, L, L)) < 0.4
    return (receptor_transform(t_(rec)), t_(coords), t_(types),
            t_(np.ones(10, np.float32)), lambda v: v @ t_(w), t_(masks))


@pytest.mark.parametrize("fft_impl", ["dft_fused", "dft_pallas"])
def test_head_batched_sweep_matches_per_head(fft_impl):
    """Heads as a leading batch axis (rescore's form): each head's top-K
    equals its own sweep with its own mask, through the score-volume
    path and, on dft_fused, through the K1 -> K2 -> drill tail with the
    masks as per-head bias groups (forced on CPU tensors)."""
    H, lc, lt, lm, rep_fn, masks = _sweep_inputs()
    n = masks.shape[0]
    rots = super_fibonacci_rotations(5 * n).reshape(n, 5, 3, 3)
    kw = dict(grid_size=32, lig_grid=16, resolution=1.25, sigma=1.0,
              num_types=11, top_k=6, chunk=2, fft_impl=fft_impl)
    tails = [False, True] if fft_impl == "dft_fused" else [False]
    for fused in tails:
        got = dock_sweep_resplat(H, lc, lt, lm, rots, rep_fn,
                                 score_mask=masks, fused_topk=fused, **kw)
        assert got.scores.shape == (n, 6) and got.shifts.shape == (n, 6, 3)
        for i in range(n):
            want = dock_sweep_resplat(H, lc, lt, lm, rots[i], rep_fn,
                                      score_mask=masks[i], fused_topk=False,
                                      **kw)
            np.testing.assert_allclose(np_(got.scores[i]),
                                       np_(want.scores), rtol=1e-5,
                                       atol=1e-4)
            assert (_pose_groups(np_(got.scores[i]), np_(got.rot_idx[i]),
                                 np_(got.shifts[i]), 3)
                    == _pose_groups(np_(want.scores), np_(want.rot_idx),
                                    np_(want.shifts), 3))
            flat = np_(shift_to_flat_index(got.shifts[i], 32))
            assert np_(masks[i]).reshape(-1)[flat].all()


def test_bench_complex_ligand_box_and_masks():
    """The bench complex (seed 0, 60+30 residues): 239 typed ligand atoms
    in a ligand box of Ls = 32, as the JAX package sizes it; the score
    masks agree."""
    cfg = DockConfig(grid_size=128, rep_features=(32, 14),
                     shape_prior=True)
    lig_c = synthetic_complex(0, 60, 30).ligand.centered()
    j_lig = jbench.synthetic_complex(0, 60, 30).ligand.centered()
    assert len(lig_c.typed()) == 239
    ls = auto_ligand_grid(lig_c.typed().coords, 1.25, 1.0, 3, 128)
    assert ls == jres.auto_ligand_grid(j_lig.typed().coords, 1.25, 1.0, 3,
                                       128) == 32
    small = cfg.replace(grid_size=48)
    for kw in ({}, dict(max_shift=7.5, translation_center=[3, -2, 5])):
        got = dock_score_mask(small, lig_c, device="cpu", **kw)
        want = jpipe.dock_score_mask(jax_config(small), j_lig, **kw)
        np.testing.assert_array_equal(np_(got), np_(want))


def test_unported_options_raise():
    """The options that raised before the block engine, the resample
    sweep and approximate top-K were ported now dock as the JAX package
    docks: ``block`` (block 16 at grid 32), ``resample``, and
    ``topk_impl="approx"`` (a warning, then the exact top-K)."""
    cfg = DockConfig(grid_size=32, num_rotations=4, rotation_chunk=4,
                     top_k=6, fft_impl="block", fft_block=16)
    cplx = synthetic_complex(1, 10, 5)
    jcplx = jbench.synthetic_complex(1, 10, 5)
    for c in (cfg, cfg.replace(fft_impl="dft_fused", sweep_mode="resample")):
        got = DockingPipeline(c, device="cpu").dock_complex(cplx,
                                                            cluster=False)
        want = jpipe.DockingPipeline(config=jax_config(c)).dock_complex(
            jcplx, cluster=False)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                   rtol=1e-4, atol=1e-3)
        assert got.rot_idx[0] == want.rot_idx[0]
        np.testing.assert_array_equal(got.shifts[0],
                                      np.asarray(want.shifts)[0])
    approx = cfg.replace(fft_impl="dft_fused", topk_impl="approx")
    with pytest.warns(UserWarning, match="topk_impl='approx'"):
        got = DockingPipeline(approx, device="cpu").dock_complex(
            cplx, cluster=False)
    exact = DockingPipeline(approx.replace(topk_impl="exact"),
                            device="cpu").dock_complex(cplx, cluster=False)
    np.testing.assert_array_equal(got.scores, exact.scores)
    np.testing.assert_array_equal(got.shifts, exact.shifts)
