"""Torch port vs JAX package: the two-stage protocol and the service.

``DockingPipeline.rescore`` (head-batched cone sweeps), the continuous
score and its gradient, ``refine_poses`` and ``DockingPipeline.refine``
run on the v9p model (rank-3 folded coupling, grid 32) against the JAX
package on the same inputs; ``DockingService`` is held to its JAX
counterpart's cache semantics (``tests/test_serving.py``).

Tolerances: scores rtol 1e-4 (float32, summation order); gradients
1e-3 of their largest component (backward sums in another order);
refined poses 1e-4 (Adam normalizes each step, so gradient rounding
moves a pose by far less than one step of ``lr``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (jax_config, np_, t_, v9p_config, v9p_flat,
                          v9p_flax_params)

from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate import dft as tdft
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.pipeline import DockingPipeline, PoseSet
from deeplocalproteindocking_torch.serving import DockingService
from deeplocalproteindocking_torch.sweep import refine as trefine
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.sweep import refine as jrefine
from deeplocalproteindocking_tpu.sweep import resplat as jres


@pytest.fixture(scope="module")
def pair():
    """Port and JAX pipelines on the v9p model at grid 32, one complex,
    and the JAX coarse poses (unclustered, so rescore has a tail)."""
    cfg = v9p_config().replace(
        grid_size=32, num_rotations=14, rotation_chunk=4, top_k=8,
        coupling_rank=3, lig_grid_size=None)
    port = DockingPipeline(cfg, params=weights.params_from_numpy(v9p_flat()),
                           device="cpu")
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    ref.params = v9p_flax_params()
    cplx = jbench.synthetic_complex(seed=5, n_res_rec=20, n_res_lig=8,
                                    unbound_rmsd=1.0)
    poses = ref.dock_complex(cplx, cluster=False)
    poses = PoseSet(*(np.asarray(f) for f in poses[:5]))
    return port, ref, cplx, poses


def _port_engine(port, cplx):
    """The port's (H, ligand inputs, rep_fn) and the sweep geometry."""
    cfg = port.config
    _, eng, tl, lig_grid = port._stage_inputs(cplx.receptor, cplx.ligand,
                                              None, None)
    kw = dict(grid_size=cfg.grid_size, lig_grid=lig_grid,
              resolution=cfg.resolution, sigma=cfg.sigma, num_types=11)
    return (eng[1], tl, eng[2]), kw


def _engines(port, ref, cplx):
    """Both packages' engine tuples and ligand inputs for one complex."""
    cfg = port.config
    rec_c, lig_c, rep_rec, _, cpl = ref._prepare(cplx.receptor, cplx.ligand)
    j_impl, jH, j_rep = ref._engine_parts(rep_rec, cpl)
    jl = jbench.structure_to_device(lig_c, bucket=cfg.atom_bucket)
    tparts, kw = _port_engine(port, cplx)
    assert kw["lig_grid"] == jres.auto_ligand_grid(
        lig_c.typed().coords, cfg.resolution, cfg.sigma,
        ref._receptive_field(), cfg.grid_size)
    return (jH, jl, j_rep), tparts, kw


def _canon(p: PoseSet):
    """Poses in a tie-proof order: by ranking statistic (rounded), then
    shift; returns (rank, scores, shifts, rotations)."""
    rank = p.scores if p.rank_scores is None else p.rank_scores
    shifts = np.asarray(p.shifts)
    order = np.lexsort((shifts[:, 2], shifts[:, 1], shifts[:, 0],
                        -np.round(rank, 2)))
    return (np.asarray(rank)[order], np.asarray(p.scores)[order],
            shifts[order], np.asarray(p.rotations)[order])


@pytest.mark.parametrize("aggregate", ["max", "topmean"])
def test_rescore_matches_jax(pair, aggregate):
    port, ref, cplx, poses = pair
    kw = dict(top=3, nrot=8, aggregate=aggregate, agg_top=3)
    want = ref.rescore(cplx.receptor, cplx.ligand, poses, **kw)
    got = port.rescore(cplx.receptor, cplx.ligand, poses, **kw)
    assert len(got) == len(want) == len(poses)
    np.testing.assert_array_equal(np.sort(got.rot_idx),
                                  np.sort(want.rot_idx))
    for g, w in zip(_canon(got), _canon(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # Each head's cone holds the head itself, so it cannot get worse.
    heads = got.rot_idx == -1
    assert heads.sum() == 3
    assert np.all(got.scores[heads][:, None]
                  >= poses.scores[:3][None, :].min() - 1e-3)


def test_continuous_score_value_and_grad(pair):
    port, ref, cplx, poses = pair
    (jH, jl, j_rep), (tH, tl, t_rep), kw = _engines(port, ref, cplx)
    R = np.asarray(poses.rotations[1], np.float32)
    t = (poses.shifts[1] + np.array([0.3, -0.2, 0.45])).astype(np.float32)

    def jscore(R, t):
        return jrefine.continuous_score(jH, *jl, R, t, j_rep, **kw)

    want, (wR, wt) = jax.value_and_grad(jscore, argnums=(0, 1))(
        jnp.asarray(R), jnp.asarray(t))
    Rt = t_(R).requires_grad_(True)
    tt = t_(t).requires_grad_(True)
    got = trefine.continuous_score(tH, *tl, Rt[None], tt[None], t_rep,
                                   **kw)[0]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for g, w in ((Rt.grad, wR), (tt.grad, wt)):
        w = np_(w)
        np.testing.assert_allclose(np_(g), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())
    # Lattice poses: the continuous score is the sweep's score.
    s0 = trefine.continuous_score(
        tH, *tl, t_(poses.rotations[:1]), t_(poses.shifts[:1],
                                             torch.float32), t_rep, **kw)
    np.testing.assert_allclose(np_(s0), poses.scores[:1], rtol=1e-4)


def test_refine_poses_match_jax(pair):
    port, ref, cplx, poses = pair
    (jH, jl, j_rep), (tH, tl, t_rep), kw = _engines(port, ref, cplx)
    R, sh = poses.rotations[:3], poses.shifts[:3]
    want = jrefine.refine_poses(jH, *jl, jnp.asarray(R), jnp.asarray(sh),
                                j_rep, steps=5, **kw)
    got = trefine.refine_poses(tH, *tl, t_(R), t_(sh), t_rep, steps=5,
                               **kw)
    for name in ("initial_scores", "scores"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), rtol=1e-4)
    np.testing.assert_allclose(np_(got.translations),
                               np_(want.translations), atol=1e-4)
    np.testing.assert_allclose(np_(got.rotations), np_(want.rotations),
                               atol=1e-4)
    assert np.all(np_(got.scores) >= np_(got.initial_scores))
    with pytest.raises(NotImplementedError):
        trefine.refine_poses(tH, *tl, t_(R), t_(sh), t_rep, steps=1,
                             fft_impl="block", **kw)


def test_pipeline_refine_ranks_refine_poses(pair):
    """``DockingPipeline.refine`` is ``refine_poses`` on the engine's
    complex H, re-ranked, with shifts at the nearest lattice point."""
    port, _, cplx, poses = pair
    (tH, tl, t_rep), kw = _port_engine(port, cplx)
    sub = PoseSet(*(f[:3] for f in poses[:5]))
    got = port.refine(cplx.receptor, cplx.ligand, sub, steps=3)
    raw = trefine.refine_poses(tH, *tl, t_(sub.rotations), t_(sub.shifts),
                               t_rep, steps=3, **kw)
    order = np.argsort(-np_(raw.scores))
    np.testing.assert_array_equal(got.scores, np_(raw.scores)[order])
    np.testing.assert_array_equal(got.rot_idx, sub.rot_idx[order])
    np.testing.assert_array_equal(got.translations,
                                  np_(raw.translations)[order])
    np.testing.assert_array_equal(
        got.shifts, np.round(got.translations / port.config.resolution))


def test_refine_reuses_docked_engine(pair):
    """The engine ``dock`` built (and memoized), and the one the service
    caches, serve ``refine``: none of their tensors is an inference
    tensor, so backward can save them."""
    port, _, cplx, _ = pair
    poses = port.dock_complex(cplx)
    out = port.refine(cplx.receptor, cplx.ligand,
                      PoseSet(*(f[:2] for f in poses[:5])), steps=2)
    assert np.all(np.isfinite(out.scores))
    svc = DockingService(port.config, port.params, device="cpu")
    poses = svc.dock(cplx.receptor, cplx.ligand)
    prep, engine = svc.cached(cplx.receptor, cplx.ligand)
    assert not any(t.is_inference() for t in (engine[1], prep[2]))
    out = svc.pipeline.refine(cplx.receptor, cplx.ligand,
                              PoseSet(*(f[:2] for f in poses[:5])),
                              steps=2, prep=prep, engine=engine)
    assert np.all(out.scores >= poses.scores[:2].min() - 1e-3)


def test_correlator_cache_outlives_inference_mode():
    """A correlator first asked for inside a sweep's inference_mode is
    cached as normal tensors, which refine can save for backward."""
    with torch.inference_mode():
        corr = tdft.get_correlator(24, 8, "float32")
    assert not any(t.is_inference() for t in (corr.WxRe, corr.WzIm,
                                              corr.MzRe, corr.UxRe32))


# ---- DockingService (the analogues of tests/test_serving.py) ----

def _cfg(**kw):
    base = dict(grid_size=32, resolution=1.25, num_rotations=8,
                rotation_chunk=4, top_k=8, rep_features=(8,))
    base.update(kw)
    return DockConfig(**base)


def test_service_parity_with_pipeline():
    cplx = synthetic_complex(seed=8, n_res_rec=8, n_res_lig=4)
    for impl in ("dft_fused", "dft_pallas"):
        cfg = _cfg(fft_impl=impl)
        a = DockingService(cfg, device="cpu").dock(
            cplx.receptor, cplx.ligand, cluster=False)
        b = DockingPipeline(cfg, device="cpu").dock_complex(cplx,
                                                           cluster=False)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5)
        np.testing.assert_array_equal(a.rot_idx, b.rot_idx)


def test_service_receptor_cache_hits():
    c1 = synthetic_complex(seed=8, n_res_rec=8, n_res_lig=4)
    c2 = synthetic_complex(seed=9, n_res_rec=8, n_res_lig=4)
    svc = DockingService(_cfg(), device="cpu")
    svc.dock(c1.receptor, c1.ligand, cluster=False)
    svc.dock(c1.receptor, c2.ligand, cluster=False)     # same receptor
    assert svc.stats == dict(entries=1, hits=1, misses=1)
    svc.dock(c2.receptor, c2.ligand, cluster=False)     # new receptor
    assert svc.stats == dict(entries=2, hits=1, misses=2)


def test_service_key_sensitivity():
    """The key changes with structure, geometry and parameters."""
    c = synthetic_complex(seed=8, n_res_rec=8, n_res_lig=4)
    svc = DockingService(_cfg(), device="cpu")
    k0 = svc.receptor_key(c.receptor)
    assert DockingService(_cfg(), device="cpu").receptor_key(
        c.receptor) == k0
    moved = dataclasses.replace(c.receptor, coords=c.receptor.coords + 0.5)
    assert svc.receptor_key(moved) != k0
    assert DockingService(_cfg(resolution=1.5), device="cpu").receptor_key(
        c.receptor) != k0
    learned = DockingService(_cfg(rep_features=(8, 8)), device="cpu")
    learned.pipeline.init_params(torch.Generator().manual_seed(0))
    k1 = learned.receptor_key(c.receptor)
    assert k1 != k0
    learned.pipeline.init_params(torch.Generator().manual_seed(1))
    assert learned.receptor_key(c.receptor) != k1


def test_service_lru_eviction():
    svc = DockingService(_cfg(), device="cpu", capacity=2)
    cs = [synthetic_complex(seed=10 + s, n_res_rec=6, n_res_lig=3)
          for s in range(3)]
    for c in cs:
        svc.prepare_receptor(c.receptor)
    assert svc.stats["entries"] == 2
    svc.prepare_receptor(cs[0].receptor)     # the oldest was evicted
    assert svc.stats["misses"] == 4
    svc.prepare_receptor(cs[2].receptor)     # the newest stayed
    assert svc.stats["hits"] == 1


def test_service_rescore_through_cache():
    cplx = synthetic_complex(seed=8, n_res_rec=8, n_res_lig=4)
    svc = DockingService(_cfg(fft_impl="dft_pallas"), device="cpu")
    poses = svc.dock(cplx.receptor, cplx.ligand)
    res = svc.rescore(cplx.receptor, cplx.ligand, poses, top=2, nrot=8)
    assert len(res) == len(poses)
    assert res.scores[0] >= poses.scores[0] - 1e-4
    assert svc.stats == dict(entries=1, hits=1, misses=1)
    want = DockingPipeline(svc.pipeline.config, device="cpu").rescore(
        cplx.receptor, cplx.ligand, poses, top=2, nrot=8)
    np.testing.assert_allclose(res.scores, want.scores, rtol=1e-5)
