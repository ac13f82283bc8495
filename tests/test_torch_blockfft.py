"""Torch port vs JAX package: the overlap-save ``block`` engine.

``correlate/blockfft.block_correlate_scores`` against the JAX function
and against the port's own full-grid ``correlate_scores`` of the
centre-embedded ligand box; the engine through every entry point that
takes it: ``pipeline.dock`` (shape and learned coupling), ``rescore``,
``continuous_score_block`` and its gradient, ``refine``, ``dock_batch``
and ``run_benchmark_batched``, ``score_decoys_resplat`` and training's
``complex_scores``, the service's engine cache, and the CLI.  On the
CPU at small sizes; no kernel runs on this path (``torch.fft``).

Tolerances: the block correlation rtol 2e-4 with atol 2e-4 of max |S|,
the JAX test's (``tests/test_blockfft.py``); top-K values rtol 1e-4
against JAX and 1e-3 against the port's ``dft`` engine; gradients 1e-3
of their leaf's largest component; refined poses 1e-4.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_parity import (V9P_DIR, jax_config, np_, t_, v9p_config,
                          v9p_flat, v9p_flax_params)

from deeplocalproteindocking_torch import cli as tcli
from deeplocalproteindocking_torch import evaluation as tev
from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.blockfft import (
    block_correlate_scores)
from deeplocalproteindocking_torch.correlate.fft import (
    correlate_scores, coupled_receptor, receptor_transform, resolve_engine)
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.parallel import batch_eval as tbe
from deeplocalproteindocking_torch.pipeline import DockingPipeline, PoseSet
from deeplocalproteindocking_torch.serving import DockingService
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.structure.pdb import write_pdb
from deeplocalproteindocking_torch.sweep import refine as trefine
from deeplocalproteindocking_torch.sweep.resplat import score_decoys_resplat
from deeplocalproteindocking_tpu import evaluation as jev
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.correlate import blockfft as jblock
from deeplocalproteindocking_tpu.correlate import fft as jfft
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.parallel import batch_eval as jbe
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations as j_super_fibonacci_rotations)
from deeplocalproteindocking_tpu.sweep import refine as jrefine
from deeplocalproteindocking_tpu.sweep import resplat as jres

CPU = ["--device", "cpu"]


def _case(seed=0, L=32, Ls=8, C=3):
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(L, L, L, C)).astype(np.float32)
    lig = rng.normal(size=(Ls, Ls, Ls, C)).astype(np.float32)
    A = rng.normal(size=(C, C)).astype(np.float32)
    return rec, lig, A


def _embedded(lig, L):
    Ls = lig.shape[0]
    off = (L - Ls) // 2
    big = np.zeros((L, L, L, lig.shape[-1]), np.float32)
    big[off:off + Ls, off:off + Ls, off:off + Ls] = lig
    return big


def _assert_block_close(got, want):
    want = np_(want)
    np.testing.assert_allclose(np_(got), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


# ---- block_correlate_scores ----

@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("coupled", [True, False])
def test_block_correlate_matches_jax_and_monolithic(block, coupled):
    rec, lig, A = _case(seed=int(coupled))
    A = A if coupled else None
    got = block_correlate_scores(t_(rec), t_(lig),
                                 None if A is None else t_(A), block=block)
    want = jblock.block_correlate_scores(
        jnp.asarray(rec), jnp.asarray(lig),
        None if A is None else jnp.asarray(A), block=block)
    assert got.shape == (32, 32, 32) and got.dtype == torch.float32
    _assert_block_close(got, want)
    # The port's own full-grid correlation of the centre-embedded box.
    H = receptor_transform(t_(rec), None if A is None else t_(A))
    _assert_block_close(got, correlate_scores(H, t_(_embedded(lig, 32))))


def test_block_wraparound_region():
    """Tiles index the receptor mod L, so the circularly aliased shifts
    around |t| = L/2 equal the monolithic circular correlation."""
    rec, lig, A = _case(seed=2, L=16, Ls=8)
    got = block_correlate_scores(t_(rec), t_(lig), t_(A), block=8)
    want = jblock.block_correlate_scores(jnp.asarray(rec), jnp.asarray(lig),
                                         jnp.asarray(A), block=8)
    corner = (slice(6, 10),) * 3
    _assert_block_close(got[corner], np_(want)[corner])
    mono = correlate_scores(receptor_transform(t_(rec), t_(A)),
                            t_(_embedded(lig, 16)))
    _assert_block_close(got[corner], mono[corner])


def test_block_must_divide():
    rec, lig, A = _case()
    with pytest.raises(ValueError, match="must divide"):
        block_correlate_scores(t_(rec), t_(lig), t_(A), block=12)


def test_block_batched_rows_and_receptor_groups():
    """``[B, Ls^3, C]`` ligands against ``[G, L^3, C]`` receptors: row b
    against receptor ``b // (B/G)``, each equal to a single call."""
    rng = np.random.default_rng(7)
    recs = rng.normal(size=(2, 16, 16, 16, 3)).astype(np.float32)
    ligs = rng.normal(size=(4, 8, 8, 8, 3)).astype(np.float32)
    got = block_correlate_scores(t_(recs), t_(ligs), block=8)
    assert got.shape == (4, 16, 16, 16)
    for b in range(4):
        one = block_correlate_scores(t_(recs[b // 2]), t_(ligs[b]), block=8)
        np.testing.assert_allclose(np_(got[b]), np_(one), rtol=1e-5,
                                   atol=1e-5 * float(one.abs().max()))
        want = jblock.block_correlate_scores(jnp.asarray(recs[b // 2]),
                                             jnp.asarray(ligs[b]), block=8)
        _assert_block_close(got[b], want)


def test_coupled_receptor_block_is_real_space():
    rec, _, A = _case(seed=3, L=8)
    got = coupled_receptor(t_(rec), t_(A), "block")
    want = jfft.coupled_receptor(jnp.asarray(rec), jnp.asarray(A), "block")
    assert not got.is_complex() and got.shape == rec.shape
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-5)
    assert coupled_receptor(t_(rec), None, "block") is not None
    assert resolve_engine("dft_fused", 192) == "block"
    assert resolve_engine("dft_fused", 128) == "dft_fused"


# ---- pipeline.dock under block ----

def test_pipeline_block_shape_matches_jax_and_dft():
    """Shape mode at grid 48, block 16, 12 rotations (the JAX package's
    ``test_pipeline_block_matches_dft``)."""
    base = dict(grid_size=48, resolution=1.25, num_rotations=12,
                rotation_chunk=4, top_k=8, rep_features=(8,))
    cfg = DockConfig(fft_impl="block", fft_block=16, **base)
    cplx = synthetic_complex(seed=4, n_res_rec=10, n_res_lig=5)
    got = DockingPipeline(cfg, device="cpu").dock_complex(cplx,
                                                          cluster=False)
    want = jpipe.DockingPipeline(config=jax_config(cfg)).dock_complex(
        jbench.synthetic_complex(seed=4, n_res_rec=10, n_res_lig=5),
        cluster=False)
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=1e-4)
    assert got.rot_idx[0] == want.rot_idx[0]
    np.testing.assert_array_equal(got.shifts[0], np.asarray(want.shifts)[0])
    dft = DockingPipeline(cfg.replace(fft_impl="dft"),
                          device="cpu").dock_complex(cplx, cluster=False)
    np.testing.assert_allclose(got.scores, dft.scores, rtol=1e-3)
    np.testing.assert_array_equal(got.rot_idx, dft.rot_idx)
    np.testing.assert_array_equal(got.shifts, dft.shifts)


def test_pipeline_block_learned_coupling_matches_jax():
    """Learned mode (grid 32, ``rep_features (8, 8)``): JAX params
    carried across by ``weights``; the coupling folds into the
    real-space receptor rep."""
    base = dict(grid_size=32, resolution=1.25, num_rotations=4,
                rotation_chunk=2, top_k=4, rep_features=(8, 8),
                fft_impl="block", fft_block=16)
    cfg = DockConfig(**base)
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    ref.init_params(seed=1)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(ref.params, sep="/").items()}
    port = DockingPipeline(cfg, params=weights.params_from_numpy(flat),
                           device="cpu")
    cplx = synthetic_complex(seed=5, n_res_rec=8, n_res_lig=4)
    got = port.dock_complex(cplx, cluster=False)
    want = ref.dock_complex(cplx, cluster=False)
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    assert got.rot_idx[0] == want.rot_idx[0]
    np.testing.assert_array_equal(got.shifts[0], np.asarray(want.shifts)[0])


def test_default_engine_docks_above_128():
    """``DockConfig(grid_size=160)`` on the default ``dft_fused``
    resolves to ``block`` and docks end to end."""
    cfg = DockConfig(grid_size=160, resolution=1.25, num_rotations=2,
                     rotation_chunk=2, top_k=4, rep_features=(8,))
    assert resolve_engine(cfg.fft_impl, cfg.grid_size) == "block"
    poses = DockingPipeline(cfg, device="cpu").dock_complex(
        synthetic_complex(seed=6, n_res_rec=10, n_res_lig=5))
    assert len(poses) > 0 and np.all(np.isfinite(poses.scores))


# ---- v9p at grid 32: rescore, the continuous score, refine ----

@pytest.fixture(scope="module")
def v9p_block():
    """Port and JAX pipelines on the v9p model (rank-3 coupling) under
    ``block`` at grid 32, block 16, one complex, the JAX coarse poses,
    and both engines' receptor halves."""
    cfg = v9p_config().replace(
        grid_size=32, num_rotations=8, rotation_chunk=4, top_k=6,
        coupling_rank=3, lig_grid_size=None, fft_impl="block", fft_block=16)
    port = DockingPipeline(cfg, params=weights.params_from_numpy(v9p_flat()),
                           device="cpu")
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    ref.params = v9p_flax_params()
    cplx = jbench.synthetic_complex(seed=5, n_res_rec=20, n_res_lig=8,
                                    unbound_rmsd=1.0)
    poses = ref.dock_complex(cplx, cluster=False)
    poses = PoseSet(*(np.asarray(f) for f in poses[:5]))
    rec_c, lig_c, rep_rec, _, cpl = ref._prepare(cplx.receptor, cplx.ligand)
    j_impl, jH, j_rep = ref._engine_parts(rep_rec, cpl)
    jl = jbench.structure_to_device(lig_c, bucket=cfg.atom_bucket)
    _, eng, tl, lig_grid = port._stage_inputs(cplx.receptor, cplx.ligand,
                                              None, None)
    assert j_impl == eng[0] == "block" and not eng[1].is_complex()
    np.testing.assert_allclose(np_(eng[1]), np_(jH), rtol=1e-5, atol=1e-5)
    kw = dict(grid_size=32, lig_grid=lig_grid, resolution=cfg.resolution,
              sigma=cfg.sigma, num_types=11)
    return dict(port=port, ref=ref, cplx=cplx, poses=poses,
                j=(jH, jl, j_rep), t=(eng[1], tl, eng[2]), kw=kw)


def test_block_dock_v9p_matches_jax(v9p_block):
    p = v9p_block
    got = p["port"].dock_complex(p["cplx"], cluster=False)
    np.testing.assert_allclose(got.scores, p["poses"].scores, rtol=1e-4)
    np.testing.assert_array_equal(got.rot_idx[:1], p["poses"].rot_idx[:1])
    np.testing.assert_array_equal(got.shifts[:1], p["poses"].shifts[:1])


def test_block_rescore_matches_jax(v9p_block):
    p = v9p_block
    kw = dict(top=2, nrot=6)
    want = p["ref"].rescore(p["cplx"].receptor, p["cplx"].ligand,
                            p["poses"], **kw)
    got = p["port"].rescore(p["cplx"].receptor, p["cplx"].ligand,
                            p["poses"], **kw)
    np.testing.assert_allclose(np.sort(got.scores), np.sort(want.scores),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.shifts[:2], want.shifts[:2])
    np.testing.assert_allclose(got.rotations[:2], want.rotations[:2],
                               atol=1e-6)


def test_continuous_score_block_value_and_grad(v9p_block):
    p = v9p_block
    (jH, jl, j_rep), (tH, tl, t_rep), kw = p["j"], p["t"], p["kw"]
    R = np.asarray(p["poses"].rotations[1], np.float32)
    t = (p["poses"].shifts[1] + np.array([0.3, -0.2, 0.45])
         ).astype(np.float32)

    def jscore(R, t):
        return jrefine.continuous_score_block(jH, *jl, R, t, j_rep, **kw)

    want, (wR, wt) = jax.value_and_grad(jscore, argnums=(0, 1))(
        jnp.asarray(R), jnp.asarray(t))
    Rt = t_(R).requires_grad_(True)
    tt = t_(t).requires_grad_(True)
    got = trefine.continuous_score_block(tH, *tl, Rt[None], tt[None], t_rep,
                                         **kw)[0]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for g, w in ((Rt.grad, wR), (tt.grad, wt)):
        w = np_(w)
        np.testing.assert_allclose(np_(g), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())
    # At lattice poses the real-space score is the sweep's score.
    s0 = trefine.continuous_score_block(
        tH, *tl, t_(p["poses"].rotations[:2]),
        t_(p["poses"].shifts[:2], torch.float32), t_rep, **kw)
    np.testing.assert_allclose(np_(s0), p["poses"].scores[:2], rtol=1e-4)


def test_block_refine_is_refine_poses_on_the_real_space_rep(v9p_block):
    """``DockingPipeline.refine`` under ``block`` refines against the
    engine's real-space receptor rep (never a spectrum) with
    ``refine_poses(fft_impl="block")`` (held against JAX in
    ``tests/test_torch_serving.py``), re-ranked; no pose gets worse."""
    p = v9p_block
    (tH, tl, t_rep), kw = p["t"], p["kw"]
    sub = PoseSet(*(f[:2] for f in p["poses"][:5]))
    got = p["port"].refine(p["cplx"].receptor, p["cplx"].ligand, sub,
                           steps=2)
    raw = trefine.refine_poses(tH, *tl, t_(sub.rotations), t_(sub.shifts),
                               t_rep, steps=2, fft_impl="block", **kw)
    order = np.argsort(-np_(raw.scores))
    np.testing.assert_array_equal(got.scores, np_(raw.scores)[order])
    np.testing.assert_array_equal(got.translations,
                                  np_(raw.translations)[order])
    np.testing.assert_allclose(np_(raw.initial_scores), sub.scores,
                               rtol=1e-4)
    assert np.all(np_(raw.scores) >= np_(raw.initial_scores))


def test_service_block_engine_is_real_space(v9p_block):
    """``DockingService`` caches the block engine's real-space receptor
    rep and docks through it as ``DockingPipeline.dock`` does."""
    p = v9p_block
    svc = DockingService(p["port"].config, p["port"].params, device="cpu")
    got = svc.dock(p["cplx"].receptor, p["cplx"].ligand, cluster=False)
    _, engine = svc.cached(p["cplx"].receptor, p["cplx"].ligand)
    assert engine[0] == "block" and engine[1].shape == (32, 32, 32, 3)
    assert svc.stats["misses"] == 1 and svc.stats["hits"] == 1
    np.testing.assert_allclose(got.scores, p["poses"].scores, rtol=1e-4)


# ---- batched: dock_batch, run_benchmark_batched ----

def test_dock_batch_block_matches_jax():
    """Two complexes, one real-space receptor each, against JAX
    ``dock_batch(None, ...)`` under ``block``."""
    rng = np.random.default_rng(0)
    recs = rng.random((2, 16, 16, 16, 3)).astype(np.float32)
    lc = rng.uniform(-2.5, 2.5, (2, 8, 3)).astype(np.float32)
    lt = rng.integers(0, 3, (2, 8)).astype(np.int32)
    lm = np.ones((2, 8), np.float32)
    kw = dict(grid_size=16, lig_grid=8, resolution=1.0, sigma=1.0,
              num_types=3, top_k=4, chunk=2, fft_impl="block", fft_block=8)
    want = jbe.dock_batch(None, jnp.asarray(recs), jnp.asarray(lc),
                          jnp.asarray(lt), jnp.asarray(lm),
                          j_super_fibonacci_rotations(5), lambda v: v, **kw)
    got = tbe.dock_batch(t_(recs), t_(lc), t_(lt), t_(lm),
                         super_fibonacci_rotations(5), lambda v: v, **kw)
    np.testing.assert_allclose(np_(got.scores), np_(want.scores), rtol=1e-4)
    np.testing.assert_array_equal(np_(got.rot_idx)[:, 0],
                                  np_(want.rot_idx)[:, 0])
    np.testing.assert_array_equal(np_(got.shifts)[:, 0],
                                  np_(want.shifts)[:, 0])


def test_run_benchmark_batched_block_matches_jax(tmp_path):
    cfg = DockConfig(grid_size=32, resolution=1.25, num_rotations=4,
                     rotation_chunk=4, top_k=6, nms_rmsd=3.0,
                     rep_features=(8,), fft_impl="block", fft_block=16)
    cplxs = [synthetic_complex(seed=s, n_res_rec=8, n_res_lig=4)
             for s in (30, 31)]
    s_got = tev.run_benchmark_batched(DockingPipeline(cfg, device="cpu"),
                                      cplxs, str(tmp_path / "t"),
                                      group_size=2)
    s_want = jev.run_benchmark_batched(
        jpipe.DockingPipeline(config=jax_config(cfg)), cplxs,
        str(tmp_path / "j"), group_size=2)
    assert s_got == s_want
    for c in cplxs:
        with open(tmp_path / "t" / f"{c.name}.json") as f:
            got = json.load(f)
        with open(tmp_path / "j" / f"{c.name}.json") as f:
            want = json.load(f)
        assert got["hit_top1"] == want["hit_top1"]
        assert got["num_poses"] == want["num_poses"] > 0
        np.testing.assert_allclose([q["score"] for q in got["poses"]],
                                   [q["score"] for q in want["poses"]],
                                   rtol=1e-4)


# ---- training: score_decoys_resplat, complex_scores ----

def test_score_decoys_resplat_block_matches_jax(v9p_block):
    """Each decoy's lattice cell of its block score volume, values and
    the gradient in the receptor rep."""
    p = v9p_block
    (jH, jl, j_rep), (tH, tl, t_rep), kw = p["j"], p["t"], p["kw"]
    R = p["poses"].rotations[:2].astype(np.float32)
    sh = (p["poses"].shifts[:2] + np.array([0.2, -0.4, 0.0])
          ).astype(np.float32)

    def jsum(H):
        return jnp.sum(jres.score_decoys_resplat(
            H, *jl, jnp.asarray(R), jnp.asarray(sh), j_rep,
            fft_impl="block", fft_block=16, **kw))

    want = jres.score_decoys_resplat(jH, *jl, jnp.asarray(R),
                                     jnp.asarray(sh), j_rep,
                                     fft_impl="block", fft_block=16, **kw)
    gH = jax.grad(jsum)(jH)
    Ht = tH.detach().clone().requires_grad_(True)
    got = score_decoys_resplat(Ht, *tl, t_(R), t_(sh), t_rep,
                               fft_impl="block", fft_block=16, **kw)
    got.sum().backward()
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-4)
    np.testing.assert_allclose(np_(got[:1]), p["poses"].scores[:1],
                               rtol=1e-4)
    w = np_(gH)
    np.testing.assert_allclose(np_(Ht.grad), w, rtol=0,
                               atol=1e-3 * np.abs(w).max())


# ---- the CLI ----

def test_cli_dock_block_writes_poses(tmp_path, capsys):
    """``dock --fft-impl block`` writes ``poses.json`` whose scores equal
    the pipeline's; doctor names the engine and the kernels' absence."""
    cplx = synthetic_complex(seed=2, n_res_rec=10, n_res_lig=5)
    rec, lig = tmp_path / "rec.pdb", tmp_path / "lig.pdb"
    write_pdb(str(rec), cplx.receptor)
    write_pdb(str(lig), cplx.ligand)
    out = tmp_path / "out"
    flags = ["--grid-size", "32", "--num-rotations", "6", "--top-k", "4",
             "--fft-impl", "block", "--fft-block", "16"]
    assert tcli.main(["dock", "--receptor", str(rec), "--ligand", str(lig),
                      "--out", str(out)] + flags + CPU) in (0, None)
    with open(out / "poses.json") as f:
        poses = json.load(f)
    assert len(poses) > 0 and all(np.isfinite(q["score"]) for q in poses)
    assert os.path.exists(out / "pose_000.pdb")
    capsys.readouterr()
    tcli.main(["doctor", "--timeout", "90", "--checkpoint", V9P_DIR,
               "--grid-size", "192"] + CPU)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    routes = rep["routes"]
    assert routes["engine"] == "block" and routes["fft_block"] == 32
    assert all(routes[k] == "not on this path (block engine)"
               for k in ("k1", "k2", "k3"))
