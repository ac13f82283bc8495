"""Torch port vs JAX package: the ``resample`` sweep and approximate top-K.

``grids/rotate`` (trilinear and nearest-neighbour resampling of a volume
about the grid centre), ``sweep/docker.dock_sweep``,
``pipeline.dock`` in ``sweep_mode="resample"`` against the JAX
package's committed snapshot ``tests/golden_sweep.json``,
``dock_ensemble`` through its sequential route, ``correlate/fft.
score_at``, training's ``complex_scores`` and the loss gradient under
``resample`` and ``block``, ``topk_impl="approx"`` and the CLI.  On the
CPU at small sizes; no kernel runs on this path (``torch.fft``).

Tolerances: order-1 resampling atol 1e-6 of max |vol| (float32
summation of eight corners); order 0 equal; top-K value multisets rtol
1e-4; the golden snapshot at its own gate (``tests/test_golden.py``:
``rot_idx`` and ``shifts`` equal, scores rtol 1e-3, atol 2e-3); the loss
rtol 1e-4 and each gradient within 1e-3 of its leaf's largest.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_parity import (ROOT, V9P_DIR, assert_same_multiset, jax_config,
                          np_, t_)

from deeplocalproteindocking_torch import cli as tcli
from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.fft import (
    receptor_transform, score_at, translation_mask)
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.grids import rotate_volume, rotate_volumes
from deeplocalproteindocking_torch.grids.rotate import _source_lattice
from deeplocalproteindocking_torch.pipeline import DockingPipeline
from deeplocalproteindocking_torch.structure.pdb import write_pdb
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep import DockResult, dock_sweep
from deeplocalproteindocking_torch.sweep.resplat import APPROX_TOPK_WARNING
from deeplocalproteindocking_torch.train.trainer import TrainBatch, Trainer
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.correlate import fft as jfft
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.grids import rotate as jrot
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations as j_super_fibonacci_rotations)
from deeplocalproteindocking_tpu.sweep import docker as jdocker
from deeplocalproteindocking_tpu.train import data_gen as jdata
from deeplocalproteindocking_tpu.train import trainer as jtrainer

CPU = ["--device", "cpu"]
GOLDEN = os.path.join(ROOT, "tests", "golden_sweep.json")


def _vol(L=12, C=3, seed=0):
    return np.random.default_rng(seed).normal(
        size=(L, L, L, C)).astype(np.float32)


def _random_rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]).transpose(2, 0, 1).astype(np.float32)


def _rot90(axis, k):
    """An exact lattice rotation: k quarter turns about ``axis``."""
    R = np.eye(3, dtype=np.float32)
    a, b = [i for i in range(3) if i != axis]
    for _ in range(k):
        Q = np.eye(3, dtype=np.float32)
        Q[a, a] = Q[b, b] = 0.0
        Q[a, b], Q[b, a] = -1.0, 1.0
        R = Q @ R
    return R


# ---- grids/rotate ----

@pytest.mark.parametrize("L", [11, 12])
def test_rotate_volume_trilinear_matches_jax(L):
    """Random rotations and the exact 90-degree ones, odd and even L."""
    vol = _vol(L)
    Rs = np.concatenate([_random_rotations(3, L),
                         np.stack([_rot90(0, 1), _rot90(1, 2),
                                   _rot90(2, 3)])])
    for R in Rs:
        got = rotate_volume(t_(vol), t_(R))
        want = jrot.rotate_volume(jnp.asarray(vol), jnp.asarray(R))
        np.testing.assert_allclose(np_(got), np_(want), rtol=0,
                                   atol=1e-6 * np.abs(vol).max())
    # A quarter turn is a permutation of the lattice.
    got = np_(rotate_volume(t_(vol), t_(_rot90(2, 1))))
    np.testing.assert_allclose(np.sort(got.ravel()), np.sort(vol.ravel()),
                               atol=1e-6)


@pytest.mark.parametrize("L", [11, 12])
def test_rotate_volume_nearest_rounds_half_away_from_zero(L):
    """Order 0 with exact half ties: ``R = 0.5 I`` at odd L (and ``2 I``
    at even L) puts source coordinates on .5, ``-0.5 I`` on -.5, and
    mixed-sign scalings beside quarter turns; results equal JAX's (round
    half away from zero, out of range reads 0)."""
    vol = _vol(L, seed=1)
    mats = [0.5 * np.eye(3), -0.5 * np.eye(3), 2.0 * np.eye(3),
            np.diag([0.5, -2.0, 1.0]), 0.5 * _rot90(1, 1),
            _rot90(0, 1), 2.0 * _rot90(2, 3)]
    ties = 0
    for R in mats:
        R = R.astype(np.float32)
        got = np_(rotate_volume(t_(vol), t_(R), order=0))
        want = np_(jrot.rotate_volume(jnp.asarray(vol), jnp.asarray(R),
                                      order=0))
        np.testing.assert_array_equal(got, want)
        frac = np.abs(np_(_source_lattice(t_(R), L)) % 1.0)
        ties += int(np.isclose(frac, 0.5).sum())
    assert ties > 0


def test_rotate_volume_nearest_random_rotations():
    """Order 0 on random rotations equals JAX's wherever no source
    coordinate lies within 1e-4 of a .5 tie (there one float rounding of
    the lattice may pick the other neighbour)."""
    L = 12
    vol = _vol(L, seed=2)
    for R in _random_rotations(3, 9):
        got = np_(rotate_volume(t_(vol), t_(R), order=0)).reshape(-1, 3)
        want = np_(jrot.rotate_volume(jnp.asarray(vol), jnp.asarray(R),
                                      order=0)).reshape(-1, 3)
        src = np_(_source_lattice(t_(R), L))
        safe = np.all(np.abs(np.abs(src % 1.0) - 0.5) > 1e-4, axis=0)
        assert safe.mean() > 0.99
        np.testing.assert_array_equal(got[safe], want[safe])


def test_rotate_volumes_is_a_batch_of_rotate_volume():
    vol = _vol(10, seed=3)
    Rs = _random_rotations(4, 5)
    got = rotate_volumes(t_(vol), t_(Rs))
    assert got.shape == (4, 10, 10, 10, 3)
    want = jrot.rotate_volumes(jnp.asarray(vol), jnp.asarray(Rs))
    np.testing.assert_allclose(np_(got), np_(want), rtol=0,
                               atol=1e-6 * np.abs(vol).max())
    for i, R in enumerate(Rs):
        np.testing.assert_array_equal(np_(got[i]),
                                      np_(rotate_volume(t_(vol), t_(R))))


# ---- sweep/docker.dock_sweep ----

def _reps(L=32, C=2, seed=0):
    """Receptor and ligand reps splatted from a synthetic complex in
    shape mode, as ``pipeline.dock`` builds them."""
    cfg = DockConfig(grid_size=L, resolution=1.5, rep_features=(8,))
    pipe = DockingPipeline(cfg, device="cpu")
    cplx = synthetic_complex(seed=seed, n_res_rec=10, n_res_lig=5)
    _, _, rec, lig, A = pipe._prepare(cplx.receptor, cplx.ligand)
    return np_(rec), np_(lig), np_(A)


@pytest.mark.parametrize("chunk,masked", [(4, False), (5, False), (5, True)])
def test_dock_sweep_matches_jax(chunk, masked):
    """Grid 32, 12 rotations; chunk 5 pads 3 identity rotations, which
    ``num_valid`` masks out; the mask a local-docking window."""
    rec, lig, A = _reps()
    rots = j_super_fibonacci_rotations(12)
    sm = np_(translation_mask(32, 6)) if masked else None
    want = jdocker.dock_sweep(jnp.asarray(rec), jnp.asarray(lig), rots,
                              jnp.asarray(A), top_k=8, chunk=chunk,
                              score_mask=None if sm is None
                              else jnp.asarray(sm))
    got = dock_sweep(t_(rec), t_(lig), t_(rots), t_(A), top_k=8,
                     chunk=chunk,
                     score_mask=None if sm is None else t_(sm))
    assert isinstance(got, DockResult)
    assert_same_multiset(got.scores, want.scores, rtol=1e-4, atol=1e-3)
    assert int(got.rot_idx[0]) == int(want.rot_idx[0])
    np.testing.assert_array_equal(np_(got.shifts[0]), np_(want.shifts[0]))
    assert int(got.rot_idx.max()) < 12
    if masked:
        assert int(np_(got.shifts).__abs__().max()) <= 6


def test_score_at_matches_jax():
    rec, lig, A = _reps(L=16, seed=1)
    shifts = np.array([[0, 0, 0], [1.4, -2.6, 3.0], [-8, 7, 2]], np.float32)
    got = score_at(receptor_transform(t_(rec), t_(A)), t_(lig), t_(shifts))
    want = jfft.score_at(jfft.receptor_transform(jnp.asarray(rec),
                                                 jnp.asarray(A)),
                         jnp.asarray(lig), jnp.asarray(shifts))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np_(want)).max())


# ---- pipeline ----

def test_pipeline_resample_reproduces_golden_snapshot():
    """``tests/test_golden.py``'s protocol: grid 32, 12 rotations, chunk
    4, shape mode, unclustered top 8."""
    cfg = DockConfig(grid_size=32, resolution=1.5, num_rotations=12,
                     rotation_chunk=4, top_k=8, rep_features=(8,),
                     sweep_mode="resample")
    cplx = synthetic_complex(seed=42, n_res_rec=10, n_res_lig=5)
    poses = DockingPipeline(cfg, device="cpu").dock_complex(
        cplx, rotations=super_fibonacci_rotations(12), cluster=False)
    with open(GOLDEN) as f:
        want = json.load(f)
    assert [int(r) for r in poses.rot_idx] == want["rot_idx"]
    assert [[int(v) for v in s] for s in poses.shifts] == want["shifts"]
    np.testing.assert_allclose([round(float(s), 3) for s in poses.scores],
                               want["scores"], rtol=1e-3, atol=2e-3)


def test_dock_ensemble_resample_matches_jax():
    """2 x 2 models in resample mode take the sequential route in both
    packages: merged scores, tags and NMS survivors equal."""
    c = synthetic_complex(seed=6, n_res_rec=6, n_res_lig=3)
    rng = np.random.default_rng(1)

    def jiggle(s):
        import dataclasses
        return dataclasses.replace(s, coords=(
            s.coords + rng.normal(0, 0.3, s.coords.shape)).astype(np.float32))

    recs, ligs = [c.receptor, jiggle(c.receptor)], [c.ligand,
                                                    jiggle(c.ligand)]
    cfg = DockConfig(grid_size=32, resolution=1.5, rep_features=(4,),
                     num_rotations=6, rotation_chunk=4, top_k=6,
                     nms_rmsd=3.0, sweep_mode="resample")
    port = DockingPipeline(cfg, device="cpu")
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    for cluster in (False, True):
        got, gp = port.dock_ensemble(recs, ligs, cluster=cluster)
        want, wp = ref.dock_ensemble(recs, ligs, cluster=cluster)
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(gp[:1], wp[:1])
        np.testing.assert_array_equal(got.shifts[:1], want.shifts[:1])
    assert len(port.dock_ensemble(recs, ligs, cluster=False)[0]) == 4 * 6


def test_topk_approx_warns_and_is_exact():
    """``topk_impl="approx"`` warns with the JAX package's text and
    returns the exact top-K, as ``jax.lax.approx_max_k`` does off a
    TPU."""
    base = dict(grid_size=32, resolution=1.5, num_rotations=8,
                rotation_chunk=4, top_k=8, rep_features=(8,),
                fft_impl="dft")
    cplx = synthetic_complex(seed=3, n_res_rec=10, n_res_lig=5)
    exact = DockingPipeline(DockConfig(**base), device="cpu").dock_complex(
        cplx, cluster=False)
    with pytest.warns(UserWarning) as rec:
        approx = DockingPipeline(DockConfig(topk_impl="approx", **base),
                                 device="cpu").dock_complex(cplx,
                                                            cluster=False)
    assert APPROX_TOPK_WARNING in [str(w.message) for w in rec]
    np.testing.assert_array_equal(approx.scores, exact.scores)
    np.testing.assert_array_equal(approx.rot_idx, exact.rot_idx)
    np.testing.assert_array_equal(approx.shifts, exact.shifts)
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        jpipe.DockingPipeline(config=jax_config(
            DockConfig(topk_impl="approx", **base))).dock_complex(
                cplx, cluster=False)
    assert APPROX_TOPK_WARNING in [str(w.message) for w in jrec]


# ---- training under resample and block ----

def _train_cfg(**kw):
    base = dict(grid_size=16, resolution=1.5, rep_features=(4,),
                shape_prior=True, num_decoys=4, batch_complexes=2,
                num_rotations=4, rotation_chunk=4, decoy_max_shift=4.0,
                decoy_max_angle_deg=40.0, decoy_global_frac=0.34,
                near_native_rmsd=5.0, hinge_margin=20.0, fft_block=8)
    base.update(kw)
    return DockConfig(**base)


@pytest.mark.parametrize("mode", [dict(sweep_mode="resample"),
                                  dict(fft_impl="block")])
def test_train_loss_and_grads_match_jax(mode):
    """``complex_scores`` (through ``Trainer.loss_fn``) under
    ``resample`` and ``block``: the loss, the accuracy and every
    parameter gradient against JAX at params perturbed off the init, so
    every leaf has a gradient."""
    cfg = _train_cfg(**mode)
    jcfg = jax_config(cfg)
    jt = jtrainer.Trainer(jcfg)
    rng = np.random.default_rng(0)
    flat = {k: np.asarray(v) + 0.05 * rng.normal(size=np.shape(v)).astype(
        np.float32) for k, v in flatten_dict(jt.init_state().params,
                                             sep="/").items()}
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     unflatten_dict(flat, sep="/"))
    jcplx = [jbench.synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
             for s in range(2)]
    jbatch = jdata.make_training_batch(jax.random.key(1), jcplx, jcfg)
    (jloss, jacc), jgrads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jparams, jbatch)
    tr = Trainer(cfg, device="cpu")
    loss, acc, grads = tr.value_and_grad(
        weights.params_from_numpy(flat),
        TrainBatch(*(t_(np.asarray(f)) for f in jbatch)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=0, atol=1e-6)
    want = weights.params_from_numpy(
        {k: np.asarray(v) for k, v in flatten_dict(jgrads,
                                                   sep="/").items()})
    assert grads.keys() == want.keys()
    for k in want:
        w = np_(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(np_(grads[k]), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


# ---- the CLI ----

def test_cli_dock_resample_writes_poses(tmp_path, capsys):
    """``dock --sweep-mode resample`` writes ``poses.json`` with the
    pipeline's own top poses; doctor names the sweep and the kernels'
    absence."""
    cplx = synthetic_complex(seed=2, n_res_rec=10, n_res_lig=5)
    rec, lig = tmp_path / "rec.pdb", tmp_path / "lig.pdb"
    write_pdb(str(rec), cplx.receptor)
    write_pdb(str(lig), cplx.ligand)
    out = tmp_path / "out"
    tcli.main(["dock", "--receptor", str(rec), "--ligand", str(lig),
               "--out", str(out), "--grid-size", "32", "--num-rotations",
               "6", "--top-k", "4", "--sweep-mode", "resample"] + CPU)
    with open(out / "poses.json") as f:
        poses = json.load(f)
    assert len(poses) > 0 and all(np.isfinite(q["score"]) for q in poses)
    assert os.path.exists(out / "pose_000.pdb")
    capsys.readouterr()
    tcli.main(["doctor", "--timeout", "90", "--checkpoint", V9P_DIR,
               "--sweep-mode", "resample"] + CPU)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    routes = rep["routes"]
    assert routes["sweep_mode"] == "resample"
    assert all(routes[k] == "not on this path (resample sweep)"
               for k in ("k1", "k2", "k3"))
