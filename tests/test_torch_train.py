"""Torch port vs JAX package: training.

The ranking loss, decoy labels, batch assembly, the decoy-scoring path,
the loss and its gradient, the optimizer (optax's Adam / AdamW with the
cosine schedule), whole train steps, the carried-over JAX train state,
FFT-mined hard negatives, the mined buffer's file and the flagship
driver, on the CPU at a small size (grid 16, ``rep_features (4,)`` with
the shape prior, 6 decoys x 2 complexes; mining at grid 24).  JAX
params come from ``Trainer.init_state`` through ``params_from_numpy``;
batches from the JAX package's ``make_training_batch`` (JAX PRNG streams
cannot be reproduced, so the port is fed the JAX samples).

Tolerances: scores and the loss rtol 1e-4 (float32, summation order);
gradients 1e-3 of their largest component; the optimizer on JAX's own
gradients 1e-6; parameters after a whole step 1e-2 lr, except where
|g| < 1e-3 max|g|: there Adam's first step is lr times the sign of a
gradient that rounding may flip, so 2 lr.
"""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_parity import V9P_DIR, jax_config, np_, t_

from deeplocalproteindocking_torch import train_flagship, weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.data.benchmark import synthetic_band
from deeplocalproteindocking_torch.structure.transforms import (
    apply_pose, random_rotations)
from deeplocalproteindocking_torch.train import checkpoint
from deeplocalproteindocking_torch.train import decoys as tdecoys
from deeplocalproteindocking_torch.train import losses as tlosses
from deeplocalproteindocking_torch.train import mining as tmining
from deeplocalproteindocking_torch.train.data_gen import (
    fit_lig_grid, make_training_batch)
from deeplocalproteindocking_torch.train.scoring_path import complex_scores
from deeplocalproteindocking_torch.train.trainer import (
    TrainBatch, Trainer, learning_rate)
from deeplocalproteindocking_torch.utils.rmsd import rmsd
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.train import data_gen as jdata
from deeplocalproteindocking_tpu.train import decoys as jdecoys
from deeplocalproteindocking_tpu.train import losses as jlosses
from deeplocalproteindocking_tpu.train import mining as jmining
from deeplocalproteindocking_tpu.train import scoring_path as jscoring
from deeplocalproteindocking_tpu.train import trainer as jtrainer


LR = 1e-3


def _cfg(**kw):
    base = dict(grid_size=16, resolution=1.5, rep_features=(4,),
                shape_prior=True, num_decoys=6, batch_complexes=2,
                num_rotations=4, rotation_chunk=4, decoy_max_shift=4.0,
                decoy_max_angle_deg=40.0, decoy_global_frac=0.34,
                learning_rate=LR, near_native_rmsd=5.0, hinge_margin=20.0)
    base.update(kw)
    return DockConfig(**base)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _to_port(tree) -> dict:
    """A flax tree (params, grads or moments) in the port's names."""
    return weights.params_from_numpy(_flat(tree))


def _port_batch(jbatch) -> TrainBatch:
    return TrainBatch(*(t_(np.asarray(f)) for f in jbatch))


def _assert_grads(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        w = np_(want[k])
        np.testing.assert_allclose(np_(got[k]), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


def _assert_params_after_step(got: dict, want: dict, grads: dict, lr):
    """Within 1e-2 lr, or 2 lr where the gradient is below 1e-3 of its
    leaf's largest (Adam's sign there can flip with rounding)."""
    for k in want:
        g = np.abs(np_(grads[k]))
        tol = np.where(g < 1e-3 * g.max(), 2 * lr, 1e-2 * lr)
        diff = np.abs(np_(got[k]) - np_(want[k]))
        assert np.all(diff <= tol), (k, float(diff.max()))


@pytest.fixture(scope="module")
def setup():
    """JAX trainer + state + batch at grid 16, the port's trainer, and
    JAX's loss, accuracy and gradients at the initial params."""
    cfg = _cfg()
    jcfg = jax_config(cfg)
    jt = jtrainer.Trainer(jcfg)
    state = jt.init_state()
    jcplx = [jbench.synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
             for s in range(3)]
    jbatch = jdata.make_training_batch(jax.random.key(1), jcplx, jcfg)
    vg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))
    (loss, acc), grads = vg(state.params, jbatch)
    return dict(cfg=cfg, jcfg=jcfg, jt=jt, state=state, jbatch=jbatch,
                batch=_port_batch(jbatch), tr=Trainer(cfg, device="cpu"),
                params=_to_port(state.params), loss=float(loss),
                acc=float(acc), grads=grads, vg=vg)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX states after 1, 2 and 3 train steps on the fixture's batch."""
    states = [setup["state"]]
    for _ in range(3):
        states.append(setup["jt"].train_step(states[-1],
                                             setup["jbatch"])[0])
    return states


# ---- losses ----

@pytest.mark.parametrize("scores,lrmsd", [
    ([10.0, 1.0, 0.0], [1.0, 20.0, 30.0]),        # perfect ranking
    ([0.0, 10.0], [1.0, 20.0]),                    # inverted
    ([1.0, 2.0], [20.0, 30.0]),                    # no positive
    ([1.0, 2.0], [1.0, 2.0]),                      # no negative
    ([2.0, 2.0, 2.0], [1.0, 9.0, 9.0]),            # ties
    ([0.5, 3.0, -1.0, 3.0], [5.0, 5.0, 5.1, 40.0]),  # at the threshold
])
def test_hinge_and_accuracy_match_jax(scores, lrmsd):
    s, r = np.float32(scores), np.float32(lrmsd)
    kw = dict(near_native_rmsd=5.0, margin=1.0)
    np.testing.assert_allclose(
        float(tlosses.ranking_hinge_loss(t_(s), t_(r), **kw)),
        float(jlosses.ranking_hinge_loss(jnp.asarray(s), jnp.asarray(r),
                                         **kw)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.pairwise_ranking_accuracy(t_(s), t_(r), 5.0)),
        float(jlosses.pairwise_ranking_accuracy(jnp.asarray(s),
                                                jnp.asarray(r), 5.0)),
        rtol=1e-6)


def test_hinge_values():
    assert float(tlosses.ranking_hinge_loss(
        torch.tensor([0.0, 10.0]), torch.tensor([1.0, 20.0]))) == 11.0
    assert float(tlosses.pairwise_ranking_accuracy(
        torch.tensor([2.0, 2.0]), torch.tensor([1.0, 20.0]))) == 0.0


# ---- decoys ----

def _ligand(seed, n=8, scale=1.0):
    lig = np.random.default_rng(seed).normal(size=(n, 3)).astype(
        np.float32) * scale
    return lig - lig.mean(0)


@pytest.mark.parametrize("kind", ["local", "global"])
def test_label_decoys_on_jax_samples(kind):
    lig, mask = _ligand(0), np.ones(8, np.float32)
    mask[-1] = 0.0
    nat = np.array([2, -1, 0], np.int32)
    if kind == "local":
        d = jdecoys.generate_decoys(
            jax.random.key(0), jnp.asarray(lig), jnp.asarray(mask),
            jnp.asarray(nat), n=12, resolution=1.5, max_angle=0.5,
            max_shift=5.0)
    else:
        d = jdecoys.generate_global_decoys(
            jax.random.key(1), jnp.asarray(lig), jnp.asarray(mask),
            jnp.asarray(nat), n=12, resolution=1.5, max_shift_vox=6)
    got = tdecoys.label_decoys(t_(lig), t_(mask), t_(nat), t_(d.rotations),
                               t_(d.shifts), 1.5)
    np.testing.assert_allclose(np_(got.lrmsd), np.asarray(d.lrmsd),
                               rtol=0, atol=1e-5)


def test_generate_decoys_native_included_and_labels():
    lig = t_(_ligand(0))
    nat = torch.tensor([2, -1, 0], dtype=torch.int32)
    d = tdecoys.generate_decoys(torch.Generator().manual_seed(0), lig,
                                torch.ones(8), nat, n=10, resolution=1.5,
                                max_angle=0.5, max_shift=5.0)
    assert d.rotations.shape == (10, 3, 3) and d.shifts.shape == (10, 3)
    assert float(d.lrmsd[0]) < 1e-4
    assert d.shifts[0].tolist() == [2, -1, 0]
    assert bool(torch.isfinite(d.lrmsd).all()) and float(d.lrmsd.min()) >= 0
    # Shifts within +-round(5 / 1.5) voxels of the native.
    assert int((d.shifts - nat).abs().max()) <= 3
    # Rotations within the cone: angle = acos((tr - 1) / 2) <= 0.5.
    tr = torch.diagonal(d.rotations, dim1=-2, dim2=-1).sum(-1)
    assert float(torch.arccos(((tr - 1) / 2).clamp(-1, 1)).max()) <= 0.5 + 1e-4
    i = 3
    want = rmsd(apply_pose(lig, d.rotations[i], d.shifts[i].float() * 1.5),
                lig + nat.float() * 1.5)
    np.testing.assert_allclose(float(d.lrmsd[i]), float(want), rtol=1e-5)


def test_global_decoys_cover_so3_and_box():
    lig = t_(_ligand(0, scale=2.0))
    d = tdecoys.generate_global_decoys(
        torch.Generator().manual_seed(0), lig, torch.ones(8),
        torch.zeros(3, dtype=torch.int32), n=128, resolution=1.5,
        max_shift_vox=6)
    assert int(d.shifts.max()) == 6 and int(d.shifts.min()) == -6
    traces = torch.diagonal(d.rotations, dim1=-2, dim2=-1).sum(-1)
    assert float(traces.min()) < 0.0
    assert float(d.lrmsd.max()) > 10.0


def test_random_rotations_orthonormal():
    R = random_rotations(64, torch.Generator().manual_seed(3))
    eye = torch.eye(3).expand(64, 3, 3)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(64),
                               atol=1e-5, rtol=0)


# ---- batch assembly ----

@pytest.mark.parametrize("lig_grid", [None, 40])
def test_fit_lig_grid_matches_jax(lig_grid):
    cfg = DockConfig(grid_size=64, resolution=1.25, rep_features=(32, 14),
                     shape_prior=True, lig_grid_size=lig_grid)
    cplx = synthetic_band(200, 6, widen=True, unbound=1.2)
    jcplx = [jbench.synthetic_complex(seed=200 + s, n_res_rec=12 + s % 9,
                                      n_res_lig=6 + (s // 9) % 5,
                                      unbound_rmsd=1.2) for s in range(6)]
    got = fit_lig_grid(cplx, cfg).lig_grid_size
    assert got == jdata.fit_lig_grid(jcplx, jax_config(cfg)).lig_grid_size
    assert got == (lig_grid or got)


@pytest.fixture(scope="module")
def mining():
    """Mining at grid 24, 8 rotations, top-K 8 with the same params on
    both sides: (port cfg, port complexes, port buffer, JAX buffer)."""
    cfg = _cfg(grid_size=24, num_decoys=8, decoy_global_frac=0.25)
    jcfg = jax_config(cfg)
    jt = jtrainer.Trainer(jcfg)
    state = jt.init_state()
    jcplx = [jbench.synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
             for s in range(2)]
    cplx = [synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
            for s in range(2)]
    want = jmining.mine_hard_negatives(jt.model, state.params, jcfg, jcplx,
                                       n_rotations=8, top_k=8)
    tr = Trainer(cfg, device="cpu")
    got = tmining.mine_hard_negatives(tr.bind(_to_port(state.params)), cfg,
                                      cplx, n_rotations=8, top_k=8)
    return cfg, cplx, tr, _to_port(state.params), got, want


def test_mine_hard_negatives_matches_jax(mining):
    _, cplx, _, _, got, want = mining
    assert set(got) == set(want) == {c.name for c in cplx}
    for name in want:
        g, w = got[name], want[name]
        assert g.shifts.dtype == torch.float32
        keyed = {}
        for R, s, l in zip(np.asarray(w.rotations), np.asarray(w.shifts),
                           np.asarray(w.lrmsd)):
            keyed[tuple(np.round(R, 4).ravel()) + tuple(s)] = l
        assert len(keyed) == len(w.lrmsd) == len(g.lrmsd) == 8
        for R, s, l in zip(np_(g.rotations), np_(g.shifts), np_(g.lrmsd)):
            key = tuple(np.round(R, 4).ravel()) + tuple(s)
            assert key in keyed, (name, s)
            np.testing.assert_allclose(l, keyed[key], rtol=0, atol=1e-4)


def test_mined_buffer_feeds_batch_and_labels_hold(mining):
    """Every label of a batch with augmentation and mined poses is the
    geometric LRMSD of its pose in the batch's (turned) frame."""
    cfg, cplx, _, _, mined, _ = mining
    b = make_training_batch(torch.Generator().manual_seed(1), cplx, cfg,
                            mined=mined, device="cpu")
    assert b.decoy_shift.dtype == torch.float32
    assert b.decoy_rot.shape == (2, cfg.num_decoys, 3, 3)
    for bi in range(2):
        lc, lm = b.lig_coords[bi], b.lig_mask[bi]
        posed = apply_pose(lc[None], b.decoy_rot[bi],
                           b.decoy_shift[bi] * cfg.resolution)
        native = apply_pose(lc[None], b.decoy_rot[bi, :1],
                            b.decoy_shift[bi, :1] * cfg.resolution)
        got = rmsd(posed, native, lm[None].expand(posed.shape[:-1]))
        # Mined labels reference the true native placement, the batch's
        # decoy 0 the lattice-snapped one.
        np.testing.assert_allclose(np_(got), np_(b.decoy_lrmsd[bi]),
                                   atol=1.5 * cfg.resolution)


def test_batch_is_one_draw_on_any_device():
    """The samples come from the CPU generator alone: the same seed gives
    the same batch whatever the target device's generator state."""
    cfg = _cfg()
    cplx = [synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
            for s in range(3)]
    a = make_training_batch(torch.Generator().manual_seed(5), cplx, cfg,
                            device="cpu")
    torch.manual_seed(123)
    b = make_training_batch(torch.Generator().manual_seed(5), cplx, cfg,
                            device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- the scoring path, the loss and its gradient ----

@pytest.mark.parametrize("engine", ["dft_fused", "xla"])
def test_complex_scores_match_jax(setup, engine):
    cfg, jcfg = (c.replace(fft_impl=engine) for c in (setup["cfg"],
                                                      setup["jcfg"]))
    jb, b = setup["jbatch"], setup["batch"]
    model = setup["tr"].bind(setup["params"])
    for i in range(cfg.batch_complexes):
        want = jscoring.complex_scores(setup["jt"].model, jcfg,
                                       setup["state"].params,
                                       *(f[i] for f in jb[:8]))
        with torch.no_grad():
            got = complex_scores(model, cfg, *(f[i] for f in b[:8]))
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_unported_modes_raise(setup):
    """The modes that raised before ``grids/rotate`` and the block engine
    were ported score as the JAX package does: ``complex_scores`` under
    ``resample``, and ``score_decoys_resplat(fft_impl="block")`` (block
    8 at grid 16) on the decoys of each complex."""
    jb, b = setup["jbatch"], setup["batch"]
    model = setup["tr"].bind(setup["params"])
    for mode in (dict(sweep_mode="resample"),
                 dict(fft_impl="block", fft_block=8)):
        cfg, jcfg = (c.replace(**mode) for c in (setup["cfg"],
                                                 setup["jcfg"]))
        for i in range(cfg.batch_complexes):
            want = jscoring.complex_scores(setup["jt"].model, jcfg,
                                           setup["state"].params,
                                           *(f[i] for f in jb[:8]))
            with torch.no_grad():
                got = complex_scores(model, cfg, *(f[i] for f in b[:8]))
            np.testing.assert_allclose(
                np_(got), np.asarray(want), rtol=1e-4,
                atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("after", [0, 2])
def test_loss_and_grads_match_jax(setup, jax_steps, after):
    """At the initial params (the hybrid model's learned channels start
    uncoupled, so only the coupling has a gradient) and after two JAX
    steps (every leaf has one)."""
    jparams = jax_steps[after].params
    (jloss, jacc), jgrads = setup["vg"](jparams, setup["jbatch"])
    loss, acc, grads = setup["tr"].value_and_grad(_to_port(jparams),
                                                  setup["batch"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=0, atol=1e-6)
    assert 0.0 < float(jloss) and 0.0 < float(jacc) < 1.0
    _assert_grads(grads, _to_port(jgrads))
    nonzero = {k for k, g in grads.items() if float(g.abs().max()) > 0}
    assert nonzero == ({"coupling"} if after == 0 else set(grads))


# ---- the optimizer ----

def test_learning_rate_is_optax_cosine():
    cfg = _cfg(learning_rate=1e-3, lr_decay_steps=100)
    lr = learning_rate(cfg)
    sched = optax.cosine_decay_schedule(1e-3, 100, alpha=0.1)
    for t in (0, 1, 37, 99, 100, 101, 250):
        np.testing.assert_allclose(lr(t), float(sched(t)), rtol=1e-6)
    assert lr(250) == pytest.approx(1e-4)          # flat past T, not back up
    assert learning_rate(cfg.replace(lr_decay_steps=0))(7) == 1e-3


@pytest.mark.parametrize("wd,decay_steps", [(0.0, 0), (1e-2, 1)])
def test_optimizer_matches_optax_on_jax_grads(setup, wd, decay_steps):
    """Three updates on JAX's own gradients (scaled per step), Adam
    (constant rate) and AdamW with the cosine schedule across T."""
    cfg = setup["cfg"].replace(weight_decay=wd, lr_decay_steps=decay_steps)
    opt = jtrainer.Trainer(jax_config(cfg)).optimizer
    p, g0 = setup["state"].params, setup["grads"]
    s = opt.init(p)
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()._replace(params=_to_port(p))
    for k, scale in enumerate((1.0, -0.5, 2.0)):
        g = jax.tree_util.tree_map(lambda x: x * scale, g0)
        upd, s = opt.update(g, s, p)
        p = optax.apply_updates(p, upd)
        state = tr.apply_gradients(state, _to_port(g))
        assert state.opt_state["count"] == k + 1
        want = _to_port(p)
        for name in want:
            np.testing.assert_allclose(np_(state.params[name]),
                                       np_(want[name]), rtol=0, atol=1e-6,
                                       err_msg=name)


def test_train_step_matches_jax(setup, jax_steps):
    state = setup["tr"].init_state()._replace(params=setup["params"])
    new, metrics = setup["tr"].train_step(state, setup["batch"])
    np.testing.assert_allclose(float(metrics["loss"]), setup["loss"],
                               rtol=1e-4)
    assert new.step == 1 and new.opt_state["count"] == 1
    _assert_params_after_step(new.params, _to_port(jax_steps[1].params),
                              _to_port(setup["grads"]), LR)


def test_train_state_from_jax_continues(setup, jax_steps, tmp_path):
    """The JAX state after 2 steps, saved by the JAX trainer (Orbax) and
    restored by the port's reader, then one more step on each side."""
    setup["jt"].save(str(tmp_path), jax_steps[2])
    state = checkpoint.load_train_state(str(tmp_path))
    assert state.step == state.opt_state["count"] == 2 and state.rng is None
    assert os.path.isdir(tmp_path / "step_00000002")
    for name, v in _to_port(jax_steps[2].params).items():
        assert torch.equal(state.params[name], v)
    opt = jax_steps[2].opt_state[0]                    # ScaleByAdamState
    for part in ("mu", "nu"):
        for name, v in _to_port(getattr(opt, part)).items():
            assert torch.equal(state.opt_state[part][name], v)
    new, _ = setup["tr"].train_step(state, setup["batch"])
    want = _to_port(jax_steps[3].params)
    for name in want:
        np.testing.assert_allclose(np_(new.params[name]), np_(want[name]),
                                   rtol=0, atol=1e-2 * LR, err_msg=name)


def test_resume_is_bit_equal(setup, tmp_path):
    tr, batch = setup["tr"], setup["batch"]
    s0 = tr.init_state(seed=4)
    straight = tr.train_step(tr.train_step(s0, batch)[0], batch)[0]
    s1 = tr.train_step(s0, batch)[0]
    tr.save(str(tmp_path), s1)
    back = Trainer(setup["cfg"], device="cpu").restore(str(tmp_path))
    assert back.step == 1 and torch.equal(back.rng, s1.rng)
    resumed = tr.train_step(back, batch)[0]
    assert resumed.step == straight.step == 2
    for part in ("mu", "nu"):
        for k, v in straight.opt_state[part].items():
            assert torch.equal(resumed.opt_state[part][k], v)
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v)
    assert os.path.exists(tmp_path / "config.json")
    assert DockConfig.from_json(
        (tmp_path / "config.json").read_text()) == setup["cfg"]


def test_mining_then_train_step(mining):
    """A sweep (inference mode, cached correlators) before a train step
    hands the step no inference tensor."""
    cfg, cplx, tr, params, _, _ = mining
    state = tr.init_state()._replace(params=params)
    mined = tmining.mine_hard_negatives(tr.bind(state.params), cfg, cplx,
                                        n_rotations=4, top_k=4)
    b = make_training_batch(torch.Generator().manual_seed(2), cplx, cfg,
                            mined=mined, device="cpu")
    new, m = tr.train_step(state, b)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(new.params[k], params[k]) for k in params)


def test_load_mined_v9p_buffer_equal():
    path = os.path.join(V9P_DIR, "mined.npz")
    got, want = tmining.load_mined(path), jmining.load_mined(path)
    assert set(got) == set(want) and len(got) > 0
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(np_(g), np.asarray(w))


def test_merge_mined_accumulates_and_caps(tmp_path):
    def ds(n, tag):
        return tdecoys.DecoySet(torch.eye(3).expand(n, 3, 3),
                                torch.full((n, 3), tag),
                                torch.full((n,), tag))
    buf = tmining.merge_mined(None, {"a": ds(4, 1.0)})
    buf = tmining.merge_mined(buf, {"a": ds(4, 2.0), "b": ds(2, 3.0)})
    assert len(buf["a"].lrmsd) == 8 and len(buf["b"].lrmsd) == 2
    assert set(buf["a"].lrmsd.tolist()) == {1.0, 2.0}
    buf = tmining.merge_mined(buf, {"a": ds(4, 4.0)}, cap=6)
    assert len(buf["a"].lrmsd) == 6
    assert buf["a"].lrmsd[-1] == 4.0 and 1.0 not in buf["a"].lrmsd[2:]
    path = str(tmp_path / "m.npz")
    tmining.save_mined(path, buf)
    back = jmining.load_mined(path)          # the JAX package reads it
    for name in buf:
        for g, w in zip(buf[name], back[name]):
            np.testing.assert_array_equal(np_(g), np.asarray(w))


def test_trainer_defaults_to_the_card():
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    for fn in (train_flagship.run, train_flagship.val_global_hits,
               make_training_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds on it")
    with pytest.raises((AssertionError, RuntimeError)):
        Trainer(_cfg())


# ---- the flagship driver ----

def _flagship_env(**kw):
    env = dict(TF_GRID="24", TF_SEEDS="2", TF_FEATURES="4",
               TF_MINE_EVERY="1", TF_MINE_CHUNK="1", TF_NROT_MINE="4",
               TF_VAL_EVERY="1", TF_VAL_NROT="4", TF_VAL_COMPLEXES="1",
               TF_EMA="0.9")
    env.update(kw)
    return env


def test_train_flagship_resume_is_bit_equal(tmp_path, monkeypatch):
    """Grid 24 (the smallest box that holds the training band's ligands
    at 1.25 A): 2 straight steps, against 1 step, stop, resume, 1 step
    under the first run's config.  As in the JAX script, whose
    checkpoints keep the run's first key, the resumed step draws the
    run's first batch again, and it starts from the params and Adam
    moments the stopped run saved, bit for bit."""
    drawn, stepped = [], []
    make_batch = train_flagship.make_training_batch
    train_step = Trainer.train_step

    def spy_batch(gen, *a, **kw):
        drawn.append(gen.get_state().clone())
        return make_batch(gen, *a, **kw)

    def spy_step(self, state, batch):
        out = train_step(self, state, batch)
        stepped.append((state, out[0]))
        return out

    monkeypatch.setattr(train_flagship, "make_training_batch", spy_batch)
    monkeypatch.setattr(Trainer, "train_step", spy_step)
    s = train_flagship.settings_from_env(_flagship_env())
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ev_a = train_flagship.run(2, a, s, device="cpu")
    os.makedirs(b)
    with open(os.path.join(a, "config.json")) as f:
        cfg_text = f.read()
    with open(os.path.join(b, "config.json"), "w") as f:
        f.write(cfg_text)
    ev_b = train_flagship.run(1, b, s, device="cpu")
    ev_b += train_flagship.run(2, b, s, device="cpu")
    kinds = [e["event"] for e in ev_a]
    assert kinds == ["val", "train_step", "val", "mine", "train_step", "val"]
    assert [e["event"] for e in ev_b] == kinds
    # Draws: a0, a1 (straight), b0 (before the stop), b1 (resumed).
    assert len(drawn) == 4
    a0, a1, b0, b1 = drawn
    assert torch.equal(a0, b0) and torch.equal(b1, a0)
    assert not torch.equal(a1, a0)
    # The resumed step starts from the stopped run's state, bit for bit.
    saved, resumed = stepped[2][1], stepped[3][0]
    assert resumed.step == saved.step == 1
    assert resumed.opt_state["count"] == saved.opt_state["count"] == 1
    for k in saved.params:
        assert torch.equal(resumed.params[k], saved.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(resumed.opt_state[m][k],
                               saved.opt_state[m][k]), (m, k)
    # The straight run's first step and the stopped run's are one step.
    for k in saved.params:
        assert torch.equal(stepped[0][1].params[k], saved.params[k]), k
    steps = [e for e in ev_a if e["event"] == "train_step"]
    assert steps[0]["loss"] == next(
        e["loss"] for e in ev_b if e["event"] == "train_step")
    assert all(np.isfinite(e["loss"]) and e["seconds"] > 0 for e in steps)
    cfg = DockConfig.from_json(cfg_text)
    assert cfg.lig_grid_size == 24 and cfg.lr_decay_steps == 2
    ta, tb = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    for sub in ("", "ema", "best"):
        x, y = (t.restore(os.path.join(d, sub)) for t, d in ((ta, a),
                                                               (tb, b)))
        assert x.step == y.step
        # Every checkpoint keeps the run's first generator state.
        assert torch.equal(x.rng, a0) and torch.equal(y.rng, a0), sub
    assert ta.restore(a).step == 2
    for d in (a, b):
        assert os.path.exists(os.path.join(d, "mined.npz"))
        assert os.path.exists(os.path.join(d, "TRAINING.json"))
    # Nothing left to train: a rerun restores and stops.
    assert [e["event"] for e in train_flagship.run(
        2, a, s, device="cpu")] == []


def test_flagship_settings_and_main(monkeypatch):
    s = train_flagship.settings_from_env({})
    assert (s["grid"], s["mine_every"], s["features"]) == (64, 50, (32, 14))
    cfg = train_flagship.recipe_config(s, 3000)
    assert (cfg.num_decoys, cfg.batch_complexes, cfg.lr_decay_steps,
            cfg.weight_decay, cfg.rotation_chunk) == (24, 2, 3000, 1e-4, 16)
    seen = []
    monkeypatch.setattr(train_flagship, "run",
                        lambda *a, **kw: seen.append((a, kw)) or [])
    monkeypatch.setenv("TF_GRID", "32")
    train_flagship.main(["5", "out_dir"])
    (steps, ckpt, settings), kw = seen[0]
    assert (steps, ckpt, settings["grid"], kw["device"]) == (
        5, "out_dir", 32, "cuda")
    train_flagship.main(["--device", "cpu"])
    assert seen[1][0][:2] == (1500, train_flagship.DEFAULT_CKPT)
    assert seen[1][1]["device"] == "cpu"
