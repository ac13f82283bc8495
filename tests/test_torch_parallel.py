"""Torch port vs JAX package: the multi-device layer.

The port's ranks are ``torch.distributed`` gloo processes on the CPU,
spawned by ``tests/torch_dist_workers.py`` (a JAX-free module): one world
of 4 ranks and one of 2, each running every check of its size once.  The
JAX side runs here on the conftest's virtual 8-device CPU mesh
(``make_mesh(..., devices=jax.devices()[:n])``).  Every rank must return
the same result, bit for bit (the merge runs on the same gathered
tensors), and that result is held against the JAX package's sharded one
and the port's unsharded one.

Tolerances: float32 scores rtol 1e-4 with ``rot_idx`` and shifts equal
(the inputs are random: no tied values); block-correlation slabs rtol
1e-5; the train step's loss rtol 1e-4 and params after it rtol 2e-3,
atol 2e-5 (``tests/test_parallel.py``'s own).  The CLI's ``dock``,
``evaluate``, ``screen`` and ``train`` on two ranks are held against
``--mesh-rot 1`` in one process: scores rtol 1e-5, params after
training at the train step's tolerances.
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import torch_dist_workers as W
from torch_parity import np_, t_

from deeplocalproteindocking_torch import cli as tcli
from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.correlate.blockfft import (
    block_correlate_scores)
from deeplocalproteindocking_torch.parallel import make_mesh
from deeplocalproteindocking_torch.parallel.batch_eval import dock_batch
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.docker import dock_sweep
from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat
from deeplocalproteindocking_torch.train.trainer import TrainBatch
from deeplocalproteindocking_tpu import evaluation as jev
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.config import DockConfig as JDockConfig
from deeplocalproteindocking_tpu.correlate import blockfft as jblock
from deeplocalproteindocking_tpu.correlate.fft import (
    receptor_transform as j_receptor_transform)
from deeplocalproteindocking_tpu.data import synthetic_complex as j_synth
from deeplocalproteindocking_tpu.grids import voxelize as jvox
from deeplocalproteindocking_tpu.parallel import batch_eval as jbe
from deeplocalproteindocking_tpu.parallel import sharded_sweep as jss
from deeplocalproteindocking_tpu.parallel.mesh import make_mesh as j_mesh
from deeplocalproteindocking_tpu.parallel.train_parallel import (
    make_parallel_train_step as j_parallel_step)
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations as j_rotations)
from deeplocalproteindocking_tpu.train import data_gen as jdata
from deeplocalproteindocking_tpu.train import trainer as jtrainer



def _jmesh(rot=1, batch=1):
    return j_mesh(rot=rot, batch=batch,
                  devices=jax.devices()[:rot * batch])


def _same_on_every_rank(results):
    for r in results[1:]:
        for a, b in zip(jax.tree.leaves(results[0]), jax.tree.leaves(r)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _assert_dock_equal(got, want, rtol=1e-4):
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), rtol=rtol,
                               atol=1e-6)
    np.testing.assert_array_equal(np_(got[1]), np_(want[1]))
    np.testing.assert_array_equal(np_(got[2]), np_(want[2]))


# ---- the ranks: one world of 4 and one of 2 ----

def _jax_train_setup():
    """``tests/test_parallel.py``'s train step set-up on the JAX side."""
    jcfg = JDockConfig.from_json(W.train_cfg().to_json())
    jt = jtrainer.Trainer(jcfg)
    state = jt.init_state()
    cplxs = [j_synth(seed=s, n_res_rec=5, n_res_lig=3) for s in range(2)]
    batch = jdata.make_training_batch(jax.random.key(0), cplxs, jcfg)
    return jt, state, batch


@pytest.fixture(scope="module")
def train_setup():
    return _jax_train_setup()


@pytest.fixture(scope="module")
def cli_dataset(tmp_path_factory):
    """Two complexes written by the CLI, and the ``dock``, ``evaluate``
    and ``screen`` command lines on them (without ``--out`` and
    ``--mesh-rot``)."""
    root = tmp_path_factory.mktemp("cli")
    ds = root / "ds"
    tcli.main(["generate-dataset", "--out", str(ds), "--num-complexes",
               "2"])
    rec, lig, lig1 = (str(ds / f"synth{n}_{s}_u.pdb")
                      for n, s in ((0, "r"), (0, "l"), (1, "l")))
    small = ["--grid-size", "32", "--num-rotations", "12", "--top-k", "8",
             "--device", "cpu"]
    return root, {
        "dock": ["dock", "--receptor", rec, "--ligand", lig] + small,
        "evaluate": ["evaluate", "--data-dir", str(ds), "--batch-size",
                     "2"] + small,
        "screen": ["screen", "--receptor", rec, "--ligands",
                   f"{lig1},{lig}", "--rescore-top", "2"] + small}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, train_setup, cli_dataset):
    """Both worlds started at once; the JAX side computes while they
    run."""
    tmp4 = str(tmp_path_factory.mktemp("world4"))
    jt, state, batch = train_setup
    jt.save(tmp4, state)
    np.savez(os.path.join(tmp4, "train_batch.npz"),
             **{f: np.asarray(v) for f, v in zip(TrainBatch._fields, batch)})
    tmp2 = str(tmp_path_factory.mktemp("world2"))
    root, argv = cli_dataset
    with open(os.path.join(tmp2, "cli_argv.json"), "w") as f:
        json.dump({cmd: a + ["--mesh-rot", "2", "--out",
                             str(root / f"{cmd}_mesh2")]
                   for cmd, a in argv.items()}, f)
    ranks = {4: W.Ranks("world4", 4, tmp4), 2: W.Ranks("world2", 2, tmp2)}
    yield ranks
    for r in ranks.values():
        r.stop()


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4].tmp, worlds[4].result()


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2].tmp, worlds[2].result()


def _world(request, R):
    return request.getfixturevalue("world4" if R == 4 else "world2")[1]


# ---- rotation-sharded sweeps ----

@pytest.fixture(scope="module")
def jax_sweeps(worlds):
    """JAX's sharded sweeps at R = 2 and 4, and the port's unsharded
    (computed while the ranks run)."""
    rec_xyz, rec_t, lc, lt, lm, mask = W.resplat_inputs()
    vol = jvox.separable_splat(jnp.asarray(rec_xyz) + 1.0,
                               jnp.asarray(rec_t), jnp.ones(12),
                               grid_size=W.SWEEP_L, resolution=1.0,
                               num_types=W.SWEEP_C)
    H = j_receptor_transform(vol)
    rots = j_rotations(W.SWEEP_NROT)
    rec, lig, A = W.resample_inputs()
    rs_mask = mask[:W.RS_L, :W.RS_L, :W.RS_L]
    jax_out, port_out = {}, {}
    for R in (2, 4):
        mesh = _jmesh(rot=R)
        for name, sm in (("resplat", None), ("resplat_masked", mask)):
            jax_out[R, name] = jss.sharded_dock_sweep_resplat(
                mesh, H, jnp.asarray(lc), jnp.asarray(lt), jnp.asarray(lm),
                rots, lambda v: v,
                score_mask=None if sm is None else jnp.asarray(sm),
                **W.sweep_kw())
        jax_out[R, "resample"] = jss.sharded_dock_sweep(
            mesh, jnp.asarray(rec), jnp.asarray(lig), rots, jnp.asarray(A),
            top_k=16, chunk=W.SWEEP_CHUNK, score_mask=jnp.asarray(rs_mask))
    Ht = W.receptor_spectrum(rec_xyz, rec_t, W.SWEEP_L, W.SWEEP_C)
    trots = super_fibonacci_rotations(W.SWEEP_NROT)
    for name, sm in (("resplat", None), ("resplat_masked", t_(mask))):
        port_out[name] = dock_sweep_resplat(
            Ht, t_(lc), t_(lt), t_(lm), trots, lambda v: v, score_mask=sm,
            **W.sweep_kw())
    port_out["resample"] = dock_sweep(
        t_(rec), t_(lig), trots, t_(A), top_k=16, chunk=W.SWEEP_CHUNK,
        score_mask=t_(rs_mask))
    return jax_out, port_out


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("kind", ["resplat", "resplat_masked", "resample"])
def test_sharded_sweep_matches_jax(request, jax_sweeps, R, kind):
    """13 rotations over R ranks in chunks of 2 (padded shards; at R = 4
    the last rank holds one real rotation): every rank returns the same
    top-K, equal to JAX's sharded sweep and to the unsharded sweep."""
    results = [r["sweeps"][kind] for r in _world(request, R)]
    _same_on_every_rank(results)
    got = results[0]
    assert int(got[1].max()) < W.SWEEP_NROT
    jax_out, port_out = jax_sweeps
    _assert_dock_equal(got, jax_out[R, kind])
    _assert_dock_equal(got, port_out[kind])


# ---- dock_batch over (rot, batch) ----

@pytest.fixture(scope="module")
def jax_dock_batch(worlds):
    xyz, types, lm, masks = W.batch_inputs()
    H = jnp.stack([j_receptor_transform(jvox.separable_splat(
        jnp.asarray(x) + 1.0, jnp.asarray(t), jnp.ones(8),
        grid_size=W.BATCH_L, resolution=1.0, num_types=3))
        for x, t in zip(xyz, types)])
    kw = dict(grid_size=W.BATCH_L, lig_grid=12, resolution=1.0, sigma=1.0,
              num_types=3, top_k=4, chunk=2, fft_impl="dft",
              score_mask=jnp.asarray(masks))
    args = (H, jnp.asarray(xyz), jnp.asarray(types), jnp.asarray(lm),
            j_rotations(W.BATCH_NROT), lambda v: v)
    return {(2, 2): jbe.dock_batch(_jmesh(2, 2), *args, **kw),
            None: jbe.dock_batch(None, *args, **kw)}


@pytest.mark.parametrize("layout", ["rot2_batch2", "rot2_batch1",
                                    "rot1_batch2"])
def test_dock_batch_mesh_matches_jax(request, jax_dock_batch, layout):
    """4 complexes, 7 rotations (uneven over rot), per-complex masks:
    every rank returns all ``[4, K]`` rows, equal to JAX's ``dock_batch``
    on a (2, 2) mesh and unsharded, and to the port's unsharded call."""
    if layout == "rot2_batch2":
        results = [r["dock_batch"] for r in request.getfixturevalue(
            "world4")[1]]
    else:
        key = "dock_batch_rot" if layout == "rot2_batch1" else \
            "dock_batch_batch"
        results = [r[key] for r in request.getfixturevalue("world2")[1]]
    _same_on_every_rank(results)
    got = results[0]
    assert got[0].shape == (4, 4)
    _assert_dock_equal(got, jax_dock_batch[(2, 2)])
    _assert_dock_equal(got, jax_dock_batch[None])
    xyz, types, lm, masks = W.batch_inputs()
    H = torch.stack([W.receptor_spectrum(x, t, W.BATCH_L, 3)
                     for x, t in zip(xyz, types)])
    want = dock_batch(H, t_(xyz), t_(types), t_(lm),
                      super_fibonacci_rotations(W.BATCH_NROT), lambda v: v,
                      grid_size=W.BATCH_L, lig_grid=12, resolution=1.0,
                      sigma=1.0, num_types=3, top_k=4, chunk=2,
                      score_mask=t_(masks), fft_impl="dft")
    _assert_dock_equal(got, want, rtol=1e-5)


# ---- the block engine's translation slabs ----

@pytest.mark.parametrize("R", [2, 4])
def test_sharded_block_correlate_slabs_match_jax(request, R):
    """Rank i returns the x slab [i L/R, (i+1) L/R) of the score volume:
    the slabs in rank order equal JAX's sharded result and the port's
    whole-grid ``block_correlate_scores``."""
    slabs = [r["block"] for r in _world(request, R)]
    assert slabs[0].shape == (W.BLOCK_L // R, W.BLOCK_L, W.BLOCK_L)
    got = torch.cat(slabs)
    rec, lig, A = W.block_inputs()
    want = jblock.sharded_block_correlate(
        _jmesh(rot=R), jnp.asarray(rec), jnp.asarray(lig), jnp.asarray(A),
        block=4)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    whole = block_correlate_scores(t_(rec), t_(lig), t_(A), block=4)
    np.testing.assert_allclose(np_(got), np_(whole), rtol=1e-5,
                               atol=1e-6 * float(whole.abs().max()))


# ---- the differentiable gather ----

def test_all_gather_backward_matches_single_process(world4):
    """``AllGather``'s forward is the rows of every rank in rank order.
    Each rank differentiates a function of its own of all rows; the
    backward gives each rank the single-process gradient of the sum of
    the ranks' functions, restricted to its own rows (the transpose of
    ``jax.lax.all_gather``)."""
    x, w = W.gather_inputs(4)
    xs = t_(x).requires_grad_(True)
    sum(W.gathered_loss(xs, t_(w), q) for q in range(4)).backward()
    for rank, (y, grad) in enumerate(r["all_gather"] for r in world4[1]):
        assert torch.equal(y, t_(x))
        rows = slice(rank * W.GATHER_N, (rank + 1) * W.GATHER_N)
        torch.testing.assert_close(grad, xs.grad[rows], rtol=1e-6,
                                   atol=1e-6)


# ---- the data-parallel train step ----

def test_parallel_train_step_matches_jax(world4, train_setup):
    """One step on a (rot=2, batch=2) mesh (2 complexes x 8 decoys) from
    the same JAX state and batch: the loss and the params after it
    against JAX's ``make_parallel_train_step`` on a (2, 2) mesh; three
    steps leave the params identical on every rank."""
    jt, state, batch = train_setup
    pstate, pmetrics = j_parallel_step(jt, _jmesh(2, 2))(state, batch)
    want = weights.params_from_numpy(
        {k: np.asarray(v)
         for k, v in flatten_dict(pstate.params, sep="/").items()})
    runs = [r["train"] for r in world4[1]]
    loss, _, params = runs[0][0]
    np.testing.assert_allclose(loss, float(pmetrics["loss"]), rtol=1e-4)
    for name, v in want.items():
        np.testing.assert_allclose(np_(params[name]), np_(v), rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    for run in runs[1:]:
        for (la, aa, pa), (lb, ab, pb) in zip(runs[0], run):
            assert (la, aa) == (lb, ab)
            for name in pa:
                assert torch.equal(pa[name], pb[name]), name


# ---- batched evaluation ----

def test_run_benchmark_batched_mesh_matches_jax(world4, tmp_path):
    """A group of 2 complexes on a (2, 2) mesh: the per-complex results
    and the summary equal JAX's ``run_benchmark_batched`` on a (2, 2)
    mesh; rank 0 alone wrote the files."""
    tmp, results = world4
    summary, writes = results[0]["run_benchmark"]
    assert writes == [c.name for c in W.bench_complexes()]
    assert all(r["run_benchmark"][1] == [] for r in results[1:])
    assert all(r["run_benchmark"][0] == summary for r in results)
    jdir = str(tmp_path / "j")
    want = jev.run_benchmark_batched(
        jpipe.DockingPipeline(
            config=JDockConfig.from_json(W.bench_cfg().to_json()),
            mesh=_jmesh(2, 2)),
        W.bench_complexes(), jdir, group_size=2)
    assert summary == want
    for c in W.bench_complexes():
        with open(os.path.join(tmp, "bench", f"{c.name}.json")) as f:
            got = json.load(f)
        with open(os.path.join(jdir, f"{c.name}.json")) as f:
            exp = json.load(f)
        assert (got["hit_top1"], got["hit_top10"], got["num_poses"]) == (
            exp["hit_top1"], exp["hit_top10"], exp["num_poses"])
        for a, b in zip(got["poses"], exp["poses"]):
            assert a["score"] == pytest.approx(b["score"], rel=1e-4,
                                               abs=1e-6)
            assert abs(a["lrmsd"] - b["lrmsd"]) < 1e-3
            assert a["capri"] == b["capri"]


# ---- ensembles and the sequential benchmark ----

@pytest.mark.parametrize("layout", [(2, 1), (1, 2)])
def test_dock_ensemble_and_run_benchmark_on_a_mesh(world2, tmp_path,
                                                   layout):
    """``dock_ensemble`` of 2 pairs on a (rot=2) mesh (rotations sharded,
    the pairs on every rank) and on a (batch=2) mesh (one pair per
    rank), and the sequential ``run_benchmark`` (every rank docks, rank
    0 writes): the same merged poses and pairs, and the same summary, as
    JAX's ``dock_ensemble`` and ``run_benchmark`` on the same mesh and
    as one process of the port without a mesh."""
    from deeplocalproteindocking_torch.evaluation import run_benchmark
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    results = [r["ensemble"][layout] for r in world2[1]]
    _same_on_every_rank([r[:2] for r in results])
    (scores, rots, trans, rot_idx, shifts), pairs, summary = results[0]
    jmesh = _jmesh(*layout)
    ref = jpipe.DockingPipeline(
        config=JDockConfig.from_json(W.ensemble_cfg().to_json()), mesh=jmesh)
    ref.params = unflatten_dict({k: jnp.asarray(v)
                                 for k, v in W.v9p_flat().items()}, sep="/")
    jwant, jpairs = ref.dock_ensemble(*W.ensemble_models())
    want, want_pairs = W.ensemble_pipeline().dock_ensemble(
        *W.ensemble_models())
    for ref_scores, ref_rot, ref_shifts, ref_pairs, rtol in (
            (jwant.scores, jwant.rot_idx, jwant.shifts, jpairs, 1e-4),
            (want.scores, want.rot_idx, want.shifts, want_pairs, 1e-5)):
        np.testing.assert_allclose(np_(scores), np_(ref_scores), rtol=rtol,
                                   atol=1e-6)
        np.testing.assert_array_equal(np_(rot_idx), np_(ref_rot))
        np.testing.assert_array_equal(np_(shifts), np_(ref_shifts))
        np.testing.assert_array_equal(np_(pairs), np_(ref_pairs))
    assert summary == jev.run_benchmark(
        jpipe.DockingPipeline(
            config=JDockConfig.from_json(W.bench_cfg().to_json()),
            mesh=jmesh),
        W.bench_complexes()[:1], str(tmp_path / "jax_seq"))
    assert summary == run_benchmark(
        DockingPipeline(W.bench_cfg(), device="cpu"),
        W.bench_complexes()[:1], str(tmp_path / "seq"))


# ---- the CLI ----

def _mesh_rot_1(cli_dataset, cmd):
    root, argv = cli_dataset
    return argv[cmd] + ["--mesh-rot", "1", "--out", str(root / f"{cmd}_1")]


def test_cli_dock_mesh_rot_2_matches_mesh_rot_1(world2, cli_dataset):
    """``dock --mesh-rot 2 --device cpu`` on two gloo ranks: both ranks
    read back rank 0's ``poses.json``, equal to ``--mesh-rot 1``'s."""
    argv = _mesh_rot_1(cli_dataset, "dock")
    tcli.main(argv)
    with open(os.path.join(argv[-1], "poses.json")) as f:
        want = json.load(f)
    got = [r["cli"] for r in world2[1]]
    assert got[0] == got[1]
    assert len(got[0]) == len(want) > 0
    np.testing.assert_allclose([p["score"] for p in got[0]],
                               [p["score"] for p in want], rtol=1e-5)
    assert [(p["rot_idx"], p["shift"]) for p in got[0]] == [
        (p["rot_idx"], p["shift"]) for p in want]


def test_cli_evaluate_mesh_rot_2_matches_mesh_rot_1(world2, cli_dataset):
    """``evaluate --batch-size 2 --mesh-rot 2`` (the batched benchmark on
    a (rot=2) mesh): rank 0 alone wrote the per-complex results, which
    with the summary equal ``--mesh-rot 1``'s."""
    results = [r["cli_evaluate"] for r in world2[1]]
    writes, want = W.cli_evaluate(_mesh_rot_1(cli_dataset, "evaluate"))
    assert results[0][0] == writes == ["synth0", "synth1"]
    assert results[1][0] == []
    got = results[0][1]
    assert results[1][1] == got
    assert sorted(got) == sorted(want) == [
        "summary.json", "synth0.json", "synth1.json"]
    for name in ("synth0.json", "synth1.json"):
        g, w = got[name], want[name]
        for k in ("hit_top1", "hit_top10", "num_poses"):
            assert g[k] == w[k], (name, k)
        for a, b in zip(g["poses"], w["poses"]):
            assert a["score"] == pytest.approx(b["score"], rel=1e-5,
                                               abs=1e-6)
            assert a["capri"] == b["capri"]
        np.testing.assert_allclose(g["best_lrmsd"], w["best_lrmsd"],
                                   rtol=1e-4, atol=1e-3)
    for k in ("num_complexes", "top1_hit_rate", "top10_hit_rate"):
        assert got["summary.json"][k] == want["summary.json"][k], k


def test_cli_screen_mesh_rot_2_matches_mesh_rot_1(world2, cli_dataset):
    """``screen --mesh-rot 2`` (the dock stage sharded, the rescore
    replicated): both ranks read back rank 0's ``screen.json``, whose
    cache counts, ligand order and poses equal ``--mesh-rot 1``'s."""
    got = [r["cli_screen"] for r in world2[1]]
    want = W.cli_screen(_mesh_rot_1(cli_dataset, "screen"))
    assert got[0] == got[1]
    assert got[0]["cache"] == want["cache"]
    assert [r["ligand"] for r in got[0]["ranking"]] == [
        r["ligand"] for r in want["ranking"]]
    for r, w in zip(got[0]["ranking"], want["ranking"]):
        np.testing.assert_allclose(r["best_score"], w["best_score"],
                                   rtol=1e-5)
        assert [p["shift"] for p in r["poses"]] == [
            p["shift"] for p in w["poses"]]


def test_cli_train_mesh_rot_2_matches_mesh_rot_1(world2, tmp_path):
    """``train --mesh-rot 2`` (6 decoys, 3 a rank) to step 1, then
    ``--resume`` to step 2, mining before each step on rank 0: rank 0
    alone checkpointed and opened ``train.jsonl``, whose events equal
    ``--mesh-rot 1``'s; both ranks end with identical params, equal to
    ``--mesh-rot 1``'s within the train step's tolerances."""
    tmp, results = world2
    (saved0, logs0, p0), (saved1, logs1, p1) = (r["cli_train"]
                                                for r in results)
    saved, logs, want = W.cli_train(str(tmp_path / "one"), 1)
    assert saved0 == saved == [1, 2] and saved1 == []
    assert logs0 == [os.path.join(tmp, "train", "train.jsonl")] * 2
    assert logs1 == [None, None]

    def events(d):
        with open(os.path.join(d, "train.jsonl")) as f:
            return [(r["event"], r["step"]) for r in map(json.loads, f)]

    assert events(os.path.join(tmp, "train")) == events(
        str(tmp_path / "one")) == [("mined_hard_negatives", 0),
                                   ("train_step", 0),
                                   ("mined_hard_negatives", 1),
                                   ("train_step", 1)]
    for name, v in want.items():
        assert torch.equal(p0[name], p1[name]), name
        np.testing.assert_allclose(np_(p0[name]), np_(v), rtol=2e-3,
                                   atol=2e-5, err_msg=name)


# ---- errors ----

@pytest.mark.parametrize("case,match", [
    ("world", r"ValueError: mesh rot=3 x batch=1 needs 3 ranks, the process "
              r"group has 4; run `torchrun --nproc-per-node 3"),
    ("dock_batch", r"ValueError: dock_batch: 3 complexes do not divide over "
                   r"mesh batch=2"),
    ("train_decoys", r"ValueError: .*6 decoys do not divide over mesh rot=4"),
    ("train_batch", r"ValueError: .*batch of 2 complexes does not divide "
                    r"over mesh batch=4"),
    ("block", r"ValueError: L/block=2 slabs must divide 4 devices")])
def test_mesh_errors(world4, case, match):
    """Each raises on every rank, before any collective."""
    for r in world4[1]:
        assert re.match(match, r["errors"][case]), r["errors"][case]


def test_mesh_without_process_group_raises():
    with pytest.raises(RuntimeError,
                       match="no process group exists; run `torchrun "
                             "--nproc-per-node 2"):
        make_mesh(rot=2, device_type="cpu")
