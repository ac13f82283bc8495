"""Torch port's CLI (``python -m deeplocalproteindocking_torch.cli``)
against the JAX package's CLI, in process through each ``main([...])``,
on the CPU at small sizes.

``generate-dataset`` byte for byte; ``dock`` with the v9p checkpoint
(both CLIs restore the Orbax steps of ``best/``: the step-500 weights;
the port without JAX) at float32, poses.json's scores
within the float32 tolerance of ``test_torch_pipeline.py`` (rtol 1e-4,
atol 1e-3) and the same top-1 shift and rotation; ``screen``'s ranking
and ``evaluate``'s per-complex hit decisions against the JAX CLI's
files; ``train`` and ``--resume`` (a resumed run draws the run's first
batch again, as the JAX CLI does); the port's own error paths, and
``doctor``/``info``.
"""
import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_parity import V9P_CKPT, V9P_DIR

from deeplocalproteindocking_torch import cli as tcli
from deeplocalproteindocking_torch.train import data_gen as tdata
from deeplocalproteindocking_torch.train.trainer import Trainer
from deeplocalproteindocking_tpu import cli as jcli

CPU = ["--device", "cpu"]
SMALL = ["--grid-size", "32", "--num-rotations", "8", "--top-k", "8"]


def _files(d):
    return sorted(f for f in os.listdir(d))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two polymer complexes (unbound 1.2 A) written by the port's CLI,
    and the same written by the JAX CLI."""
    root = tmp_path_factory.mktemp("ds")
    args = ["--num-complexes", "2", "--backbone", "--unbound-rmsd", "1.2"]
    tcli.main(["generate-dataset", "--out", str(root / "port")] + args)
    jcli.main(["generate-dataset", "--out", str(root / "jax")] + args)
    return str(root / "port"), str(root / "jax")


def test_generate_dataset_bytes_equal_jax(dataset):
    port, jax_dir = dataset
    assert _files(port) == _files(jax_dir) == [
        "synth0_l_u.pdb", "synth0_r_u.pdb", "synth1_l_u.pdb",
        "synth1_r_u.pdb"]
    for f in _files(port):
        with open(os.path.join(port, f), "rb") as a, \
                open(os.path.join(jax_dir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_generate_dataset_decoys_layout_and_labels(tmp_path):
    """The same keys, shapes and dtypes as the JAX CLI's file; decoy 0 is
    the native pose, and every label is the JAX package's LRMSD of the
    port's own samples."""
    import jax.numpy as jnp
    from deeplocalproteindocking_tpu.data.benchmark import synthetic_complex
    from deeplocalproteindocking_tpu.structure.transforms import apply_pose
    from deeplocalproteindocking_tpu.train.data_gen import native_voxel_shift
    from deeplocalproteindocking_tpu.utils.rmsd import rmsd
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tcli.main(["generate-dataset", "--out", a, "--num-complexes", "1",
               "--seed", "4", "--decoys", "8"])
    jcli.main(["generate-dataset", "--out", b, "--num-complexes", "1",
               "--seed", "4", "--decoys", "8"])
    assert _files(a) == _files(b)
    got, want = (np.load(os.path.join(d, "synth4_decoys.npz"))
                 for d in (a, b))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert got["lrmsd"][0] < 1e-4
    c = synthetic_complex(seed=4)
    lig = c.ligand.centered().typed()
    x = jnp.asarray(lig.coords)
    native = x + jnp.asarray(native_voxel_shift(c, 1.25), jnp.float32) * 1.25
    posed = apply_pose(x[None], jnp.asarray(got["rotations"]),
                       jnp.asarray(got["shifts"], jnp.float32) * 1.25)
    labels = rmsd(posed, native[None], jnp.ones(posed.shape[:-1]))
    np.testing.assert_allclose(got["lrmsd"], np.asarray(labels), rtol=1e-5,
                               atol=1e-5)


def _poses(d):
    with open(os.path.join(d, "poses.json")) as f:
        return json.load(f)


def test_dock_v9p_matches_jax_cli(dataset, tmp_path):
    port_ds, _ = dataset
    rec, lig = (os.path.join(port_ds, f"synth0_{s}_u.pdb") for s in "rl")
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    flags = ["--receptor", rec, "--ligand", lig, "--num-rotations", "16",
             "--top-k", "8", "--num-out", "2"]
    tcli.main(["dock", "--out", a, "--checkpoint", V9P_CKPT] + flags + CPU)
    jcli.main(["dock", "--out", b, "--checkpoint", V9P_CKPT] + flags)
    got, want = _poses(a), _poses(b)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose([p["score"] for p in got],
                               [p["score"] for p in want], rtol=1e-4,
                               atol=1e-3)
    assert (got[0]["shift"], got[0]["rot_idx"]) == (
        want[0]["shift"], want[0]["rot_idx"])
    assert _files(a) == _files(b)
    with open(os.path.join(a, "pose_000.pdb")) as f, \
            open(os.path.join(b, "pose_000.pdb")) as g:
        pa = np.array([[float(l[30:38]), float(l[38:46]), float(l[46:54])]
                       for l in f if l.startswith("ATOM")])
        pb = np.array([[float(l[30:38]), float(l[38:46]), float(l[46:54])]
                       for l in g if l.startswith("ATOM")])
    np.testing.assert_allclose(pa, pb, atol=2e-3)


def test_screen_ranking_matches_jax_cli(dataset, tmp_path):
    port_ds, _ = dataset
    rec = os.path.join(port_ds, "synth0_r_u.pdb")
    ligs = ",".join(os.path.join(port_ds, f"synth{i}_l_u.pdb")
                    for i in (1, 0))
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    flags = ["--receptor", rec, "--ligands", ligs, "--rescore-top", "2"]
    tcli.main(["screen", "--out", a] + flags + SMALL + CPU)
    jcli.main(["screen", "--out", b] + flags + SMALL)
    got, want = (json.load(open(os.path.join(d, "screen.json")))
                 for d in (a, b))
    # One receptor preparation; the second ligand and both rescores hit.
    assert got["cache"] == want["cache"] == dict(entries=1, hits=3,
                                                 misses=1)
    assert [r["ligand"] for r in got["ranking"]] == [
        r["ligand"] for r in want["ranking"]]
    for r, w in zip(got["ranking"], want["ranking"]):
        np.testing.assert_allclose(r["best_score"], w["best_score"],
                                   rtol=1e-4, atol=1e-3)
        assert r["poses"][0]["shift"] == w["poses"][0]["shift"]


@pytest.mark.parametrize("batch", [1, 2])
def test_evaluate_data_dir_hits_match_jax_cli(dataset, tmp_path, batch):
    port_ds, _ = dataset
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    flags = ["--data-dir", port_ds, "--batch-size", str(batch)] + SMALL
    tcli.main(["evaluate", "--out", a] + flags + CPU)
    jcli.main(["evaluate", "--out", b] + flags)
    for name in ("synth0", "synth1"):
        got, want = (json.load(open(os.path.join(d, f"{name}.json")))
                     for d in (a, b))
        for k in ("hit_top1", "hit_top10", "num_poses"):
            assert got[k] == want[k], (name, k)
        assert ([g["capri"] for g in got["poses"]]
                == [g["capri"] for g in want["poses"]])
        np.testing.assert_allclose(got["best_lrmsd"], want["best_lrmsd"],
                                   rtol=1e-4, atol=1e-3)
    sa, sb = (json.load(open(os.path.join(d, "summary.json")))
              for d in (a, b))
    assert sa["num_complexes"] == sb["num_complexes"] == 2
    assert (sa["top1_hit_rate"], sa["top10_hit_rate"]) == (
        sb["top1_hit_rate"], sb["top10_hit_rate"])


def test_train_resume_draws_the_first_batch_again(tmp_path, monkeypatch):
    """A straight run of 2 steps against 1 step, stop, ``--resume`` to 2:
    the resumed step draws the run's first batch again (the JAX CLI's
    checkpoints keep the run's first key) from the stopped run's params
    and Adam moments, bit for bit; a checkpoint then docks."""
    drawn, stepped = [], []
    make_batch = tdata.make_training_batch
    train_step = Trainer.train_step

    def spy_batch(gen, *a, **kw):
        drawn.append(gen.get_state().clone())
        return make_batch(gen, *a, **kw)

    def spy_step(self, state, batch):
        out = train_step(self, state, batch)
        stepped.append((state, out[0]))
        return out

    monkeypatch.setattr(tdata, "make_training_batch", spy_batch)
    monkeypatch.setattr(Trainer, "train_step", spy_step)
    # A narrow model and few decoys (no flag sets them): seconds a step.
    build = tcli._build_config
    monkeypatch.setattr(tcli, "_build_config", lambda args: build(
        args).replace(rep_features=(4,), num_decoys=6))
    base = ["train", "--synthetic", "2", "--grid-size", "32",
            "--resolution", "2.0", "--ckpt-every", "1"] + CPU
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tcli.main(base + ["--ckpt-dir", a, "--steps", "2"])
    tcli.main(base + ["--ckpt-dir", b, "--steps", "1"])
    tcli.main(base + ["--ckpt-dir", b, "--steps", "2", "--resume"])
    a0, a1, b0, b1 = drawn
    assert torch.equal(a0, b0) and torch.equal(b1, a0)
    assert not torch.equal(a1, a0)
    saved, resumed = stepped[2][1], stepped[3][0]
    assert resumed.step == saved.step == 1
    for k in saved.params:
        assert torch.equal(resumed.params[k], saved.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(resumed.opt_state[m][k],
                               saved.opt_state[m][k]), (m, k)
    logs = [json.loads(l) for l in open(os.path.join(b, "train.jsonl"))]
    assert [r["step"] for r in logs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in logs)
    assert sorted(d for d in os.listdir(b) if d.startswith("step_")) == [
        "step_00000001", "step_00000002"]
    # The trained checkpoint's state.pt docks.
    ds = str(tmp_path / "ds")
    tcli.main(["generate-dataset", "--out", ds, "--num-complexes", "1"])
    out = str(tmp_path / "poses")
    tcli.main(["dock", "--receptor", f"{ds}/synth0_r_u.pdb", "--ligand",
               f"{ds}/synth0_l_u.pdb", "--out", out, "--checkpoint", b,
               "--grid-size", "32", "--resolution", "2.0",
               "--num-rotations", "4", "--top-k", "4"] + CPU)
    assert len(_poses(out)) >= 1


def test_dock_ensemble_profile_and_debug_nans(dataset, tmp_path):
    """``--ensemble product --max-models 2`` on a two-model file against
    the JAX CLI; ``--profile`` writes a trace; ``--debug-nans`` passes a
    finite dock."""
    port_ds, _ = dataset
    lig = os.path.join(port_ds, "synth0_l_u.pdb")
    rec = os.path.join(port_ds, "synth0_r_u.pdb")
    two = str(tmp_path / "two.pdb")
    with open(lig) as f:
        body = [l for l in f if l.startswith("ATOM")]
    shifted = [l[:30] + f"{float(l[30:38]) + 0.5:8.3f}" + l[38:]
               for l in body]
    with open(two, "w") as f:
        f.write("MODEL        1\n" + "".join(body) + "ENDMDL\n"
                "MODEL        2\n" + "".join(shifted) + "ENDMDL\nEND\n")
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    flags = ["--receptor", rec, "--ligand", two, "--ensemble", "product",
             "--max-models", "2"] + SMALL
    prof = str(tmp_path / "trace")
    tcli.main(["dock", "--out", a, "--profile", prof, "--debug-nans"]
              + flags + CPU)
    jcli.main(["dock", "--out", b] + flags)
    got, want = _poses(a), _poses(b)
    assert len(got) == len(want)
    np.testing.assert_allclose([p["score"] for p in got],
                               [p["score"] for p in want], rtol=1e-4,
                               atol=1e-3)
    assert {(p["receptor_model"], p["ligand_model"]) for p in got} <= {
        (1, 1), (1, 2)}
    assert (got[0]["ligand_model"], got[0]["shift"]) == (
        want[0]["ligand_model"], want[0]["shift"])
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(prof, traces[0])) as f:
        assert "traceEvents" in json.load(f)


def test_stage_timer_and_untraced_region():
    """The port's stage timing is ``span`` (the stage timer it replaced
    had no user): host time and counts in the open root's record, no
    profiler range while none records; ``maybe_trace(None)`` runs its
    region untraced."""
    from deeplocalproteindocking_torch.utils.profiling import (
        maybe_trace, request_log, span)
    x = torch.ones(3)
    with span("stage", root=True):
        for _ in range(2):
            with span("stage.a"):
                x = x + 1
        with span("stage.b"):
            pass
    rec = request_log()[-1]
    assert (rec.name, rec.profiled) == ("stage", False)
    assert rec.count == {"stage.a": 2, "stage.b": 1}
    assert all(ns >= 0 for ns in rec.host_ns.values())
    assert rec.end_ns >= rec.start_ns + sum(rec.host_ns.values())
    with maybe_trace(None):
        x = x * 2
    assert torch.equal(x, torch.full((3,), 6.0))


def test_debug_nans_raises_on_a_nan_score():
    cfg = tcli._build_config(argparse.Namespace(preset=None,
                                                debug_nans=True))
    tcli._check_scores(cfg, np.array([1.0, -np.inf]))
    with pytest.raises(FloatingPointError):
        tcli._check_scores(cfg, np.array([1.0, np.nan]))
    tcli._check_scores(cfg.replace(debug_nans=False), np.array([np.nan]))


def test_error_paths(dataset, tmp_path, monkeypatch):
    port_ds, _ = dataset
    rec, lig = (os.path.join(port_ds, f"synth0_{s}_u.pdb") for s in "rl")
    dock = ["dock", "--receptor", rec, "--ligand", lig, "--out",
            str(tmp_path / "o")] + SMALL
    orbax = tmp_path / "orbax"
    (orbax / "step_00000500").mkdir(parents=True)
    (orbax / "step_00000500" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="no step_.* Orbax checkpoint"):
        tcli.main(dock + ["--checkpoint", str(orbax)] + CPU)
    # A damaged Orbax step (a B-tree node's byte flipped) exits naming it.
    broken = tmp_path / "broken"
    shutil.copytree(V9P_CKPT, broken)
    node = next((broken / "step_00000500" / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    node.write_bytes(bytes(raw))
    with pytest.raises(SystemExit, match="CRC-32C differs"):
        tcli.main(dock + ["--checkpoint", str(broken)] + CPU)
    # A mesh needs a process group: without torchrun it names the line.
    with pytest.raises(SystemExit,
                       match="torchrun --nproc-per-node 2 -m "
                             "deeplocalproteindocking_torch.cli dock"):
        tcli.main(dock + ["--mesh-rot", "2"] + CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        tcli.main(dock)
    assert not os.path.exists(str(tmp_path / "o" / "poses.json"))
    # --sweep-mode resample is ported: it docks, as the JAX CLI does.
    resample = ["dock", "--receptor", rec, "--ligand", lig, "--out",
                str(tmp_path / "r"), "--sweep-mode", "resample"] + SMALL
    tcli.main(resample + CPU)
    jcli.main(resample[:6] + [str(tmp_path / "rj")] + resample[7:])
    got, want = (_poses(str(tmp_path / d)) for d in ("r", "rj"))
    assert len(got) == len(want) > 0
    np.testing.assert_allclose([p["score"] for p in got],
                               [p["score"] for p in want], rtol=1e-4,
                               atol=1e-3)
    assert got[0]["shift"] == want[0]["shift"]


def test_doctor_and_info_never_hang(capsys):
    rc = tcli.main(["doctor", "--timeout", "90", "--checkpoint", V9P_DIR]
                   + CPU)
    out = capsys.readouterr().out
    rep = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rep["doctor_ok"] is True
    assert rep["pdb_native"]["ok"] and rep["cif_native"]["ok"]
    assert rep["routes"]["engine"] == "dft_fused"
    assert (rep["routes"]["k1"], rep["routes"]["k2"]) == ("tf32", "fft")
    assert rep["license"]["licensed_rank"] == 3
    assert rep["tf32"] == dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                               cudnn=torch.backends.cudnn.allow_tf32)
    assert rep["distributed"]["world_size"] == 1
    assert rep["distributed"]["nccl_available"] == (
        torch.distributed.is_nccl_available())
    assert rep["kernels"]["path"].startswith(
        os.path.join(os.path.dirname(os.path.dirname(tcli.__file__)),
                     "build", "kernels"))
    if not torch.cuda.is_available():
        assert tcli.main(["doctor", "--timeout", "90"]) == 1
        capsys.readouterr()
    tcli.main(["info"])
    out = capsys.readouterr().out
    assert "presets:" in out and "devices:" in out
    assert "distributed: world size 1" in out
