"""The port's eval-matrix script (``deeplocalproteindocking_torch.eval_matrix``)
against ``tools/eval_matrix.py``: per-complex checkpoint/resume, the
fingerprint guards, the seed-disjointness guard, the held-out bands and
the output layout (rows comparable key for key with a matrix the JAX
script wrote, readable by ``tools/pooled_verdict.py``)."""
import importlib.util
import json
import os

import pytest

from torch_parity import ROOT, V9P_CKPT, V9P_DIR

from deeplocalproteindocking_torch import eval_matrix as tem

_spec = importlib.util.spec_from_file_location(
    "jax_eval_matrix", os.path.join(ROOT, "tools", "eval_matrix.py"))
jem = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jem)

PARITY = os.path.join(V9P_DIR, "eval_matrix_48_cpu_parity.json")
BAND100_ENV = dict(EM_COMPLEXES="48", EM_MODES="local", EM_WIDEN="1",
                   EM_SEED0="100", EM_UNBOUND="1.2", EM_BACKBONE="1",
                   EM_DTYPE="bfloat16", EM_RANK="0")


class _FakeComplex:
    def __init__(self, name):
        self.name = name


@pytest.fixture()
def graded(monkeypatch):
    """grade_poses stub: dock_fn returns the graded rows directly."""
    monkeypatch.setattr(tem, "grade_poses", lambda c, p, device=None: p)


def _rows(names, hit):
    return {n: [dict(capri="acceptable" if hit(n) else "incorrect",
                     lrmsd=1.0 if hit(n) else 30.0)] for n in names}


def test_eval_row_progress_and_rates(graded):
    names = [f"c{i}" for i in range(6)]
    table = _rows(names, lambda n: n in ("c1", "c4"))
    calls, snapshots = [], []

    def dock_fn(c):
        calls.append(c.name)
        return table[c.name]

    out = tem.eval_row(dock_fn, [_FakeComplex(n) for n in names], "t",
                       on_progress=lambda r: snapshots.append(len(r)))
    assert calls == names
    assert snapshots == [1, 2, 3, 4, 5, 6]          # ckpt every complex
    assert out["top1"] == pytest.approx(2 / 6)
    assert [r["name"] for r in out["complexes"]] == names


def test_eval_row_resumes_partial(graded):
    names = [f"c{i}" for i in range(5)]
    table = _rows(names, lambda n: True)
    # A crash after c0, c1, with c1 graded unlike a re-dock would: the
    # cached row is trusted, not re-run.
    partial = [dict(name="c0", hit_top1=True, hit_top10=True,
                    best_lrmsd=1.0),
               dict(name="c1", hit_top1=False, hit_top10=False,
                    best_lrmsd=25.0)]
    calls = []

    def dock_fn(c):
        calls.append(c.name)
        return table[c.name]

    out = tem.eval_row(dock_fn, [_FakeComplex(n) for n in names], "t",
                       partial=partial)
    assert calls == ["c2", "c3", "c4"]              # no re-dock
    assert out["top1"] == pytest.approx(4 / 5)       # c1 kept as miss
    assert [r["name"] for r in out["complexes"]] == names


def test_eval_row_out_of_order_partial(graded):
    names = ["a", "b", "c"]
    table = _rows(names, lambda n: False)
    partial = [dict(name="c", hit_top1=False, hit_top10=True,
                    best_lrmsd=9.0)]
    out = tem.eval_row(lambda c: table[c.name],
                       [_FakeComplex(n) for n in names], "t",
                       partial=partial)
    assert [r["name"] for r in out["complexes"]] == names
    assert out["complexes"][2]["hit_top10"] is True


@pytest.mark.parametrize("module", [tem, jem], ids=["port", "jax"])
def test_completed_row_fingerprint_guard(module):
    """Same fingerprint -> reused; different -> discarded; legacy rows
    without a fingerprint -> kept; in both scripts alike."""
    fp_a = dict(n_rot=1536, grid=64, rank=0)
    fp_b = dict(n_rot=1536, grid=64, rank=2)
    row = dict(top1=0.5, top10=1.0, complexes=[], fingerprint=fp_a)
    results = {"learned_global": dict(row)}
    assert module.completed_row_reusable(results, "learned_global", fp_a)
    assert "learned_global" in results
    results = {"learned_global": dict(row)}
    assert not module.completed_row_reusable(results, "learned_global",
                                             fp_b)
    assert "learned_global" not in results
    legacy = {"learned_global": dict(top1=0.5, top10=1.0, complexes=[])}
    assert module.completed_row_reusable(legacy, "learned_global", fp_b)
    assert not module.completed_row_reusable({}, "missing", fp_a)


def test_fingerprint_agg_only_guards_rerank_rows():
    fp_max = dict(n_rot=1536, grid=64, rank=0, agg="max")
    fp_topmean = dict(fp_max, agg="topmean")
    row = dict(top1=0.5, top10=1.0, complexes=[], fingerprint=fp_max)
    results = {"shape_global": dict(row)}
    assert tem.completed_row_reusable(results, "shape_global", fp_topmean)
    results = {"learned_rerank_global": dict(row)}
    assert not tem.completed_row_reusable(results, "learned_rerank_global",
                                          fp_topmean)
    assert not tem.completed_row_reusable(
        {"shape_global": dict(row)}, "shape_global", dict(fp_max, rank=2))
    for key in ("shape_local", "learned_rerank_global"):
        for a, b in ((fp_max, fp_topmean), (fp_max, dict(fp_max, rank=2))):
            assert (tem.fingerprints_match(a, b, key)
                    == jem.fingerprints_match(a, b, key))


def test_seed_disjointness_guard(tmp_path):
    ckpt = tmp_path / "model" / "best"
    ckpt.mkdir(parents=True)
    with open(tmp_path / "model" / "TRAINING.json", "w") as f:
        json.dump(dict(n_train=1024, train_seed0=200, n_val=32), f)
    with pytest.raises(SystemExit, match="train seeds"):
        tem.check_seed_disjointness(str(ckpt), 300, 48, environ={})
    with pytest.raises(SystemExit, match="val seeds"):
        tem.check_seed_disjointness(str(ckpt), 60, 8, environ={})
    tem.check_seed_disjointness(str(ckpt), 100, 48, environ={})
    tem.check_seed_disjointness(str(ckpt), 1300, 48, environ={})
    tem.check_seed_disjointness(str(ckpt), 300, 48,
                                environ={"EM_ALLOW_TRAIN_OVERLAP": "1"})
    tem.check_seed_disjointness(str(tmp_path / "nope"), 300, 48, environ={})
    # The v9p checkpoint's band 100 is disjoint from its training seeds.
    tem.check_seed_disjointness(V9P_CKPT, 100, 48, environ={})


def test_band100_settings_give_the_committed_fingerprint():
    """The EM_* settings of band 100's local rows reproduce the
    fingerprint that eval_matrix_48_cpu_parity.json records."""
    with open(PARITY) as f:
        committed = json.load(f)
    settings = tem.settings_from_env(BAND100_ENV)
    assert settings["modes"] == ["local"] and not settings["rerank"]
    for key in ("shape_local", "learned_local"):
        assert tem.fingerprint_of(settings) == committed[key]["fingerprint"]
    base = tem.protocol_base(settings, "local")
    assert base["num_rotations"] == 64 and base["local_cone_deg"] == 50.0
    lcfg = tem.learned_config(V9P_CKPT, settings, "local")
    assert (lcfg.compute_dtype, lcfg.dft_dtype) == ("bfloat16",) * 2
    assert lcfg.coupling_rank is None and lcfg.lig_grid_size is None
    assert lcfg.rep_features == (32, 14) and lcfg.shape_prior
    assert os.path.exists(tem.params_path(V9P_CKPT))


@pytest.mark.parametrize("widen", [False, True])
def test_heldout_complexes_match_jax(widen):
    kw = dict(widen=widen, seed0=140, unbound=1.2, backbone=True)
    got = tem.heldout_complexes(5, **kw)
    want = jem.heldout_complexes(5, **kw)
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        assert (g.receptor.coords == w.receptor.coords).all()
        assert (g.ligand.coords == w.ligand.coords).all()


def test_run_matrix_layout_and_resume(tmp_path, monkeypatch):
    """Two local rows at grid 32 on the CPU: the JSON layout of the JAX
    script's matrices, per-row resume, and a file tools/pooled_verdict.py
    pools."""
    settings = tem.settings_from_env(dict(
        BAND100_ENV, EM_COMPLEXES="2", EM_GRID="32", EM_DTYPE="float32"))
    out = tmp_path / "eval_matrix_48.json"
    results, seconds = tem.run_matrix(V9P_CKPT, str(out), settings,
                                      device="cpu", environ={})
    assert set(seconds) == {"shape_local", "learned_local"}
    with open(PARITY) as f:
        committed = json.load(f)
    assert set(results) == set(committed)
    for key in ("shape_local", "learned_local"):
        row = results[key]
        assert set(row) == set(committed[key])
        assert row["platform"] == "cpu"
        assert set(row["fingerprint"]) == set(committed[key]["fingerprint"])
        assert [c["name"] for c in row["complexes"]] == ["synth100",
                                                         "synth101"]
        for c in row["complexes"]:
            assert set(c) == set(committed[key]["complexes"][0])
    assert set(results["protocol"]) == set(committed["protocol"])
    with open(out) as f:
        assert json.load(f) == results

    # A second run re-docks nothing: every row is reused.
    def no_dock(*a, **k):
        raise AssertionError("a completed row was recomputed")

    monkeypatch.setattr(tem, "eval_row", no_dock)
    again, seconds = tem.run_matrix(V9P_CKPT, str(out), settings,
                                    device="cpu", environ={})
    assert seconds == {} and again == results

    _pv = importlib.util.spec_from_file_location(
        "pooled_verdict", os.path.join(ROOT, "tools", "pooled_verdict.py"))
    pv = importlib.util.module_from_spec(_pv)
    _pv.loader.exec_module(pv)
    files, proto = pv.discover(str(tmp_path))
    pooled, prov = pv.pool(files)
    assert sorted(pooled) == ["learned_local", "shape_local"]
    assert prov["shape_local"][0]["platform"] == "cpu"
    verdict = pv.mcnemar(pooled["learned_local"], pooled["shape_local"],
                         "hit_top1")
    assert verdict["n"] == 2


def test_main_reads_the_em_knobs_and_defaults_to_the_card(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """``python -m deeplocalproteindocking_torch.eval_matrix CKPT OUT``
    takes its knobs from EM_* and runs on the card unless ``--device``
    says otherwise."""
    seen = []

    def fake_run(ckpt, out_path, settings, device="cuda"):
        seen.append(dict(ckpt=ckpt, out=out_path, settings=settings,
                         device=device))
        return ({"shape_local": dict(top1=0.5, top10=1.0, complexes=[]),
                 "protocol": {}}, {"shape_local": 1.5})

    monkeypatch.setattr(tem, "run_matrix", fake_run)
    for k, v in BAND100_ENV.items():
        monkeypatch.setenv(k, v)
    out = str(tmp_path / "m.json")
    tem.main([V9P_CKPT, out])
    tem.main([V9P_CKPT, "--device", "cpu"])
    assert [s["device"] for s in seen] == ["cuda", "cpu"]
    assert seen[0]["out"] == out
    assert seen[1]["out"] == os.path.join(V9P_CKPT, "eval_matrix.json")
    assert seen[0]["settings"] == tem.settings_from_env(BAND100_ENV)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"row_seconds": {"shape_local": 1.5}}


def test_bf16_dft_fused_rounds_where_jax_rounds_on_the_cpu():
    """Band 100's ``learned_local`` row (v9p, bf16) on synth129, the
    complex whose best LRMSD moved most (8.41 -> 7.48 A) while the CPU
    sweep rounded as the TPU kernel does.  Off the TPU the JAX package
    scores ``dft_fused`` through ``DFTCorrelator.scores``
    (``sweep/resplat.py:300-304``), which rounds the ligand spectrum to
    bf16 before the coupling; K1 rounds the coupled product instead.  On
    the complex's own receptor spectrum and ligand representations (4
    rotations of its local cone), the port's CPU correlation must round
    where the JAX package's does: within float32 summation order."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from torch_parity import jax_config, np_

    from deeplocalproteindocking_torch import weights
    from deeplocalproteindocking_torch.evaluation import local_dock_kwargs
    from deeplocalproteindocking_torch.grids.voxelize import separable_splat
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    from deeplocalproteindocking_torch.sweep import resplat as tresplat
    from deeplocalproteindocking_tpu.correlate.dft import (
        get_correlator as jget)
    from deeplocalproteindocking_tpu.sweep import resplat as jresplat

    s = tem.settings_from_env(BAND100_ENV)
    cfg = tem.learned_config(V9P_CKPT, s, "local")
    c = tem.heldout_complexes(30, widen=True, seed0=100, unbound=1.2,
                              backbone=True)[29]
    assert c.name == "synth129"
    pipe = DockingPipeline(cfg, params=weights.load_npz(
        tem.params_path(V9P_CKPT)), device="cpu")
    lig_c, (impl, H, rep_fn), (lc, lt, lm), Ls = pipe._stage_inputs(
        c.receptor, c.ligand, None, None)
    assert impl == "dft_fused"
    rots = local_dock_kwargs(pipe, c)["rotations"][:4]
    with torch.no_grad():
        vols = torch.stack([separable_splat(
            torch.einsum("ij,nj->ni", R, lc), lt, lm, grid_size=Ls,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types) for R in rots])
        reps = rep_fn(vols)
        corr = tresplat.get_correlator(cfg.grid_size, Ls, "bfloat16", "cpu")
        Ht = corr.prep_H(H)
        got = tresplat._correlate_fused(Ht, reps, cfg.grid_size, Ls,
                                        "bfloat16")
    jHt = tuple(jnp.asarray(np_(h.float())).astype(jnp.bfloat16)
                for h in Ht)
    jfn = jax.jit(jresplat._correlate_fused, static_argnums=(2, 3, 4))
    want = np_(jfn(jHt, jnp.asarray(np_(reps)), cfg.grid_size, Ls,
                   "bfloat16"))
    assert jax_config(cfg).compute_dtype == "bfloat16"
    assert jget(cfg.grid_size, Ls, "bfloat16").dtype == jnp.bfloat16
    # Relative to the largest score.  Summation order alone leaves most
    # scores within float32 rounding; where it flips one bf16 rounding of
    # an intermediate, that score moves by a part in 10^4.  Rounding at
    # K1's points instead moves the median score by 3e-4 (measured).
    d = np.abs(np_(got) - want) / np.abs(want).max()
    assert np.median(d) < 1e-6, np.median(d)
    assert np.quantile(d, 0.99) < 5e-5, np.quantile(d, 0.99)
    assert d.max() < 1e-3, d.max()
