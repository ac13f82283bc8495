"""Torch port vs JAX package: RMSD, CAPRI metrics and grading.

The same numpy inputs, made from a seed, go through
``deeplocalproteindocking_tpu.utils``/``evaluation`` and their
counterparts in ``deeplocalproteindocking_torch`` on the CPU.  Plain RMSD
and the Kabsch rotation agree within 1e-5, Kabsch RMSD, IRMSD and graded
LRMSD within 1e-4 Å (the float32 eigenproblem's resolution); contact
tables, interface masks, fnat and CAPRI classes are equal.
"""
import json
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from torch_parity import (jax_config, np_, t_, v9p_config, v9p_flat,
                          v9p_flax_params)

from deeplocalproteindocking_torch import evaluation as tev
from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.pipeline import DockingPipeline, PoseSet
from deeplocalproteindocking_torch.utils import quality as tq
from deeplocalproteindocking_tpu import evaluation as jev
from deeplocalproteindocking_tpu import pipeline as jpipe
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.utils import quality as jq

import deeplocalproteindocking_torch.utils.rmsd  # noqa: E402,F401
import deeplocalproteindocking_tpu.utils.rmsd  # noqa: E402,F401

# The packages' utils/__init__ re-export the function rmsd, which hides
# the module of that name from attribute access.
trm = sys.modules["deeplocalproteindocking_torch.utils.rmsd"]
jrm = sys.modules["deeplocalproteindocking_tpu.utils.rmsd"]


def _coord_sets(shape, seed):
    """Two coordinate sets ``shape + (3,)``: the second a rotated,
    shifted and noised copy of the first, and a random 0/1 mask."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=shape + (3,)) * 6.0).astype(np.float32)
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]])
    b = (a @ R.T + rng.normal(size=3) * 4.0
         + rng.normal(size=a.shape) * 0.7).astype(np.float32)
    mask = (rng.random(shape) < 0.6).astype(np.float32)
    return a, b, mask


KABSCH_CASES = [((40,), False), ((40,), True), ((5, 30), False),
                ((2, 3, 25), True)]


def _kabsch_gaps(shape, masked):
    """Largest |difference| (A) of Kabsch RMSD: port vs JAX, port vs the
    port in float64, JAX vs the port in float64."""
    a, b, mask = _coord_sets(shape, seed=len(shape) + 7 * masked)
    m_t = t_(mask) if masked else None
    port = np_(trm.kabsch_rmsd(t_(a), t_(b), m_t)).astype(np.float64)
    jax_ = np.asarray(jrm.kabsch_rmsd(
        jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(mask) if masked else None), np.float64)
    exact = np_(trm.kabsch_rmsd(t_(a).double(), t_(b).double(),
                                None if m_t is None else m_t.double()))
    assert port.shape == jax_.shape == exact.shape == shape[:-1]
    return tuple(float(np.abs(x - y).max())
                 for x, y in ((port, jax_), (port, exact), (jax_, exact)))


@pytest.mark.parametrize("shape,masked", KABSCH_CASES)
def test_rmsd_kabsch_match_jax(shape, masked):
    a, b, mask = _coord_sets(shape, seed=len(shape) + 7 * masked)
    m_t = t_(mask) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    got = np_(trm.rmsd(t_(a), t_(b), m_t))
    want = np_(jrm.rmsd(jnp.asarray(a), jnp.asarray(b), m_j))
    assert got.shape == want.shape == shape[:-1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Kabsch RMSD is sqrt((|a|^2 + |b|^2 - 2 lambda_max) / n) with lambda
    # from a float32 4x4 eigenproblem, so it resolves only ~1e-5..1e-4 A
    # at ||K|| ~ 2,300 here: each package lands up to 4e-5 A from the
    # float64 value, and the two up to 6.3e-5 A apart (python
    # tests/test_torch_grading.py prints the gaps).
    assert max(_kabsch_gaps(shape, masked)) <= 1e-4
    got = np_(trm.kabsch_rotation(t_(a), t_(b), m_t))
    want = np_(jrm.kabsch_rotation(jnp.asarray(a), jnp.asarray(b), m_j))
    # q and -q give one rotation: the matrices compare directly.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The rotation superposes a onto b at the Kabsch RMSD.
    w = mask if masked else np.ones(shape, np.float32)
    ac = a - (a * w[..., None]).sum(-2, keepdims=True) / np.maximum(
        w.sum(-1), 1)[..., None, None]
    bc = b - (b * w[..., None]).sum(-2, keepdims=True) / np.maximum(
        w.sum(-1), 1)[..., None, None]
    moved = np.einsum("...ij,...nj->...ni", got, ac)
    direct = np.sqrt((((moved - bc) ** 2).sum(-1) * w).sum(-1)
                     / np.maximum(w.sum(-1), 1))
    np.testing.assert_allclose(
        direct, np_(trm.kabsch_rmsd(t_(a), t_(b), m_t)), atol=1e-4)


def _random_complex(n_rec, n_lig, seed=0, atoms_per_res=8):
    """tests/test_utils.py's grading fixture: random receptor and ligand
    atoms in contact, 8 atoms per residue."""
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(n_rec, 3)).astype(np.float32) * 12.0
    lig = (rng.normal(size=(n_lig, 3)).astype(np.float32) * 7.0
           + np.array([18.0, 0, 0], np.float32))
    rec_res = (np.arange(n_rec) // atoms_per_res).astype(np.int32)
    lig_res = (np.arange(n_lig) // atoms_per_res).astype(np.int32)
    return rec, lig, rec_res, lig_res


@pytest.mark.parametrize("n_rec,n_lig,seed", [(200, 90, 0), (300, 120, 1)])
def test_contact_table_and_interface_masks(n_rec, n_lig, seed):
    rec, lig, rec_res, lig_res = _random_complex(n_rec, n_lig, seed)
    nr, nl = int(rec_res.max()) + 1, int(lig_res.max()) + 1
    d2 = ((rec[:, None] - lig[None]) ** 2).sum(-1)
    dense = np.zeros((nr, nl), bool)            # the dense numpy oracle
    for i, j in zip(*np.nonzero(d2 < 25.0)):
        dense[rec_res[i], lig_res[j]] = True
    assert dense.any() and not dense.all()
    kw = dict(num_rec_res=nr, num_lig_res=nl, atom_chunk=64)
    got = np_(tq.residue_contact_table(t_(rec), t_(lig), t_(rec_res),
                                       t_(lig_res), **kw))
    want = np_(jq.residue_contact_table(
        jnp.asarray(rec), jnp.asarray(lig), jnp.asarray(rec_res),
        jnp.asarray(lig_res), **kw))
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, want)
    # A pose axis: each pose's table is the table of that pose alone.
    shifted = np.stack([lig, lig - np.array([4.0, 0, 0], np.float32)])
    batched = np_(tq.residue_contact_table(t_(rec), t_(shifted),
                                           t_(rec_res), t_(lig_res), **kw))
    np.testing.assert_array_equal(batched[0], dense)
    np.testing.assert_array_equal(batched[1], np_(tq.residue_contact_table(
        t_(rec), t_(shifted[1]), t_(rec_res), t_(lig_res), **kw)))

    hit = d2 < 100.0
    oracle = (hit.any(1), hit.any(0))
    got_r, got_l = tq.interface_masks_chunked(t_(rec), t_(lig),
                                              atom_chunk=64)
    want_r, want_l = jq.interface_masks_chunked(
        jnp.asarray(rec), jnp.asarray(lig), atom_chunk=64)
    for g, w, o in ((got_r, want_r, oracle[0]), (got_l, want_l, oracle[1])):
        np.testing.assert_array_equal(np_(g), o)
        np.testing.assert_array_equal(np_(g), np_(w))
    dense_r, dense_l = tq.interface_masks(t_(rec), t_(lig))
    np.testing.assert_array_equal(np_(dense_r), oracle[0])
    np.testing.assert_array_equal(np_(dense_l), oracle[1])


def test_dense_metrics_and_capri_match_jax():
    rec, lig, rec_res, lig_res = _random_complex(160, 64, seed=3)
    pose = lig + np.array([1.5, -0.8, 0.4], np.float32)
    args_t = (t_(rec), t_(lig), t_(pose))
    args_j = tuple(jnp.asarray(x) for x in (rec, lig, pose))
    np.testing.assert_allclose(np_(tq.ligand_rmsd(t_(pose), t_(lig))),
                               np_(jq.ligand_rmsd(args_j[2], args_j[1])),
                               atol=1e-5)
    # IRMSD is a Kabsch RMSD: float32's floor, as in the test above.
    np.testing.assert_allclose(np_(tq.interface_rmsd(*args_t)),
                               np_(jq.interface_rmsd(*args_j)), atol=1e-4)
    got = float(tq.fnat(*args_t, t_(rec_res), t_(lig_res)))
    want = float(jq.fnat(*args_j, jnp.asarray(rec_res),
                         jnp.asarray(lig_res)))
    assert 0.0 < got < 1.0 and got == want
    assert tq.CAPRI_CLASSES == jq.CAPRI_CLASSES
    for f in (0.05, 0.1, 0.3, 0.5, 0.9):
        for lr in (0.5, 1.0, 4.0, 5.0, 9.0, 12.0):
            for ir in (0.5, 1.0, 2.0, 3.5, 4.0, 6.0):
                assert tq.capri_class(f, lr, ir) == jq.capri_class(f, lr, ir)


def _band_complex(s, seed0=100):
    """Complex ``s`` of the held-out band (widen sizes, polymer chains,
    unbound 1.2 Å)."""
    kw = dict(seed=seed0 + s, n_res_rec=12 + s % 9,
              n_res_lig=6 + (s // 9) % 5, unbound_rmsd=1.2, backbone=True)
    return synthetic_complex(**kw), jbench.synthetic_complex(**kw)


def _assert_graded_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["rank"] == w["rank"]
        np.testing.assert_allclose(g["lrmsd"], w["lrmsd"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g["irmsd"], w["irmsd"], rtol=0,
                                   atol=1e-4)
        assert g["fnat"] == w["fnat"]
        assert g["capri"] == w["capri"]


def test_grade_poses_matches_jax_on_a_polymer_complex():
    """The same PoseSet, graded by both packages: poses spread from the
    native placement (some acceptable or better) to far misses."""
    tc, jc = _band_complex(5)
    rng = np.random.default_rng(11)
    K = 24
    from deeplocalproteindocking_tpu.structure.so3 import local_rotations
    Rs = np.array(local_rotations(jnp.eye(3), np.deg2rad(40.0), K))
    t0 = (jc.ligand.center - jc.receptor.center).astype(np.float32)
    scale = np.linspace(0.0, 9.0, K, dtype=np.float32)[:, None]
    ts = t0 + rng.normal(size=(K, 3)).astype(np.float32) * scale
    Rs[0] = np.eye(3, dtype=np.float32)
    ts[0] = t0
    poses = PoseSet(scores=np.linspace(1, 0, K).astype(np.float32),
                    rotations=Rs.astype(np.float32), translations=ts,
                    rot_idx=np.arange(K, dtype=np.int32),
                    shifts=np.zeros((K, 3), np.int32))
    got = tev.grade_poses(tc, poses, device="cpu")
    want = jev.grade_poses(jc, poses)
    _assert_graded_equal(got, want)
    classes = {g["capri"] for g in got}
    assert "incorrect" in classes and len(classes) >= 2, classes
    assert got[0]["lrmsd"] < 1e-5 and got[0]["fnat"] == 1.0
    assert tev.grade_poses(tc, PoseSet(*(f[:0] for f in poses[:5])),
                           device="cpu") == []


def test_grading_memory_stays_bounded(monkeypatch):
    """Grading never forms an atom-pair intermediate larger than
    atom_chunk receptor atoms x the pair budget: the pose batches shrink
    so the peak does not grow with the number of poses."""
    from deeplocalproteindocking_torch.structure.pdb import Structure
    from deeplocalproteindocking_torch.data.benchmark import Complex

    def struct(n_atoms, seed, chain, shift):
        rng = np.random.default_rng(seed)
        return Structure(
            coords=(rng.normal(size=(n_atoms, 3)) * 14 + shift).astype(
                np.float32),
            atom_names=np.full(n_atoms, "CA", dtype="<U4"),
            res_names=np.full(n_atoms, "ALA", dtype="<U3"),
            res_ids=(np.arange(n_atoms) // 8 + 1).astype(np.int32),
            chain_ids=np.full(n_atoms, chain, dtype="<U1"),
            types=np.zeros(n_atoms, np.int32))

    cplx = Complex("big", struct(2500, 0, "A", 0.0),
                   struct(400, 1, "B", np.array([30.0, 0, 0])))
    K = 40
    poses = PoseSet(scores=np.zeros(K, np.float32),
                    rotations=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
                    translations=np.zeros((K, 3), np.float32),
                    rot_idx=np.zeros(K, np.int32),
                    shifts=np.zeros((K, 3), np.int32))
    monkeypatch.setattr(tev, "PAIR_BUDGET", 1 << 20)
    pair = tq._pair_sq_dists
    seen = []

    def spy(a, b):
        out = pair(a, b)
        seen.append(out.numel())
        return out

    monkeypatch.setattr(tq, "_pair_sq_dists", spy)
    graded = tev.grade_poses(cplx, poses, device="cpu")
    assert len(graded) == K
    assert max(seen) <= 1 << 20       # 1024-atom chunks x 400 atoms x 2
    assert len(seen) > 3 * 3          # many chunks, several pose batches
    for g in graded[1:]:
        assert g == dict(graded[0], rank=g["rank"])


@pytest.fixture(scope="module")
def local_pair():
    """The v9p model at float32, full-rank coupling, under the local
    protocol at grid 32 with 8 rotations, in both packages."""
    cfg = v9p_config().replace(
        grid_size=32, num_rotations=8, rotation_chunk=4, top_k=16,
        coupling_rank=None, lig_grid_size=None, local_cone_deg=50.0,
        decoy_max_shift=8.0, nms_rmsd=5.0)
    port = DockingPipeline(cfg, params=weights.params_from_numpy(v9p_flat()),
                           device="cpu")
    ref = jpipe.DockingPipeline(config=jax_config(cfg))
    ref.params = v9p_flax_params()
    return port, ref


@pytest.mark.parametrize("s", [0, 13])
def test_evaluate_complex_local_matches_jax(local_pair, s):
    port, ref = local_pair
    tc, jc = _band_complex(s)
    got = tev.evaluate_complex(port, tc)
    want = jev.evaluate_complex(ref, jc)
    assert got["name"] == want["name"]
    assert got["num_poses"] == want["num_poses"]
    for k in ("hit_top1", "hit_top10"):
        assert got[k] == want[k]
    np.testing.assert_allclose(got["best_lrmsd"], want["best_lrmsd"],
                               atol=1e-4)
    _assert_graded_equal(got["poses"], want["poses"])
    np.testing.assert_allclose([g["score"] for g in got["poses"]],
                               [w["score"] for w in want["poses"]],
                               rtol=1e-4, atol=1e-3)


def test_run_benchmark_resumes_per_complex(tmp_path, monkeypatch):
    """run_benchmark writes one atomic result file per complex and, run
    again, reads them back instead of docking."""
    calls = []

    def fake_evaluate(pipeline, cplx, refine_steps=0, rescore_top=0):
        calls.append(cplx.name)
        hit = cplx.name.endswith("1")
        return dict(name=cplx.name, num_poses=1, poses=[],
                    hit_top1=hit, hit_top10=True, best_lrmsd=1.0)

    monkeypatch.setattr(tev, "evaluate_complex", fake_evaluate)
    cplxs = [synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
             for s in (0, 1, 2)]
    from deeplocalproteindocking_torch.utils.logging import MetricsLogger
    log = tmp_path / "m.jsonl"
    with MetricsLogger(str(log), echo=False) as logger:
        a = tev.run_benchmark(None, cplxs, str(tmp_path), logger=logger)
        b = tev.run_benchmark(None, cplxs, str(tmp_path), logger=logger)
    assert calls == ["synth0", "synth1", "synth2"]
    assert a == b == dict(num_complexes=3, top1_hit_rate=1 / 3,
                          top10_hit_rate=1.0)
    events = [json.loads(x)["event"]
              for x in log.read_text().splitlines()]
    assert events.count("complex_done") == 3
    assert events.count("complex_cached") == 3


def test_native_voxel_shift_matches_jax():
    from deeplocalproteindocking_torch.train.data_gen import (
        native_voxel_shift as t_nvs)
    from deeplocalproteindocking_tpu.train.data_gen import (
        native_voxel_shift as j_nvs)
    for s in (0, 7, 30):
        tc, jc = _band_complex(s)
        got = t_nvs(tc, 1.25)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, j_nvs(jc, 1.25))


def test_dense_res_ids_match_jax():
    tc, jc = _band_complex(2)
    for part in ("receptor", "ligand"):
        got = tev._dense_res_ids(getattr(tc, part))
        want = jev._dense_res_ids(getattr(jc, part))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_grading.py
    for case in KABSCH_CASES:
        gaps = _kabsch_gaps(*case)
        print(case, "Kabsch RMSD gap (A): port-JAX %.3g, port-float64 %.3g,"
              " JAX-float64 %.3g" % gaps)
