"""The port's polymer generator (``deeplocalproteindocking_torch/data/
polymer.py``): the JAX package's chains bit for bit, and the same
bond-geometry checks as ``tests/test_polymer.py`` run on the port's own
``polymer_chain``."""
import dataclasses

import numpy as np
import pytest

from deeplocalproteindocking_torch.data.benchmark import synthetic_complex
from deeplocalproteindocking_torch.data.polymer import polymer_chain
from deeplocalproteindocking_tpu.data import polymer as jpoly


def _chain(seed=0, n=40):
    return polymer_chain(np.random.default_rng(seed), n)


@pytest.mark.parametrize("seed,n", [(0, 18), (3, 40), (9, 60)])
def test_polymer_chain_equals_jax(seed, n):
    got = _chain(seed, n)
    want = jpoly.polymer_chain(np.random.default_rng(seed), n)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def test_backbone_bond_lengths():
    s = _chain()
    ca = s.coords[s.atom_names == "CA"]
    N = s.coords[s.atom_names == "N"]
    C = s.coords[s.atom_names == "C"]
    O = s.coords[s.atom_names == "O"]
    np.testing.assert_allclose(np.linalg.norm(np.diff(ca, axis=0), axis=1),
                               3.8, atol=0.02)
    np.testing.assert_allclose(np.linalg.norm(N - ca, axis=1), 1.46,
                               atol=0.05)
    np.testing.assert_allclose(np.linalg.norm(C - ca, axis=1), 1.52,
                               atol=0.05)
    # trans peptide bond C(i)-N(i+1)
    np.testing.assert_allclose(np.linalg.norm(C[:-1] - N[1:], axis=1), 1.33,
                               atol=0.05)
    np.testing.assert_allclose(np.linalg.norm(C - O, axis=1), 1.23,
                               atol=0.05)


def test_ca_virtual_angle_range():
    ca = (s := _chain(seed=1)).coords[s.atom_names == "CA"]
    v1 = ca[:-2] - ca[1:-1]
    v2 = ca[2:] - ca[1:-1]
    cosang = (v1 * v2).sum(1) / (np.linalg.norm(v1, axis=1)
                                 * np.linalg.norm(v2, axis=1))
    ang = np.rad2deg(np.arccos(np.clip(cosang, -1, 1)))
    assert ang.min() > 75.0 and ang.max() < 150.0


def test_cb_length_and_chirality():
    s = _chain(seed=2)
    for rid in np.unique(s.res_ids):
        r = s.select(s.res_ids == rid)
        byname = dict(zip(r.atom_names, r.coords))
        if "CB" not in byname:
            continue
        assert abs(np.linalg.norm(byname["CB"] - byname["CA"]) - 1.53) < 0.05
        # consistent L-chirality: same sign of the triple product
        e1 = byname["N"] - byname["CA"]
        e2 = byname["C"] - byname["CA"]
        e3 = byname["CB"] - byname["CA"]
        assert np.dot(np.cross(e2, e1), e3) > 0


def test_sidechain_connectivity_and_types():
    """Every side-chain atom bonds (< 1.95 A) to something in its residue,
    no intra-residue pair overlaps (< 1.0 A), and every atom is typed."""
    s = _chain(seed=3)
    for rid in np.unique(s.res_ids):
        r = s.select(s.res_ids == rid)
        D = np.linalg.norm(r.coords[:, None] - r.coords[None], axis=-1)
        np.fill_diagonal(D, 99.0)
        assert D.min() > 1.0
        side = ~np.isin(r.atom_names, ["N", "CA", "C", "O"])
        assert (D[side] < 1.95).any(axis=1).all()
    assert (_chain(seed=4).types >= 0).all()


def test_rotamer_diversity():
    """chi1 varies across residues: side chains are sampled, not canned."""
    s = _chain(seed=5, n=60)
    chis = []
    for rid in np.unique(s.res_ids):
        r = s.select(s.res_ids == rid)
        byname = dict(zip(r.atom_names, r.coords))
        g = next((a for a in ("CG", "CG1", "OG", "SG") if a in byname), None)
        if g is None:
            continue
        b1 = byname["CA"] - byname["N"]
        b2 = byname["CB"] - byname["CA"]
        b3 = byname[g] - byname["CB"]
        n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
        chis.append(np.rad2deg(np.arctan2(
            np.dot(np.cross(n1, n2), b2 / np.linalg.norm(b2)),
            np.dot(n1, n2))))
    assert np.std(chis) > 40.0      # spread over rotamer wells


@pytest.mark.parametrize("seed", range(6))
def test_no_sequence_distant_clash(seed):
    s = _chain(seed=seed)
    D = np.linalg.norm(s.coords[:, None] - s.coords[None], axis=-1)
    np.fill_diagonal(D, 99.0)
    dd = np.abs(s.res_ids[:, None] - s.res_ids[None])
    assert np.where(dd >= 2, D, 99.0).min() > 2.0


@pytest.mark.parametrize("seed,n", [(0, 30), (1, 45), (2, 60)])
def test_compact(seed, n):
    ca = (s := _chain(seed=seed, n=n)).coords[s.atom_names == "CA"]
    rg = float(np.sqrt(((ca - ca.mean(0)) ** 2).sum(1).mean()))
    assert rg < 4.2 * n ** (1.0 / 3.0), rg


def test_backbone_carve_is_complete_and_disjoint():
    c = synthetic_complex(seed=11, n_res_rec=14, n_res_lig=7, backbone=True)
    assert (c.ligand.chain_ids == "B").all()
    rec_res = set(map(int, c.receptor.res_ids))
    lig_res = set(map(int, c.ligand.res_ids))
    assert not (rec_res & lig_res)
    assert len(rec_res) == 14 and len(lig_res) == 7


def test_unbound_backbone_rmsd():
    kw = dict(seed=11, n_res_rec=14, n_res_lig=7, backbone=True)
    b = synthetic_complex(**kw)
    u = synthetic_complex(unbound_rmsd=1.2, **kw)
    d = np.linalg.norm(u.ligand.coords - b.ligand.coords, axis=1)
    assert 0.6 < float(np.sqrt((d ** 2).mean())) < 1.8   # ~the target
