"""Torch port vs JAX package: structure I/O and map writers.

``structure/mmcif.py`` (tokenizer, ``_atom_site`` loop, models, altlocs,
label_* fallbacks) on the JAX tests' inline fixtures, the port's own
ctypes bindings of the C++ parsers in ``native/`` against its pure-Python
parsers and against the JAX package's parsers, model counting,
benchmark-directory loading and splitting, and the XPLOR / CCP4 writers.
Host work: every comparison is exact (the same floats parsed from the
same text), except the CCP4 round trip, which is float32 bit for bit.
"""
import os

import numpy as np
import pytest

from deeplocalproteindocking_torch import native
from deeplocalproteindocking_torch.data import benchmark as tbench
from deeplocalproteindocking_torch.grids.ccp4 import read_ccp4, write_ccp4
from deeplocalproteindocking_torch.grids.xplor import write_xplor
from deeplocalproteindocking_torch.native import cif_native, pdb_native
from deeplocalproteindocking_torch.structure import mmcif as tmmcif
from deeplocalproteindocking_torch.structure import pdb as tpdb
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.grids import ccp4 as jccp4
from deeplocalproteindocking_tpu.grids import xplor as jxplor
from deeplocalproteindocking_tpu.structure import mmcif as jmmcif
from deeplocalproteindocking_tpu.structure import pdb as jpdb

_HDR = """loop_
_atom_site.group_PDB
_atom_site.auth_atom_id
_atom_site.auth_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.label_alt_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.occupancy
_atom_site.pdbx_PDB_model_num
"""
_ROW = "ATOM N ASP A 1 ? 1.0 2.0 3.0 1.00 1\n"

# tests/test_mmcif.py's fixtures and more: altlocs and models, a text
# block holding ``loop_``, wrapped rows, quoted values and comments, a
# quoted '_' value in another loop, label_* columns only, and '.'/'?'.
CIFS = {
    "altloc_models": """\
data_test
#
loop_
_atom_site.group_PDB
_atom_site.id
_atom_site.label_atom_id
_atom_site.label_alt_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.pdbx_PDB_ins_code
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.occupancy
_atom_site.pdbx_PDB_model_num
ATOM 1 N . MET A 1 ? 27.340 24.430 2.614 1.00 1
ATOM 2 CA A MET A 1 ? 26.266 25.413 2.842 0.40 1
ATOM 3 CA B MET A 1 ? 26.500 25.600 2.900 0.60 1
HETATM 4 O . HOH A 100 ? 10.000 10.000 10.000 1.00 1
ATOM 5 N . MET A 1 ? 0.000 0.000 0.000 1.00 2
#
""",
    "text_block": ("data_test\n_struct.pdbx_descriptor\n;a long "
                   "description\nloop_\n_atom_site.fake\nmore text\n;\n"
                   + _HDR + _ROW),
    "wrapped": ("data_x\n" + _HDR + "ATOM N ASP A 1 ?\n1.0 2.0 3.0\n1.00 1\n"
                "ATOM CA ASP\nA 1 ? 4.0 5.0 6.0 1.00 1\n"),
    "quoted": ("data_x\n" + _HDR + "ATOM 'N' \"ASP\" A 1 ? 1.0 2.0 3.0 1.00 1"
               " # trailing comment\n"),
    "quoted_tag_value": ("data_x\nloop_\n_entity.id\n_entity.details\n"
                         "1 '_looks_like_a_tag'\n2 'loop_'\n" + _HDR + _ROW),
    "label_only": """\
data_y
loop_
_atom_site.group_PDB
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.label_asym_id
_atom_site.label_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
ATOM N GLY B 7 1.5 2.5 3.5
ATOM CA GLY B 7 2.5 3.5 4.5
ATOM O GLY . ? 3.5 4.5 5.5
""",
    "three_models": ("data_m\n" + _HDR + _ROW
                     + "ATOM N ASP A 1 ? 7.0 8.0 9.0 1.00 2\n"
                     + "HETATM O HOH A 9 ? 0.0 0.0 0.0 1.00 3\n"),
}

PDB_TEXT = """\
MODEL        1
ATOM      1  N   MET A   1      27.340  24.430   2.614  1.00  0.00
ATOM      2  CA AMET A   1      26.266  25.413   2.842  0.40  0.00
ATOM      3  CA BMET A   1      26.500  25.600   2.900  0.60  0.00
HETATM    4  O   HOH A 100      10.000  10.000  10.000  1.00  0.00
ATOM      5  CB  MET A   1A     25.112  24.880   3.649  1.00  0.00
ATOM      6  CG  MET A
ENDMDL
MODEL        2
ATOM      1  N   MET A   1       1.000   2.000   3.000  1.00  0.00
ENDMDL
"""

_FIELDS = ("coords", "atom_names", "res_names", "res_ids", "chain_ids",
           "types", "icodes")


def assert_same_structure(got, want):
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


@pytest.fixture
def python_only(monkeypatch):
    """Both packages' mmCIF parsers on their pure-Python paths."""
    monkeypatch.setattr(tmmcif, "_native_tokenize", False)
    monkeypatch.setattr(jmmcif, "_native_tokenize", False)


def test_native_library_builds_from_the_sources():
    st = native.status()
    assert st["ok"], st
    path = native.library_path()
    assert st["path"] == path and os.path.exists(path)
    assert path.startswith(native.BUILD_DIR + os.sep)
    lib = native.library()
    for sym in ("pdb_count_atoms", "pdb_parse_v2", "cif_tokenize_v1",
                "cif_token_buffer", "cif_token_offsets", "cif_token_flags",
                "cif_free", "cif_atom_site_v1", "cif_as_xyz", "cif_as_alt",
                "cif_as_free"):
        assert hasattr(lib, sym), sym


@pytest.mark.parametrize("name", sorted(CIFS))
def test_tokenizer_native_python_and_jax_agree(name):
    text = CIFS[name]
    want = jmmcif._tokenize_cif_py(text)
    assert tmmcif._tokenize_cif_py(text) == want
    assert cif_native.tokenize_cif(text) == want


def _parsed(parse, text, het, model):
    """The Structure, or the ValueError's message."""
    try:
        return parse(text, include_hetatm=het, model=model)
    except ValueError as e:
        return str(e)


def assert_same_outcome(got, want):
    if isinstance(want, str):
        assert got == want
    else:
        assert_same_structure(got, want)


@pytest.mark.parametrize("name", sorted(CIFS))
@pytest.mark.parametrize("het", [False, True])
def test_parse_mmcif_text_matches_jax(name, het, monkeypatch):
    """Native and pure-Python paths of both packages, every model.  A
    model that exists only as excluded HETATM rows is the JAX package's
    one known divergence between its paths (empty on the native path, a
    ValueError in Python); the port has it alike."""
    text = CIFS[name]
    for model in range(1, jmmcif.count_models_mmcif_text(text) + 1):
        want = _parsed(jmmcif.parse_mmcif_text, text, het, model)
        assert_same_outcome(_parsed(tmmcif.parse_mmcif_text, text, het,
                                    model), want)
        with monkeypatch.context() as m:
            m.setattr(tmmcif, "_native_tokenize", False)
            m.setattr(jmmcif, "_native_tokenize", False)
            py_want = _parsed(jmmcif.parse_mmcif_text, text, het, model)
            py_got = _parsed(tmmcif.parse_mmcif_text, text, het, model)
        assert_same_outcome(py_got, py_want)
        if not isinstance(want, str) and len(want):
            assert_same_structure(py_got, want)


def test_mmcif_fixture_semantics(python_only):
    text = CIFS["altloc_models"]
    s = tmmcif.parse_mmcif_text(text)
    assert list(s.atom_names) == ["N", "CA"]     # the 0.60 altloc wins
    np.testing.assert_allclose(s.coords[1], [26.5, 25.6, 2.9], atol=1e-4)
    assert len(tmmcif.parse_mmcif_text(text, include_hetatm=True)) == 3
    s2 = tmmcif.parse_mmcif_text(text, model=2)
    np.testing.assert_allclose(s2.coords, [[0.0, 0.0, 0.0]])
    with pytest.raises(ValueError, match="model 3"):
        tmmcif.parse_mmcif_text(text, model=3)
    lab = tmmcif.parse_mmcif_text(CIFS["label_only"])
    assert list(lab.chain_ids) == ["B", "B", "A"]  # '.' -> the default
    assert list(lab.res_ids) == [7, 7, 0]          # '?' -> the default
    assert [len(tmmcif.parse_mmcif_text(CIFS[k]))
            for k in ("text_block", "wrapped", "quoted",
                      "quoted_tag_value")] == [1, 2, 1, 1]


@pytest.mark.parametrize("native_on", [True, False])
def test_count_models_mmcif_matches_jax(native_on, monkeypatch):
    if not native_on:
        monkeypatch.setattr(tmmcif, "_native_tokenize", False)
        monkeypatch.setattr(jmmcif, "_native_tokenize", False)
    got = {k: tmmcif.count_models_mmcif_text(t) for k, t in CIFS.items()}
    assert got == {k: jmmcif.count_models_mmcif_text(t)
                   for k, t in CIFS.items()}
    assert got["altloc_models"] == 2 and got["three_models"] == 3
    assert got["label_only"] == 1


def test_count_models_pdb_text_matches_jax():
    for text in (PDB_TEXT, "ATOM      1  N   MET A   1      27.340  "
                 "24.430   2.614  1.00  0.00\n", ""):
        assert (tpdb.count_models_pdb_text(text)
                == jpdb.count_models_pdb_text(text))
    assert tpdb.count_models_pdb_text(PDB_TEXT) == 2


@pytest.mark.parametrize("het", [False, True])
def test_native_pdb_parser_matches_python_and_jax(tmp_path, het):
    p = tmp_path / "t.pdb"
    p.write_text(PDB_TEXT)
    fast = pdb_native.parse_pdb(str(p), include_hetatm=het)
    slow = tpdb.parse_pdb_text(PDB_TEXT, include_hetatm=het)
    assert_same_structure(fast, slow)
    assert_same_structure(fast, jpdb.parse_pdb(str(p), include_hetatm=het))
    assert_same_structure(tpdb.parse_pdb(p, include_hetatm=het), fast)
    assert list(fast.icodes) == [""] * (2 + het) + ["A"]
    two = tpdb.parse_pdb(p, model=2)         # model 2: the Python parser
    assert_same_structure(two, jpdb.parse_pdb(str(p), model=2))
    np.testing.assert_allclose(two.coords, [[1.0, 2.0, 3.0]])


def test_parse_pdb_falls_back_without_the_library(tmp_path, monkeypatch):
    p = tmp_path / "t.pdb"
    p.write_text(PDB_TEXT)

    def no_library():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(pdb_native, "library", no_library)
    assert tpdb._try_native(p, False) is None
    assert_same_structure(tpdb.parse_pdb(p), tpdb.parse_pdb_text(PDB_TEXT))


def test_parse_structure_and_count_models_dispatch(tmp_path):
    c = tbench.synthetic_complex(seed=3, n_res_rec=10, n_res_lig=5)
    pdb_path = tmp_path / "rec.pdb"
    tpdb.write_pdb(pdb_path, c.receptor)
    got = tmmcif.parse_structure(pdb_path)
    assert_same_structure(got, jmmcif.parse_structure(pdb_path))
    np.testing.assert_allclose(got.coords, c.receptor.coords, atol=6e-4)
    cif_path = tmp_path / "x.cif"
    cif_path.write_text(CIFS["three_models"])
    for m in (1, 2):
        assert_same_structure(tmmcif.parse_structure(cif_path, model=m),
                              jmmcif.parse_structure(cif_path, model=m))
    multi = tmp_path / "m.pdb"
    multi.write_text(PDB_TEXT)
    for path in (pdb_path, cif_path, multi):
        assert tmmcif.count_models(path) == jmmcif.count_models(path)
    assert [tmmcif.count_models(p) for p in (pdb_path, cif_path, multi)] == [
        1, 3, 2]


def _write_benchmark(root):
    """Three complexes: two PDB pairs (one with a bound form too) and one
    mmCIF ligand; plus files the listing must ignore."""
    os.makedirs(root)
    for seed, code in ((0, "1abc"), (1, "2xyz"), (2, "3cif")):
        c = tbench.synthetic_complex(seed=seed, n_res_rec=10, n_res_lig=5)
        tpdb.write_pdb(os.path.join(root, f"{code}_r_u.pdb"), c.receptor)
        if code == "3cif":
            s = c.ligand
            rows = "".join(
                f"ATOM {s.atom_names[i]} {s.res_names[i]} {s.chain_ids[i]} "
                f"{s.res_ids[i]} . {x:.3f} {y:.3f} {z:.3f} 1.00 1\n"
                for i, (x, y, z) in enumerate(s.coords))
            with open(os.path.join(root, f"{code}_l_u.cif"), "w") as f:
                f.write("data_l\n" + _HDR + rows)
        else:
            tpdb.write_pdb(os.path.join(root, f"{code}_l_u.pdb"), c.ligand)
    tpdb.write_pdb(os.path.join(root, "1abc_r_b.pdb"), c.receptor)
    tpdb.write_pdb(os.path.join(root, "1abc_l_b.pdb"), c.ligand)
    open(os.path.join(root, "notes.txt"), "w").close()


def test_benchmark_directory_matches_jax(tmp_path):
    root = str(tmp_path / "db")
    _write_benchmark(root)
    codes = tbench.list_benchmark(root)
    assert codes == jbench.list_benchmark(root) == ["1abc", "2xyz", "3cif"]
    for code in codes:
        for bound in ((False, True) if code == "1abc" else (False,)):
            got = tbench.load_complex(root, code, bound=bound)
            want = jbench.load_complex(root, code, bound=bound)
            assert got.name == want.name == code
            assert_same_structure(got.receptor, want.receptor)
            assert_same_structure(got.ligand, want.ligand)
            assert len(got.ligand) > 0
    with pytest.raises(FileNotFoundError, match="2xyz_r_b"):
        tbench.load_complex(root, "2xyz", bound=True)
    many = [f"{i:04d}" for i in range(40)]
    for seed in (0, 7):
        for fr in ((0.7, 0.15, 0.15), (1, 1, 2)):
            assert (tbench.split_benchmark(many, fr, seed)
                    == jbench.split_benchmark(many, fr, seed))
    split = tbench.split_benchmark(many)
    assert sorted(sum(split.values(), [])) == many
    # Hash-stable: a code keeps its split when the benchmark grows.
    grown = tbench.split_benchmark(many + ["zzzz"])
    assert all(set(split[k]) <= set(grown[k]) for k in split)


def test_write_xplor_matches_jax_bytes(tmp_path):
    import torch
    vol = np.random.default_rng(0).normal(size=(6, 6, 6)).astype(np.float32)
    a, b = tmp_path / "port.xplor", tmp_path / "jax.xplor"
    write_xplor(str(a), torch.as_tensor(vol), resolution=1.5, title="t")
    jxplor.write_xplor(str(b), vol, resolution=1.5, title="t")
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError, match="cubic"):
        write_xplor(str(a), vol[:, :, :5])


def test_ccp4_round_trip_and_jax_reader(tmp_path):
    import torch
    vol = np.random.default_rng(1).normal(size=(8, 8, 8)).astype(np.float32)
    p, q = tmp_path / "port.map", tmp_path / "jax.map"
    write_ccp4(str(p), torch.as_tensor(vol), resolution=1.25,
               origin=(1.0, 2.0, 3.0))
    back, res = read_ccp4(str(p))
    np.testing.assert_array_equal(back, vol)
    assert res == pytest.approx(1.25)
    jback, jres = jccp4.read_ccp4(str(p))
    np.testing.assert_array_equal(jback, vol)
    assert jres == res
    jccp4.write_ccp4(str(q), vol, resolution=1.25, origin=(1.0, 2.0, 3.0))
    # Equal but for the 80-byte label naming the writing package.
    pb, qb = p.read_bytes(), q.read_bytes()
    assert len(pb) == len(qb) == 1024 + 4 * vol.size
    assert pb[:224] == qb[:224] and pb[304:] == qb[304:]
    np.testing.assert_array_equal(read_ccp4(str(q))[0], vol)
