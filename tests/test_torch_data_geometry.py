"""Torch port vs JAX package: structures, synthetic data, SO(3) sets,
transforms, the splat, shift indexing and pose clustering."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ROOT, np_, t_

from deeplocalproteindocking_torch.data import benchmark as tbench
from deeplocalproteindocking_torch.structure import pdb as tpdb
from deeplocalproteindocking_torch.structure import so3 as tso3
from deeplocalproteindocking_torch.structure import transforms as ttf
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.structure import pdb as jpdb
from deeplocalproteindocking_tpu.structure import so3 as jso3
from deeplocalproteindocking_tpu.structure import transforms as jtf


def _assert_structures_equal(a, b):
    for f in dataclasses.fields(jpdb.Structure):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name), err_msg=f.name)


@pytest.mark.parametrize("seed,n_rec,n_lig,unbound", [
    (0, 60, 30, 0.0), (3, 30, 15, 0.0), (11, 20, 8, 1.2)])
def test_synthetic_complex_equal(seed, n_rec, n_lig, unbound):
    a = tbench.synthetic_complex(seed, n_rec, n_lig, unbound_rmsd=unbound)
    b = jbench.synthetic_complex(seed, n_rec, n_lig, unbound_rmsd=unbound)
    assert a.name == b.name
    _assert_structures_equal(a.receptor, b.receptor)
    _assert_structures_equal(a.ligand, b.ligand)


@pytest.mark.parametrize("s", range(48))
def test_synthetic_backbone_band100_equal(s):
    """Complex ``s`` of the held-out band 100 (polymer chains, widen
    sizes, unbound 1.2 A) equals the JAX package's bit for bit."""
    kw = dict(seed=100 + s, n_res_rec=12 + s % 9, n_res_lig=6 + (s // 9) % 5,
              unbound_rmsd=1.2, backbone=True)
    a = tbench.synthetic_complex(**kw)
    b = jbench.synthetic_complex(**kw)
    assert a.name == b.name
    _assert_structures_equal(a.receptor, b.receptor)
    _assert_structures_equal(a.ligand, b.ligand)


@pytest.mark.parametrize("bucket,max_atoms", [(None, None), (64, None),
                                              (None, 300)])
def test_structure_to_device_equal(bucket, max_atoms):
    lig = jbench.synthetic_complex(1, 30, 15).ligand
    got = tbench.structure_to_device(lig, max_atoms, bucket)
    want = jbench.structure_to_device(lig, max_atoms, bucket)
    for g, w in zip(got, want):
        assert g.dtype == t_(w).dtype
        np.testing.assert_array_equal(np_(g), np_(w))


def test_pdb_roundtrip_matches_jax_parser(tmp_path):
    cplx = jbench.synthetic_complex(2, 20, 8)
    path = tmp_path / "rec.pdb"
    tpdb.write_pdb(path, cplx.receptor)
    text = path.read_text()
    text += "HETATM 9999  O   HOH W   1       1.000   2.000   3.000  1.00  0.00\n"
    got = tpdb.parse_pdb(path)
    _assert_structures_equal(got, jpdb.parse_pdb_text(text))
    _assert_structures_equal(tpdb.parse_pdb_text(text, include_hetatm=True),
                             jpdb.parse_pdb_text(text, include_hetatm=True))
    np.testing.assert_allclose(got.coords, cplx.receptor.coords, atol=6e-4)


@pytest.mark.parametrize("n", [1, 7, 128, 1000])
def test_super_fibonacci_rotations(n):
    np.testing.assert_allclose(np_(tso3.super_fibonacci_rotations(n)),
                               np_(jso3.super_fibonacci_rotations(n)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("deg,n", [(30.0, 40), (90.0, 17)])
def test_local_rotations_deterministic(deg, n):
    base = np_(jso3.super_fibonacci_rotations(5))[3]
    got = tso3.local_rotations(t_(base), np.deg2rad(deg), n)
    want = jso3.local_rotations(jnp.asarray(base), np.deg2rad(deg), n)
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-6, rtol=0)


def test_local_rotations_generator_within_cone():
    base = torch.eye(3)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tso3.local_rotations(base, np.deg2rad(20.0), 64, generator=g1)
    b = tso3.local_rotations(base, np.deg2rad(20.0), 64, generator=g2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ang = np_(jso3.geodesic_angle(jnp.asarray(np_(a)), jnp.eye(3)))
    assert ang.max() <= np.deg2rad(20.0) + 1e-5


def test_transforms_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(9, 4)).astype(np.float32)
    axis = rng.normal(size=(9, 3)).astype(np.float32)
    angle = rng.uniform(0, np.pi, size=9).astype(np.float32)
    x = rng.normal(size=(9, 20, 3)).astype(np.float32)
    t = rng.normal(size=(9, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(ttf.quat_to_matrix(t_(q))),
                               np_(jtf.quat_to_matrix(jnp.asarray(q))),
                               atol=1e-6)
    R = ttf.axis_angle_to_matrix(t_(axis), t_(angle))
    np.testing.assert_allclose(
        np_(R), np_(jtf.axis_angle_to_matrix(jnp.asarray(axis),
                                             jnp.asarray(angle))),
        atol=1e-6)
    np.testing.assert_allclose(
        np_(ttf.apply_pose(t_(x), R, t_(t))),
        np_(jtf.apply_pose(jnp.asarray(x), jnp.asarray(np_(R)),
                           jnp.asarray(t))), atol=1e-5)


@pytest.mark.parametrize("L,res,chunk,batched", [
    (16, 1.5, None, False), (32, 1.25, None, True), (24, 1.25, 64, False),
    (16, 1.5, 100, True)])
def test_separable_splat(L, res, chunk, batched):
    from deeplocalproteindocking_torch.grids.voxelize import (
        separable_splat as t_splat)
    from deeplocalproteindocking_tpu.grids.voxelize import (
        separable_splat as j_splat)
    lig = jbench.synthetic_complex(4, 30, 12).ligand.centered()
    coords, types, mask = jbench.structure_to_device(lig, bucket=64)
    kw = dict(grid_size=L, resolution=res, sigma=1.0, num_types=11,
              atom_chunk=chunk)
    if batched:
        R = np_(jso3.super_fibonacci_rotations(3))
        cb = np.einsum("bij,nj->bni", R, np_(coords)).astype(np.float32)
        want = np.stack([np_(j_splat(jnp.asarray(c), types, mask, **kw))
                         for c in cb])
        got = t_splat(t_(cb), t_(types), t_(mask), **kw)
    else:
        want = np_(j_splat(coords, types, mask, **kw))
        got = t_splat(t_(coords), t_(types), t_(mask), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(np_(got), want, rtol=1e-5, atol=1e-6)


def test_shift_indexing_and_translation_mask():
    from deeplocalproteindocking_torch.correlate import fft as tfft
    from deeplocalproteindocking_tpu.correlate import fft as jfft
    L = 16
    flat = np.arange(0, L ** 3, 37, dtype=np.int32)
    sh = tfft.flat_index_to_shift(t_(flat), L)
    np.testing.assert_array_equal(np_(sh), np_(jfft.flat_index_to_shift(
        jnp.asarray(flat), L)))
    np.testing.assert_array_equal(np_(tfft.shift_to_flat_index(sh, L)),
                                  flat)
    for max_shift, center in ((3, None), (5, np.array([7, -2, 8]))):
        got = tfft.translation_mask(
            L, max_shift, None if center is None else t_(center))
        want = jfft.translation_mask(
            L, max_shift, None if center is None else jnp.asarray(center))
        np.testing.assert_array_equal(np_(got), np_(want))


def test_pose_rmsd_and_nms():
    from deeplocalproteindocking_torch.sweep import cluster as tcl
    from deeplocalproteindocking_tpu.sweep import cluster as jcl
    rng = np.random.default_rng(3)
    lig = rng.normal(size=(50, 3)).astype(np.float32) * 5.0
    Rs = np_(jso3.super_fibonacci_rotations(12))
    ts = rng.normal(size=(12, 3)).astype(np.float32) * 3.0
    got = tcl.pose_pairwise_rmsd(t_(lig), t_(Rs), t_(ts))
    want = jcl.pose_pairwise_rmsd(jnp.asarray(lig), jnp.asarray(Rs),
                                  jnp.asarray(ts))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-4)
    scores = rng.normal(size=12).astype(np.float32)
    np.testing.assert_array_equal(
        tcl.nms_cluster(scores, np_(got), 8.0),
        jcl.nms_cluster(scores, np_(want), 8.0))


def test_port_imports_without_jax():
    """The port's docking, screening, refinement, grading and batched
    docking paths import where jax, flax, optax and orbax are absent,
    never load the JAX package itself, and open no file under it (no
    module of the JAX package run on its own, as a file); a polymer
    complex builds there."""
    code = (
        "import os, sys\n"
        "tpu = os.sep + 'deeplocalproteindocking_tpu' + os.sep\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if (event == 'open' and isinstance(args[0], str)\n"
        "            and tpu in os.path.abspath(args[0])):\n"
        "        opened.append(args[0])\n"
        "sys.addaudithook(hook)\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import deeplocalproteindocking_torch.pipeline\n"
        "import deeplocalproteindocking_torch.weights\n"
        "import deeplocalproteindocking_torch.correlate.invz_topk\n"
        "import deeplocalproteindocking_torch.correlate.idft\n"
        "import deeplocalproteindocking_torch.sweep.refine\n"
        "import deeplocalproteindocking_torch.serving\n"
        "import deeplocalproteindocking_torch.eval_matrix\n"
        "import deeplocalproteindocking_torch.evaluation\n"
        "import deeplocalproteindocking_torch.parallel.batch_eval\n"
        "import deeplocalproteindocking_torch.data.polymer\n"
        "import deeplocalproteindocking_torch.train.data_gen\n"
        "import deeplocalproteindocking_torch.utils.logging\n"
        "from deeplocalproteindocking_torch.eval_matrix import (\n"
        "    heldout_complexes)\n"
        "heldout_complexes(1, widen=True, unbound=1.2, backbone=True)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('deeplocalproteindocking_tpu')]\n"
        "assert not bad, bad\n"
        "assert not opened, opened\n"
        "loaded = [m for m in sys.modules if m.endswith('_shared_config')]\n"
        "assert not loaded, loaded\n")
    env = {k: v for k, v in os.environ.items() if k != "DLPD_PLATFORM"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
