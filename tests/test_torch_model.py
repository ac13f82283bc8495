"""Torch port vs JAX package: shape channels, the CNN, the scoring model,
the exported v9p weights and the rank-3 folded ligand rep_fn."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (V9P_CKPT, jax_config, np_, t_, v9p_config,
                          v9p_flat, v9p_flax_params)

from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.models.representation import (
    shape_channels as t_shape_channels)
from deeplocalproteindocking_torch.models.scoring import ScoringModel
from deeplocalproteindocking_torch.pipeline import (
    DockingPipeline, coupling_deviation_capture, min_licensed_rank)
from deeplocalproteindocking_tpu.data import benchmark as jbench
from deeplocalproteindocking_tpu.grids.voxelize import separable_splat
from deeplocalproteindocking_tpu.models.representation import (
    shape_channels as j_shape_channels)
from deeplocalproteindocking_tpu.models.scoring import (
    ScoringModel as JScoringModel)
from deeplocalproteindocking_tpu import pipeline as jpipe


def _density(seed=0, L=32, n_rot=0):
    """A real splat density (numpy), optionally of rotated copies."""
    lig = jbench.synthetic_complex(seed, 30, 15).ligand.centered()
    c, t, m = jbench.structure_to_device(lig, bucket=64)
    kw = dict(grid_size=L, resolution=1.25, sigma=1.0, num_types=11)
    if not n_rot:
        return np_(separable_splat(c, t, m, **kw))
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations)
    R = super_fibonacci_rotations(n_rot)
    return np.stack([np_(separable_splat(jnp.einsum("ij,nj->ni", r, c),
                                         t, m, **kw)) for r in R])


@pytest.mark.parametrize("n_rot", [0, 3])
def test_shape_channels_exact(n_rot):
    vol = _density(1, 32, n_rot)
    got, gc = t_shape_channels(t_(vol))
    want, wc = j_shape_channels(jnp.asarray(vol))
    np.testing.assert_array_equal(np_(got), np_(want))
    np.testing.assert_array_equal(np_(gc), np_(wc))


def test_params_from_numpy_layout():
    sd = weights.load_npz(
        V9P_CKPT.replace("best", "best_params.npz"))
    flat = v9p_flat()
    assert set(sd) == {"coupling", "representation.cnn.convs.0.weight",
                       "representation.cnn.convs.1.weight"}
    np.testing.assert_array_equal(np_(sd["coupling"]), flat["coupling"])
    k1 = flat["representation/cnn/conv1/kernel"]          # [x, y, z, i, o]
    w1 = np_(sd["representation.cnn.convs.1.weight"])     # [o, i, x, y, z]
    assert w1.shape == (14, 32, 3, 3, 3)
    np.testing.assert_array_equal(w1[5, 7, 0, 1, 2], k1[0, 1, 2, 7, 5])
    assert sum(v.numel() for v in sd.values()) == 21856
    # Plain (biased) models map too.
    sd2 = weights.params_from_numpy({
        "coupling": np.eye(4, dtype=np.float32),
        "representation/conv0/kernel": np.zeros((3, 3, 3, 11, 4), np.float32),
        "representation/conv0/bias": np.ones(4, np.float32)})
    ScoringModel(features=(4,)).load_state_dict(sd2)


def test_exported_npz_equals_orbax_restore():
    """best_params.npz is exactly what the Orbax checkpoint restores."""
    from deeplocalproteindocking_tpu.config import DockConfig
    from deeplocalproteindocking_tpu.train.trainer import Trainer
    from flax.traverse_util import flatten_dict
    with open(f"{V9P_CKPT}/config.json") as f:
        cfg = DockConfig.from_json(f.read())
    restored = flatten_dict(Trainer(cfg).restore(V9P_CKPT).params, sep="/")
    flat = v9p_flat()
    assert set(flat) == set(restored)
    for k, v in restored.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


def test_represent_v9p_matches_flax():
    cfg = v9p_config()
    vol = _density(2, 24, 2)                      # [2, 24, 24, 24, 11]
    model = ScoringModel(features=cfg.rep_features, shape_prior=True)
    model.load_state_dict(weights.params_from_numpy(v9p_flat()))
    with torch.no_grad():
        got = model.represent(t_(vol))
    jm = JScoringModel(features=cfg.rep_features, shape_prior=True)
    want = jm.apply({"params": v9p_flax_params()}, jnp.asarray(vol),
                    method=jm.represent)
    assert got.shape == want.shape == (2, 24, 24, 24, 16)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-4, atol=1e-4)


def test_represent_plain_biased_model_matches_flax():
    rng = np.random.default_rng(4)
    jm = JScoringModel(features=(6, 5))
    jp = jm.init(jax.random.key(0), jnp.zeros((8, 8, 8, 11)),
                 jnp.zeros((8, 8, 8, 11)))["params"]
    jp = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jp)
    from flax.traverse_util import flatten_dict
    flat = {k: np.asarray(v) for k, v in flatten_dict(jp, sep="/").items()}
    model = ScoringModel(features=(6, 5))
    model.load_state_dict(weights.params_from_numpy(flat))
    vol = rng.normal(size=(12, 12, 12, 11)).astype(np.float32)
    with torch.no_grad():
        got = model.represent(t_(vol))
    want = jm.apply({"params": jp}, jnp.asarray(vol), method=jm.represent)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-4, atol=1e-4)


def test_folded_rank3_rep_fn_matches_jax():
    cfg = v9p_config().replace(coupling_rank=3, grid_size=32)
    sd = weights.params_from_numpy(v9p_flat())
    pipe = DockingPipeline(cfg, params=sd, device="cpu")
    proj_rec, rep_fn = pipe._spectral_parts(pipe.params["coupling"])
    jp = jpipe.DockingPipeline(config=jax_config(cfg))
    jp.params = v9p_flax_params()
    j_proj_rec, j_rep_fn = jp._spectral_parts(jp.params["coupling"])
    np.testing.assert_array_equal(np_(proj_rec), np_(j_proj_rec))
    vol = _density(3, 24, 2)
    got = rep_fn(t_(vol))
    want = j_rep_fn(jnp.asarray(vol))
    assert got.shape == want.shape == (2, 24, 24, 24, 3)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-4, atol=1e-4)


def test_rank_license_matches_jax():
    A = v9p_flat()["coupling"]
    for r in (2, 3, 4):
        assert (coupling_deviation_capture(A, r, shape_prior=True)
                == jpipe.coupling_deviation_capture(A, r, shape_prior=True))
    assert min_licensed_rank(A, shape_prior=True) == 3
    pipe = DockingPipeline(v9p_config().replace(coupling_rank=2),
                           params=weights.params_from_numpy(v9p_flat()),
                           device="cpu")
    with pytest.warns(UserWarning, match="coupling_rank=2"):
        pipe._spectral_parts_uncached(pipe.params["coupling"])


def test_init_params_seeded_and_shape_block():
    cfg = v9p_config()
    a = DockingPipeline(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    b = DockingPipeline(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # The untrained hybrid scores exactly shape complementarity.
    want = np.zeros((16, 16), np.float32)
    want[0, 0], want[1, 1] = 1.0, -12.0
    np.testing.assert_array_equal(np_(a["coupling"]), want)
    w = np_(a["representation.cnn.convs.0.weight"])
    std = np.sqrt(1.0 / (27 * 11))
    assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert 0.7 * std < w.std() < 1.3 * std
