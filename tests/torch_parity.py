"""Shared helpers for the torch port's parity tests (not a test module).

Each ``tests/test_torch_*.py`` feeds the same numpy inputs, made from a
seed, to a JAX function and to its counterpart in
``deeplocalproteindocking_torch`` on the CPU, in float32 (the JAX side
at ``jax_default_matmul_precision="highest"``, set by conftest.py), and
holds the two results together at a stated tolerance.
"""
import os

import numpy as np
import pytest
import torch

# The tier-1 run uses several pytest workers on one machine.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V9P_DIR = os.path.join(ROOT, "pretrained", "synthetic-v9p")
V9P_CKPT = os.path.join(V9P_DIR, "best")
V9P_NPZ = os.path.join(V9P_DIR, "best_params.npz")


def np_(x) -> np.ndarray:
    """A JAX array or torch tensor as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x, dtype=None) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def assert_same_multiset(got, want, rtol, atol):
    """Top-K values compared as sorted multisets (tie order may differ)."""
    np.testing.assert_allclose(np.sort(np_(got), axis=-1),
                               np.sort(np_(want), axis=-1),
                               rtol=rtol, atol=atol)


def v9p_config():
    """The v9p checkpoint's DockConfig (port class) as stored."""
    from deeplocalproteindocking_torch.config import DockConfig
    with open(os.path.join(V9P_CKPT, "config.json")) as f:
        return DockConfig.from_json(f.read())


def jax_config(cfg):
    """The same configuration as the JAX package's DockConfig."""
    from deeplocalproteindocking_tpu.config import DockConfig
    return DockConfig.from_json(cfg.to_json())


def v9p_flat() -> dict:
    """Exported v9p params, flat ``"a/b/c" -> np.ndarray``."""
    with np.load(V9P_NPZ) as z:
        return {k: z[k] for k in z.files}


def v9p_flax_params() -> dict:
    """The exported params as a nested flax tree for the JAX package."""
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({k: jnp.asarray(v) for k, v in v9p_flat().items()},
                          sep="/")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
