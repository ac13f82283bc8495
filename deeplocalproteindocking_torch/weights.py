"""Checkpoint weights: the flax parameter tree -> the port's state_dict.

Checkpoints are Orbax directories written by the JAX trainer;
``train/checkpoint.py`` reads them without JAX into flat dicts with
``/``-joined keys, e.g. ``coupling`` and
``representation/cnn/conv0/kernel`` (the layout of the ``.npz`` files
that ``tools/export_torch_weights.py`` writes, such as
``pretrained/synthetic-v9p/best_params.npz``); this module maps such a
flat dict onto ``ScoringModel``'s state_dict.

Flax conv kernels are ``[kx, ky, kz, C_in, C_out]``; torch's are
``[C_out, C_in, kx, ky, kz]``.  A whole training state (params, optax's
Adam moments, the update count) comes across the same way
(:func:`train_state_from_numpy`), so the port can resume a JAX run.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

_CONV = re.compile(r"^(.*)conv(\d+)/(kernel|bias)$")


def params_from_numpy(flat: dict) -> dict:
    """Flat flax params (``"a/b/conv0/kernel" -> array``) -> state_dict."""
    out = {}
    for key, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        if key == "coupling":
            out["coupling"] = torch.from_numpy(arr.copy())
            continue
        m = _CONV.match(key)
        if m is None:
            raise KeyError(f"unexpected parameter {key!r}")
        prefix, idx, kind = m.groups()
        name = prefix.replace("/", ".") + f"convs.{idx}."
        if kind == "kernel":
            out[name + "weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(4, 3, 0, 1, 2)))
        else:
            out[name + "bias"] = torch.from_numpy(arr.copy())
    return out


def load_npz(path: str | os.PathLike) -> dict:
    """Load an exported ``best_params.npz`` as a state_dict."""
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files})


def train_state_from_numpy(flat_params: dict, flat_mu: dict,
                           flat_nu: dict, count: int,
                           step: Optional[int] = None):
    """A JAX trainer's state as the port's ``TrainState``: flat flax
    params and optax's Adam moments (``mu``, ``nu``, the same keys), its
    update count and its step (default: the count).  Moments map like
    their params (conv kernels transposed).  No data-generator state:
    JAX's PRNG streams cannot be continued in torch."""
    from deeplocalproteindocking_torch.train.trainer import TrainState
    opt = {"mu": params_from_numpy(flat_mu), "nu": params_from_numpy(flat_nu),
           "count": int(count)}
    return TrainState(params_from_numpy(flat_params), opt,
                      int(count if step is None else step), None)

