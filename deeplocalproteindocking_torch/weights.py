"""Checkpoint weights: the flax parameter tree -> the port's state_dict.

Checkpoints are Orbax directories written by the JAX trainer; reading
them needs JAX.  ``tools/export_torch_weights.py`` (run where JAX is
installed) flattens a restored tree into an ``.npz`` with ``/``-joined
keys, e.g. ``coupling`` and ``representation/cnn/conv0/kernel``; this
module maps such a flat dict onto ``ScoringModel``'s state_dict.

Flax conv kernels are ``[kx, ky, kz, C_in, C_out]``; torch's are
``[C_out, C_in, kx, ky, kz]``.
"""
from __future__ import annotations

import os
import re

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
