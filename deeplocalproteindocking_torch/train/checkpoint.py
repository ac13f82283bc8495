"""The JAX package's Orbax checkpoints, read without JAX.

``Trainer.save`` of the JAX package (its ``train/trainer.py``) writes a
``StandardCheckpointer`` step directory ``step_%08d/``: ``_METADATA``
(JSON; the tree's keys as tuples such as ``('params', 'representation',
'cnn', 'conv0', 'kernel')``) and an OCDBT store whose zarr arrays are
named by those keys joined with ``.``.  The tree is

* ``params``: the flax parameters;
* ``opt_state``: optax's chain state, ``0`` Adam's ``count``, ``mu`` and
  ``nu`` (the schedule's own ``count`` follows from v4 on; v1-v3 have an
  empty second state);
* ``step``: the trainer's step;
* ``key``: the run's PRNG key data, read and dropped (JAX's streams
  cannot be continued in torch, as ``weights.train_state_from_numpy``
  says).

:func:`load_train_state` turns a step into the port's ``TrainState``
through ``weights.params_from_numpy`` / ``train_state_from_numpy`` (or
reads the port's own ``state.pt`` where ``Trainer.save`` wrote one),
taking the latest step when none is given, as the JAX ``Trainer.restore``
does.  Only a ``ckpt_dir`` whose ``step_*`` hold no checkpoint raises
``FileNotFoundError``; a damaged step raises ``ValueError``
(``OcdbtError``, ``ZarrError``)::

    state = load_train_state("pretrained/synthetic-v9p/best")
"""
from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplocalproteindocking_torch.utils.ocdbt import OcdbtStore
from deeplocalproteindocking_torch.utils.zarr import read_array

__all__ = ["is_orbax_step", "latest_step", "load_params", "load_train_state",
           "params_or_npz", "read_tree", "step_path"]

_STEP = re.compile(r"^step_(\d+)$")


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def is_orbax_step(path: str) -> bool:
    """Whether ``path`` is an Orbax step directory."""
    return os.path.exists(os.path.join(path, "_METADATA"))


def latest_step(ckpt_dir: str) -> int:
    """The highest ``step_*`` of ``ckpt_dir`` that holds a checkpoint (a
    port ``state.pt`` or an Orbax step); ``FileNotFoundError`` if none
    does."""
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP.match(d)
        full = os.path.join(ckpt_dir, d)
        if m and (is_orbax_step(full)
                  or os.path.exists(os.path.join(full, "state.pt"))):
            steps.append(int(m.group(1)))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return max(steps)


def read_tree(path: str) -> Dict[Tuple[str, ...], np.ndarray]:
    """Every array of the Orbax step directory ``path``, by its key tuple
    (``('opt_state', '0', 'mu', 'coupling')``).  Leaves that Orbax stored
    no data for (``opt_state``'s empty states) are left out."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are "
                         f"read")
    store = OcdbtStore(path)
    tree = {}
    for key, info in meta["tree_metadata"].items():
        value = info["value_metadata"]
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            continue
        names = tuple(ast.literal_eval(key))
        arr = read_array(store, ".".join(names))
        if list(arr.shape) != list(value.get("write_shape", arr.shape)):
            raise ValueError(f"{path}: {names} has shape {arr.shape}, its "
                             f"metadata says {value['write_shape']}")
        tree[names] = arr
    return tree


def _flat(tree, prefix: Tuple[str, ...]) -> Dict[str, np.ndarray]:
    n = len(prefix)
    return {"/".join(k[n:]): v for k, v in tree.items() if k[:n] == prefix}


def _step(ckpt_dir: str, step: Optional[int]) -> Tuple[str, str]:
    """``ckpt_dir``'s step directory (default: the latest step) and the
    path of its port ``state.pt``."""
    step = latest_step(ckpt_dir) if step is None else step
    path = step_path(ckpt_dir, step)
    return path, os.path.join(path, "state.pt")


def _read_orbax(path: str):
    if not is_orbax_step(path):
        raise FileNotFoundError(f"{path} holds no checkpoint")
    return read_tree(path)


def load_params(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The params of ``ckpt_dir``'s step (default: the latest) as the
    port's state_dict on the CPU: the step's ``state.pt``
    (``Trainer.save``) or its Orbax checkpoint."""
    from deeplocalproteindocking_torch import weights
    path, pt = _step(ckpt_dir, step)
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)["params"]
    return weights.params_from_numpy(_flat(_read_orbax(path), ("params",)))


def params_or_npz(ckpt_dir: str, npz: str) -> dict:
    """:func:`load_params` of ``ckpt_dir``'s latest step or, where no
    step holds a checkpoint, the exported params file ``npz``.  A damaged
    step raises ``ValueError`` and never falls back."""
    from deeplocalproteindocking_torch import weights
    try:
        return load_params(ckpt_dir)
    except FileNotFoundError:
        if not os.path.exists(npz):
            raise FileNotFoundError(
                f"no step_* with a state.pt or an Orbax checkpoint, and "
                f"no {npz}") from None
    return weights.load_npz(npz)


def load_train_state(ckpt_dir: str, step: Optional[int] = None):
    """``ckpt_dir``'s step (default: the latest) as the port's
    ``TrainState`` on the CPU: the step's ``state.pt``, else its Orbax
    checkpoint (params, Adam's moments and count, the step; no generator
    state)."""
    from deeplocalproteindocking_torch import weights
    from deeplocalproteindocking_torch.train.trainer import TrainState
    path, pt = _step(ckpt_dir, step)
    if os.path.exists(pt):
        return TrainState(**torch.load(pt, map_location="cpu",
                                       weights_only=True))
    tree = _read_orbax(path)
    return weights.train_state_from_numpy(
        _flat(tree, ("params",)), _flat(tree, ("opt_state", "0", "mu")),
        _flat(tree, ("opt_state", "0", "nu")),
        int(tree[("opt_state", "0", "count")]), step=int(tree[("step",)]))
