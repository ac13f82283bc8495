"""Export a JAX checkpoint's params to a flat ``.npz`` for the torch port.

The PyTorch port (``deeplocalproteindocking_torch``) cannot read Orbax
checkpoints, which need JAX.  This tool restores a checkpoint directory
with the JAX trainer, flattens the flax parameter tree to ``/``-joined
keys and writes them with ``np.savez``; the port loads the file with
``deeplocalproteindocking_torch.weights.load_npz``.

    python tools/export_torch_weights.py [ckpt_dir] [out.npz]
    python tools/export_torch_weights.py --train-state ckpt_dir out.npz

Defaults: ``pretrained/synthetic-v9p/best`` ->
``pretrained/synthetic-v9p/best_params.npz``.  With ``--train-state`` the
file holds the whole training state of the checkpoint: ``params/<key>``,
optax's Adam moments ``mu/<key>`` and ``nu/<key>``, their update
``count`` and the trainer's ``step``; the port reads it with
``weights.load_train_state`` and can resume the run from there.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
DEFAULT_CKPT = os.path.join(_ROOT, "pretrained", "synthetic-v9p", "best")
DEFAULT_OUT = os.path.join(_ROOT, "pretrained", "synthetic-v9p",
                           "best_params.npz")


def _flat(tree) -> dict:
    from flax.traverse_util import flatten_dict
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in flatten_dict(tree, sep="/").items()}


def restored_state(ckpt_dir: str):
    """The JAX ``TrainState`` of a checkpoint directory."""
    from deeplocalproteindocking_tpu.config import DockConfig
    from deeplocalproteindocking_tpu.train.trainer import Trainer
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = DockConfig.from_json(f.read())
    return Trainer(cfg).restore(ckpt_dir)


def restored_params(ckpt_dir: str) -> dict:
    """Flat ``{"a/b/c": np.ndarray}`` params of a restored checkpoint."""
    return _flat(restored_state(ckpt_dir).params)


def train_state_arrays(state) -> dict:
    """A JAX ``TrainState`` as flat arrays: ``params/<key>``, ``mu/<key>``,
    ``nu/<key>`` (optax's ``ScaleByAdamState``), ``count``, ``step``."""
    import jax
    import optax
    adam = [s for s in jax.tree_util.tree_leaves(
                state.opt_state,
                is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state, found {len(adam)}")
    out = {}
    for part, tree in (("params", state.params), ("mu", adam[0].mu),
                       ("nu", adam[0].nu)):
        out.update({f"{part}/{k}": v for k, v in _flat(tree).items()})
    out["count"] = np.asarray(adam[0].count, dtype=np.int64)
    out["step"] = np.asarray(state.step, dtype=np.int64)
    return out


def main(argv):
    ap = argparse.ArgumentParser(
        prog="python tools/export_torch_weights.py",
        description="Export a JAX checkpoint for the torch port.")
    ap.add_argument("ckpt", nargs="?", default=DEFAULT_CKPT)
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--train-state", action="store_true",
                    help="also write the optimizer state and step")
    args = ap.parse_args(argv[1:])
    if args.train_state:
        out = args.out or args.ckpt.rstrip("/") + "_train_state.npz"
        flat = train_state_arrays(restored_state(args.ckpt))
    else:
        out = args.out or DEFAULT_OUT
        flat = restored_params(args.ckpt)
    np.savez(out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {out}: {len(flat)} arrays, {n} values")


if __name__ == "__main__":
    main(sys.argv)
