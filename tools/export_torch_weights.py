"""Export a JAX checkpoint's params to a flat ``.npz``.

The PyTorch port (``deeplocalproteindocking_torch``) reads the JAX
trainer's Orbax checkpoints itself (``train/checkpoint.py``), so this
export is no longer needed to dock, evaluate or resume there.  It stays
for the files it wrote, which the port still loads where a checkpoint
directory has no steps (``deeplocalproteindocking_torch.weights.load_npz``):
it restores a checkpoint directory with the JAX trainer, flattens the
flax parameter tree to ``/``-joined keys and writes them with
``np.savez``.

    python tools/export_torch_weights.py [ckpt_dir] [out.npz]

Defaults: ``pretrained/synthetic-v9p/best`` ->
``pretrained/synthetic-v9p/best_params.npz``.
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


def main(argv):
    ap = argparse.ArgumentParser(
        prog="python tools/export_torch_weights.py",
        description="Export a JAX checkpoint for the torch port.")
    ap.add_argument("ckpt", nargs="?", default=DEFAULT_CKPT)
    ap.add_argument("out", nargs="?", default=None)
    args = ap.parse_args(argv[1:])
    out = args.out or DEFAULT_OUT
    flat = restored_params(args.ckpt)
    np.savez(out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {out}: {len(flat)} arrays, {n} values")


if __name__ == "__main__":
    main(sys.argv)
