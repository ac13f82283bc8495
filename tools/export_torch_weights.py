"""Export a JAX checkpoint's params to a flat ``.npz`` for the torch port.

The PyTorch port (``deeplocalproteindocking_torch``) cannot read Orbax
checkpoints, which need JAX.  This tool restores a checkpoint directory
with the JAX trainer, flattens the flax parameter tree to ``/``-joined
keys and writes them with ``np.savez``; the port loads the file with
``deeplocalproteindocking_torch.weights.load_npz``.

    python tools/export_torch_weights.py [ckpt_dir] [out.npz]

Defaults: ``pretrained/synthetic-v9p/best`` ->
``pretrained/synthetic-v9p/best_params.npz``.
"""
from __future__ import annotations

import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
DEFAULT_CKPT = os.path.join(_ROOT, "pretrained", "synthetic-v9p", "best")
DEFAULT_OUT = os.path.join(_ROOT, "pretrained", "synthetic-v9p",
                           "best_params.npz")


def restored_params(ckpt_dir: str) -> dict:
    """Flat ``{"a/b/c": np.ndarray}`` params of a restored checkpoint."""
    from flax.traverse_util import flatten_dict

    from deeplocalproteindocking_tpu.config import DockConfig
    from deeplocalproteindocking_tpu.train.trainer import Trainer
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = DockConfig.from_json(f.read())
    state = Trainer(cfg).restore(ckpt_dir)
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in flatten_dict(state.params, sep="/").items()}


def main(argv):
    ckpt = argv[1] if len(argv) > 1 else DEFAULT_CKPT
    out = argv[2] if len(argv) > 2 else DEFAULT_OUT
    flat = restored_params(ckpt)
    np.savez(out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {out}: {len(flat)} arrays, {n} floats")


if __name__ == "__main__":
    main(sys.argv)
