"""Write seeded weights for a configuration that has no trained checkpoint.

    python3 dockbench/tools/make_weights.py [--seed 0]

Writes ``dockbench/data/full-sweep-seed<seed>.npz``: the ``full-sweep``
preset's model (``Representation((32, 32, 16))`` on 11 atom types,
3^3 kernels, biases, no shape channels, a 16 x 16 coupling) in the flax
layout that ``weights.params_from_numpy`` and the plain reference's
``Weights`` both read (``representation/conv<i>/kernel`` as ``[kx, ky,
kz, I, O]``, ``representation/conv<i>/bias``, ``coupling``), all
float32, drawn from one CPU ``torch.Generator`` seeded with ``seed``:

* kernels by the port's own lecun-normal init
  (``Representation.reset_parameters``);
* biases normal with std 0.1 (nonzero, so the bias path counts);
* the coupling dense, normal with std 1/sqrt(C) (so every cross-channel
  term counts).

The file's bytes depend on the seed alone (fixed zip entry dates), so
the same seed writes the same file.
"""
from __future__ import annotations

import argparse
import io
import math
import os
import sys
import zipfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))

FEATURES, KERNEL, ATOM_TYPES = (32, 32, 16), 3, 11
BIAS_STD = 0.1


def weights(seed: int) -> dict:
    """The flat flax arrays of ``seed`` (see the module's docstring)."""
    import torch
    from deeplocalproteindocking_torch.models.representation import (
        Representation)
    gen = torch.Generator().manual_seed(seed)
    rep = Representation(ATOM_TYPES, FEATURES, KERNEL)
    rep.reset_parameters(gen)
    flat = {}
    for i, conv in enumerate(rep.convs):
        key = f"representation/conv{i}/"
        flat[key + "kernel"] = conv.weight.detach().numpy().transpose(
            2, 3, 4, 1, 0)
        flat[key + "bias"] = (BIAS_STD * torch.randn(
            conv.out_channels, generator=gen)).numpy()
    c = FEATURES[-1]
    flat["coupling"] = (torch.randn(c, c, generator=gen)
                        / math.sqrt(c)).numpy()
    return {k: np.ascontiguousarray(v, np.float32) for k, v in flat.items()}


def write_npz(path: str, arrays: dict) -> None:
    """An ``np.load``-able ``.npz`` whose bytes depend on ``arrays`` alone:
    entries in sorted order, each dated 1980-01-01, stored."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for key in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arrays[key], allow_pickle=False)
            info = zipfile.ZipInfo(key + ".npy", (1980, 1, 1, 0, 0, 0))
            z.writestr(info, buf.getvalue())


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    path = a.out or os.path.join(BENCH, "data",
                                 f"full-sweep-seed{a.seed}.npz")
    write_npz(path, weights(a.seed))
    print(path)


if __name__ == "__main__":
    main()
