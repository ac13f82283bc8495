"""Make a committed pool of synthetic complexes for the benchmark.

    python dockbench/tools/make_pool.py <pool> [--workers N]

Builds complexes from successive seeds with the frozen copy of the
port's generator (``frozen_generator.py``), keeps those that pass the
pool's filter, and writes ``dockbench/data/<pool>.npz``: every kept
complex's receptor and ligand as coordinates (float32, receptor frame,
ligand in its native pose), atom types and residue ids, concatenated,
with offsets.  Set-up of a run reads the file instead of paying seconds
of generation per complex.
"""
from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import frozen_generator as gen                    # noqa: E402
from reference.geometry import ligand_box        # noqa: E402

# name -> (size of the pool, first seed, generator keywords of a seed,
#          filter on the centered typed ligand coordinates)
POOLS = {
    # 300 + 250-residue polymer complexes whose ligand's own box at grid
    # 128 (1.25 A, receptive field 3) is 72 and whose ligand pads to the
    # same 2,176 atoms (buckets of 64): every request does the same work.
    "large-r300-l250": (16, 0, lambda s: dict(
        seed=s, n_res_rec=300, n_res_lig=250, backbone=True),
        lambda lig: ligand_box(lig, 1.25, 1.0, 3, 128) == 72
        and 2112 < len(lig) <= 2176),
    # 300-residue polymer receptors with 30-40-residue ligands that fit
    # the v9p checkpoint's fixed box 40 at grid 64.
    "ckpt-r300-l30-40": (16, 1000, lambda s: dict(
        seed=s, n_res_rec=300, n_res_lig=30 + s % 11, backbone=True),
        lambda lig: ligand_box(lig, 1.25, 1.0, 3, 64) <= 40),
    # The v9p recipe's training band: seeds 200+, the widened sizes,
    # unbound 1.2 A.
    "train-band-200": (16, 200, lambda s: dict(
        seed=s, n_res_rec=12 + (s - 200) % 9,
        n_res_lig=6 + ((s - 200) // 9) % 5, unbound_rmsd=1.2),
        lambda lig: True),
}


def _make(args):
    name, seed = args
    _, _, kw, keep = POOLS[name]
    c = gen.synthetic_complex(**kw(seed))
    lig = c.ligand.coords[c.ligand.types >= 0]
    lig = lig - c.ligand.coords.mean(0)
    if not keep(lig):
        return None
    return seed, c


def main():
    p = argparse.ArgumentParser()
    p.add_argument("pool", choices=sorted(POOLS))
    p.add_argument("--workers", type=int, default=2)
    a = p.parse_args()
    size, seed0, _, _ = POOLS[a.pool]
    kept, seed = [], seed0
    with ProcessPoolExecutor(a.workers) as ex:
        while len(kept) < size:
            batch = [(a.pool, s) for s in range(seed, seed + a.workers)]
            seed += a.workers
            for r in ex.map(_make, batch):
                if r is not None and len(kept) < size:
                    kept.append(r)
                    print(f"kept seed {r[0]} ({len(kept)}/{size})",
                          flush=True)
    out = {"seeds": np.asarray([s for s, _ in kept], np.int64)}
    for side in ("receptor", "ligand"):
        parts = [getattr(c, side) for _, c in kept]
        key = side[:3]
        out[f"{key}_xyz"] = np.concatenate([s.coords for s in parts]
                                           ).astype(np.float32)
        out[f"{key}_types"] = np.concatenate([s.types for s in parts]
                                             ).astype(np.int8)
        out[f"{key}_res"] = np.concatenate([s.res_ids for s in parts]
                                           ).astype(np.int16)
        out[f"{key}_off"] = np.cumsum([0] + [len(s) for s in parts]
                                      ).astype(np.int64)
    path = os.path.join(os.path.dirname(HERE), "data", f"{a.pool}.npz")
    np.savez_compressed(path, **out)
    print(path)


if __name__ == "__main__":
    main()
