"""FFT-mined hard negatives: the false-positive mining loop.

Port of ``deeplocalproteindocking_tpu/train/mining.py``.  Periodically
the current model's global sweep (``sweep/resplat.dock_sweep_resplat``,
on the card K1 and K2 through the fused top-K tail) runs over training
complexes; each complex's top-K poses, labelled by their LRMSD, feed
back as decoys (``data_gen.make_training_batch(mined=...)``).  The
buffer holds CPU tensors and is saved as one npz keyed
``<name>/rotations|shifts|lrmsd``, the JAX package's layout, so each
package reads the other's file.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.fft import (
    coupled_receptor, resolve_engine)
from deeplocalproteindocking_torch.data.benchmark import (
    Complex, structure_to_device)
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.models.scoring import ScoringModel
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.resplat import dock_sweep_resplat
from deeplocalproteindocking_torch.train.decoys import (DecoySet,
                                                        label_decoys)
from deeplocalproteindocking_torch.train.scoring_path import train_lig_grid


def merge_mined(old: Optional[Dict[str, DecoySet]],
                new: Dict[str, DecoySet], cap: int = 96
                ) -> Dict[str, DecoySet]:
    """Persistent negative buffer: each complex keeps its most recent
    ``cap`` mined poses across rounds, so suppressing the newest false
    positives does not re-open earlier ones."""
    if old is None:
        return dict(new)
    out = dict(old)
    for k, ds in new.items():
        o = out.get(k)
        out[k] = ds if o is None else DecoySet(
            *(torch.cat([a, b])[-cap:] for a, b in zip(o, ds)))
    return out


def mine_hard_negatives(model: ScoringModel, cfg: DockConfig,
                        complexes: Sequence[Complex],
                        *,
                        n_rotations: int = 256,
                        top_k: int = 32,
                        max_atoms: Optional[int] = None
                        ) -> Dict[str, DecoySet]:
    """Global-sweep each complex with ``model`` (on its device, no
    gradients); its top-K poses as LRMSD-labelled decoys (CPU tensors),
    keyed by complex name."""
    device = model.coupling.device
    if max_atoms is None:
        max_atoms = max(max(len(c.receptor.typed()), len(c.ligand.typed()))
                        for c in complexes)
    rotations = super_fibonacci_rotations(n_rotations, device)
    impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
    out: Dict[str, DecoySet] = {}
    with torch.no_grad():
        for c in complexes:
            rc, rt, rm = structure_to_device(c.receptor.centered(),
                                             max_atoms, device=device)
            lc, lt, lm = structure_to_device(c.ligand.centered(), max_atoms,
                                             device=device)
            rec_vol = separable_splat(
                rc, rt, rm, grid_size=cfg.grid_size,
                resolution=cfg.resolution, sigma=cfg.sigma,
                num_types=cfg.num_atom_types)
            H = coupled_receptor(model.represent(rec_vol), model.coupling,
                                 impl)
            res = dock_sweep_resplat(
                H, lc, lt, lm, rotations, model.represent,
                grid_size=cfg.grid_size, lig_grid=train_lig_grid(cfg),
                resolution=cfg.resolution, sigma=cfg.sigma,
                num_types=cfg.num_atom_types, top_k=top_k,
                chunk=min(cfg.rotation_chunk, n_rotations), fft_impl=impl,
                dft_dtype=cfg.dft_dtype, fft_block=cfg.fft_block)
            nat = torch.as_tensor(
                ((c.ligand.center - c.receptor.center)
                 / cfg.resolution).astype(np.float32), device=device)
            ds = label_decoys(lc, lm, nat, rotations[res.rot_idx.long()],
                              res.shifts.to(torch.float32), cfg.resolution)
            out[c.name] = DecoySet(*(t.cpu() for t in ds))
    return out


def save_mined(path: str, mined: Dict[str, DecoySet]) -> None:
    """Write the buffer as one compressed npz (atomically)."""
    arrs = {f"{name}/{field}": np.asarray(v)
            for name, ds in mined.items()
            for field, v in zip(DecoySet._fields, ds)}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrs)
    os.replace(tmp, path)


def load_mined(path: str) -> Dict[str, DecoySet]:
    """Inverse of :func:`save_mined` (CPU tensors)."""
    with np.load(path) as z:
        names = sorted({k.rsplit("/", 1)[0] for k in z.files})
        return {name: DecoySet(*(torch.from_numpy(z[f"{name}/{field}"])
                                 for field in DecoySet._fields))
                for name in names}
