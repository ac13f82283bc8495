"""Training-batch helpers: for now only the native voxel shift.

Port of ``native_voxel_shift`` from
``deeplocalproteindocking_tpu/train/data_gen.py``; the local docking
protocol of ``evaluation.py`` centres its translation window there.  The
rest of that module (batch assembly, decoy sets, the ligand-box fit)
waits for the port of training.
"""
from __future__ import annotations

import numpy as np

from deeplocalproteindocking_torch.data.benchmark import Complex


def native_voxel_shift(cplx: Complex, resolution: float) -> np.ndarray:
    """Native ligand placement as an integer voxel shift."""
    t = (cplx.ligand.center - cplx.receptor.center) / resolution
    return np.round(t).astype(np.int32)
