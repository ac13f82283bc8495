"""Put ``dockbench/`` and the repository root on the import path, and
give the tests a tiny copy of a cell that runs on the CPU."""
from __future__ import annotations

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def tiny(name: str) -> dict:
    """Cell ``name`` as its files give it, cut to a size the CPU runs in
    seconds: grid 48, 64 rotations, top-K 32, the checkpoint cell's 30-40-residue
    ligands (docking) or the training band (training)."""
    from lib import bench
    cell = copy.deepcopy(bench.cell_spec(name))
    cfg = cell["config"]["dock_config"]
    if cell["traffic"]["kind"] == "dock":
        cfg.update(grid_size=48, num_rotations=64, rotation_chunk=16,
                   top_k=32, lig_grid_size=None)
        cell["traffic"].update(pool="ckpt-r300-l30-40", warmup_rotations=16,
                               trace_requests=2, lean_requests=1)
        cell["limits"]["n_sample"] = 64
    else:
        cfg.update(grid_size=48, lig_grid_size=None, num_decoys=8,
                   rotation_chunk=8)
        cell["traffic"].update(mine_rotations=8, trace_steps=2, lean_steps=2)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
