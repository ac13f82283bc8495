"""Time the block engine at 192^3 and 256^3, and its peak device memory.

Port of ``tools/measure_256.py``: the same protocol and one JSON line
per grid, with the same keys.  ``synthetic_complex(seed=3,
n_res_rec=120, n_res_lig=40)``, resolution 1.25, shape mode
(``rep_features=(8,)``, no weights), bf16 compute and DFT dtype, the
overlap-save ``block`` engine (``correlate/blockfft.py``), chunk 16,
top-K 32; a cold then a warm dock of ``n_rot`` rotations per grid.
``peak_mb`` is ``torch.cuda.max_memory_allocated``, reset before each
grid (None on the CPU).

    python -m deeplocalproteindocking_torch.measure_256 [n_rot] [grids]
        [--device cuda|cpu]

Defaults: 64 rotations, grids ``192,256``, the card.  Environment:
``M256_CHUNK`` (rotation chunk, default 16), ``M256_BLOCK`` (fft_block,
default 64).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.pipeline import DockingPipeline


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(n_rot: int = 64, grids=(192, 256), device="cuda",
            chunk: int = 16, block: int = 64):
    """One dict per grid: cold and warm seconds of a dock, ms per
    rotation (warm) and the peak device memory in MiB."""
    device = torch.device(device)
    cplx = synthetic_complex(seed=3, n_res_rec=120, n_res_lig=40)
    rec, lig = cplx.receptor.centered(), cplx.ligand.centered()
    out = []
    for grid in grids:
        cfg = DockConfig(grid_size=grid, resolution=1.25, rep_features=(8,),
                         num_rotations=n_rot, rotation_chunk=chunk, top_k=32,
                         fft_impl="block", fft_block=block,
                         compute_dtype="bfloat16", dft_dtype="bfloat16")
        pipe = DockingPipeline(cfg, device=device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(2):                   # cold, then warm
            _sync(device)
            t0 = time.perf_counter()
            poses = pipe.dock(rec, lig)
            _sync(device)
            times.append(time.perf_counter() - t0)
        peak = (round(torch.cuda.max_memory_allocated(device) / 2 ** 20)
                if device.type == "cuda" else None)
        out.append(dict(grid=grid, n_rot=n_rot, chunk=chunk,
                        fft_block=block, cold_s=round(times[0], 2),
                        warm_s=round(times[1], 2),
                        ms_per_rot=round(times[1] / n_rot * 1e3, 2),
                        peak_mb=peak,
                        top_score=float(np.asarray(poses.scores)[0])))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_rot", nargs="?", type=int, default=64)
    p.add_argument("grids", nargs="?", default="192,256")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible; pass "
                         "--device cpu to run on the CPU")
    for row in measure(args.n_rot, [int(g) for g in args.grids.split(",")],
                       args.device,
                       chunk=int(os.environ.get("M256_CHUNK", 16)),
                       block=int(os.environ.get("M256_BLOCK", 64))):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
