#!/usr/bin/env python3
"""Where a warm query's (and a train step's) time goes on the card.

    python3 tools/profile_torch_dock.py      # from the repository root

The configuration of ``chip_smoke.py`` phases 3 and 5: the v9p hybrid
model, rank-3 folded coupling, bf16, grid 128, top-K 64, chunk 128,
2,048 rotations.  For each engine (``dft_fused``, the main path, and
``dft_pallas``) one ``DockingService`` docks the receptor of seed 0
against the ligand of seed 0 (warm-up), then, under ``torch.profiler``,
against the ligand of seed 1: ``dock`` and ``rescore(top=16, nrot=48)``.
Then the training cell of ``chip_smoke.py`` phase 9 (the committed v9p
``config.json``: grid 64, box 40, 24 decoys x 2 complexes, float32):
after one warm-up step, one train step with its batch assembly, and one
mining round (4 training complexes x 320 rotations, top-K 24).  Then the
cells of ``chip_smoke.py`` phase 11 at the v9p config (float32, C = 16):
a block-engine dock at grid 256 (block 64, 256 rotations) and a
resample dock at grid 64 (2,048 rotations), each after a warm-up dock;
and the block engine's cuFFT sizes: the inverse transform of one block
(16 boxes of M^3) and the forward one of a 16-channel tile at M = 96,
104 (the engine's M at box 40, block 64), 112 and 128, with the boxes or
channels innermost and outermost, timed with CUDA events.
Prints one JSON line per stage: host-clock wall (profiler overhead
included), device busy time (the union of kernel intervals), the idle
share, the largest kernels by total device time, and every kernel of
the port's own (``csrc/``) with its calls and time.
"""
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from deeplocalproteindocking_torch import weights  # noqa: E402
from deeplocalproteindocking_torch.config import DockConfig  # noqa: E402
from deeplocalproteindocking_torch.data import synthetic_complex  # noqa: E402
from deeplocalproteindocking_torch.data.benchmark import synthetic_band  # noqa: E402
from deeplocalproteindocking_torch.pipeline import DockingPipeline  # noqa: E402
from deeplocalproteindocking_torch.serving import DockingService  # noqa: E402
from deeplocalproteindocking_torch.train import Trainer  # noqa: E402
from deeplocalproteindocking_torch.train.data_gen import (  # noqa: E402
    make_training_batch)
from deeplocalproteindocking_torch.train.mining import (  # noqa: E402
    mine_hard_negatives)


def busy_ms(kernels):
    """Length of the union of the kernels' [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for k in sorted(kernels, key=lambda e: e.time_range.start):
        s, e = k.time_range.start, k.time_range.end
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def stage(name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for k in kernels:
        n, t = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (n + 1, t + (k.time_range.end
                                       - k.time_range.start) / 1e3)
    busy = busy_ms(kernels)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(json.dumps(dict(
        stage=name, wall_ms=wall, device_busy_ms=busy,
        idle_share=1.0 - busy / wall, kernels=len(kernels),
        top=[dict(name=n[:90], calls=c, ms=t) for n, (c, t) in ranked[:12]],
        port_kernels=[dict(name=n[:90], calls=c, ms=t)
                      for n, (c, t) in ranked if "dlpd::" in n])),
        flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("tools/profile_torch_dock.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = weights.load_npz(os.path.join(
        ROOT, "pretrained", "synthetic-v9p", "best_params.npz"))
    cfg = DockConfig(
        grid_size=128, resolution=1.25, rep_features=(32, 14),
        shape_prior=True, compute_dtype="bfloat16", dft_dtype="bfloat16",
        coupling_rank=3, top_k=64, rotation_chunk=128, num_rotations=2048,
        fft_impl="dft_fused", sweep_mode="resplat")
    rec = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30).receptor
    lig0, lig1 = (synthetic_complex(seed=s, n_res_rec=60,
                                    n_res_lig=30).ligand for s in (0, 1))
    for engine in ("dft_fused", "dft_pallas"):
        svc = DockingService(cfg.replace(fft_impl=engine), params,
                             device="cuda")
        warm = svc.dock(rec, lig0)
        svc.rescore(rec, lig0, warm, top=16, nrot=48)
        poses = stage(f"{engine} dock", lambda: svc.dock(rec, lig1))
        stage(f"{engine} rescore ({min(16, len(poses))} heads x 48)",
              lambda: svc.rescore(rec, lig1, poses, top=16, nrot=48))

    # The training cell: phase 9's config and training band.
    with open(os.path.join(ROOT, "pretrained", "synthetic-v9p",
                           "config.json")) as f:
        tcfg = DockConfig.from_json(f.read())
    band = synthetic_band(200, 8, widen=True, unbound=1.2)
    trainer = Trainer(tcfg, device="cuda")
    gen = torch.Generator().manual_seed(0)

    def step(state):
        return trainer.train_step(state, make_training_batch(
            gen, band, tcfg, device="cuda"))[0]

    state = step(trainer.init_state())
    stage("train step (v9p config, 2 x 24 decoys)", lambda: step(state))
    model = trainer.bind(state.params)
    mine_hard_negatives(model, tcfg, band[:1], n_rotations=320, top_k=24)
    stage("mining round (4 x 320 rotations)", lambda: mine_hard_negatives(
        model, tcfg, band[4:], n_rotations=320, top_k=24))

    # Phase 11's cells: the block engine above 128^3, the resample sweep.
    cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
    for name, c in (
            ("block dock, grid 256 (v9p config, block 64, 256 rotations)",
             tcfg.replace(grid_size=256, fft_block=64, num_rotations=256)),
            ("resample dock (v9p config, grid 64, 2,048 rotations)",
             tcfg.replace(sweep_mode="resample", num_rotations=2048))):
        pipe = DockingPipeline(c, params=params, device="cuda")
        pipe.dock_complex(cplx)
        stage(name, lambda: pipe.dock_complex(cplx))
        del pipe
    fft_sizes()


def fft_sizes(boxes=16, reps=20):
    """ms of one block's inverse transform (``boxes`` M^3 c2r) and of one
    receptor tile's forward transform (M^3 x 16 channels, r2c) by M, with
    the boxes or channels innermost (strided transforms) and outermost
    (each transform over three contiguous axes)."""
    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rows = []
    for M in (96, 104, 112, 128):
        Mh, s = M // 2 + 1, (M, M, M)
        row = dict(M=M)
        for layout, spec, tile, dims in (
                ("innermost",
                 torch.randn((1, M, M, Mh, boxes), device="cuda",
                             dtype=torch.complex64),
                 torch.randn((1, M, M, M, 16), device="cuda"), (1, 2, 3)),
                ("contiguous",
                 torch.randn((boxes, M, M, Mh), device="cuda",
                             dtype=torch.complex64),
                 torch.randn((16, M, M, M), device="cuda"), (-3, -2, -1))):
            row[f"c2r_ms_{layout}"] = timed(
                lambda: torch.fft.irfftn(spec, s=s, dim=dims))
            row[f"r2c_ms_{layout}"] = timed(
                lambda: torch.fft.rfftn(tile, dim=dims))
            row[f"c2r_ns_per_point_{layout}"] = (
                row[f"c2r_ms_{layout}"] * 1e6 / (boxes * M ** 3))
            del spec, tile
        rows.append(row)
    print(json.dumps(dict(stage="block engine cuFFT sizes", boxes=boxes,
                          rows=rows)), flush=True)

if __name__ == "__main__":
    main()
