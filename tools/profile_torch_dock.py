#!/usr/bin/env python3
"""Where a warm query's time goes on the card, per stage.

    python3 tools/profile_torch_dock.py      # from the repository root

The configuration of ``chip_smoke.py`` phases 3 and 5: the v9p hybrid
model, rank-3 folded coupling, bf16, grid 128, top-K 64, chunk 128,
2,048 rotations.  For each engine (``dft_fused``, the main path, and
``dft_pallas``) one ``DockingService`` docks the receptor of seed 0
against the ligand of seed 0 (warm-up), then, under ``torch.profiler``,
against the ligand of seed 1: ``dock`` and ``rescore(top=16, nrot=48)``.
Prints one JSON line per stage: host-clock wall (profiler overhead
included), device busy time (the union of kernel intervals), the idle
share and the largest kernels by total device time.
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
from deeplocalproteindocking_torch.serving import DockingService  # noqa: E402


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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps(dict(
        stage=name, wall_ms=wall, device_busy_ms=busy,
        idle_share=1.0 - busy / wall, kernels=len(kernels),
        top=[dict(name=n[:90], calls=c, ms=t) for n, (c, t) in top])),
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


if __name__ == "__main__":
    main()
