"""Time the rotation-sharded sweep against one card.

Port of ``tools/measure_scaling.py``.  The JAX tool ran on virtual CPU
devices that share host cores, so only the delta between the sharded and
the unsharded program meant anything; here every rank has a card of its
own, so the times are the cards'.  Run under torchrun, one process per
rank:

    torchrun --nproc-per-node R -m deeplocalproteindocking_torch.measure_scaling \\
        [n_rot] [--device cuda|cpu]

For each config, warm (one call first, then the best of three):

* ``sharded``: ``sharded_dock_sweep_resplat`` of ``n_rot`` rotations over
  the R ranks, from a barrier to every rank's synchronised end;
* ``unsharded_full``: ``dock_sweep_resplat`` of ``n_rot`` on rank 0's
  card alone;
* ``unsharded_per_rank``: the same of ``ceil(n_rot / R)`` (the ideal
  per-card work);
* ``merge_ms``: the top-K merge alone (gather of K candidates per rank,
  then ``torch.topk``);

with the rotations per rank after chunk padding (the skew), the
gathered payload in bytes, and K1 / K2 launches per rank in one sharded
call.  The configs: ``bench`` (``bench.py``'s: grid 128, chunk 128,
top-K 64, bf16, ``dft_fused``, the v9p weights at coupling rank 3) and
``v9p`` (the checkpoint's own ``config.json``: grid 64, float32, chunk
16).  The complex is the bench complex, ``synthetic_complex(seed=0,
n_res_rec=60, n_res_lig=30)``.  Rank 0 prints one JSON line per config.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch
import torch.distributed as dist

from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate import fused, invz_topk
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.data.benchmark import structure_to_device
from deeplocalproteindocking_torch.parallel.mesh import (
    init_distributed, make_mesh)
from deeplocalproteindocking_torch.parallel.sharded_sweep import (
    dim_size, merge_rot_shards, sharded_dock_sweep_resplat)
from deeplocalproteindocking_torch.pipeline import (
    DockingPipeline, dock_score_mask)
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.resplat import (
    auto_ligand_grid, dock_sweep_resplat)

V9P_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pretrained", "synthetic-v9p")
# bench.py's configuration (grid 128, chunk 128, top-K 64, bf16).
BENCH = DockConfig(grid_size=128, resolution=1.25, rep_features=(32, 14),
                   shape_prior=True, compute_dtype="bfloat16",
                   dft_dtype="bfloat16", coupling_rank=3, top_k=64,
                   rotation_chunk=128, fft_impl="dft_fused",
                   sweep_mode="resplat")


def configs() -> dict:
    """``{name: DockConfig}`` of the configs measured, in order."""
    with open(os.path.join(V9P_DIR, "config.json")) as f:
        return {"bench": BENCH, "v9p": DockConfig.from_json(f.read())}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best(fn, device, collective, reps=3):
    """Best wall seconds of ``fn`` over ``reps`` warm calls; with
    ``collective`` every rank starts at a barrier and the time ends when
    every rank's card has finished."""
    fn()
    best = math.inf
    for _ in range(reps):
        if collective:
            dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        if collective:
            dist.barrier()
        best = min(best, time.perf_counter() - t0)
    return best


def measure(name: str, cfg: DockConfig, n_rot: int, mesh, device) -> dict:
    """One config's record (complete on rank 0)."""
    params = weights.load_npz(os.path.join(V9P_DIR, "best_params.npz"))
    pipe = DockingPipeline(cfg, params=params, device=device)
    cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
    _, lig_c, rep_rec, _, coupling = pipe._prepare(cplx.receptor,
                                                   cplx.ligand)
    _, H, rep_fn = pipe._engine_parts(rep_rec, coupling)
    lc, lt, lm = structure_to_device(lig_c, bucket=cfg.atom_bucket or None,
                                     device=device)
    lig_grid = cfg.lig_grid_size or auto_ligand_grid(
        lig_c.typed().coords, cfg.resolution, cfg.sigma,
        pipe._receptive_field(), cfg.grid_size)
    kw = dict(grid_size=cfg.grid_size, lig_grid=lig_grid,
              resolution=cfg.resolution, sigma=cfg.sigma,
              num_types=cfg.num_atom_types, top_k=cfg.top_k,
              chunk=cfg.rotation_chunk,
              score_mask=dock_score_mask(cfg, lig_c, device=device),
              fft_impl=cfg.fft_impl, dft_dtype=cfg.dft_dtype,
              topk_impl=cfg.topk_impl, fft_block=cfg.fft_block)
    R = dim_size(mesh, "rot")
    rots = super_fibonacci_rotations(n_rot, device)
    rank0 = dist.get_rank() == 0

    def sharded():
        return sharded_dock_sweep_resplat(mesh, H, lc, lt, lm, rots, rep_fn,
                                          **kw)

    def alone(n):
        r = super_fibonacci_rotations(n, device)
        return lambda: dock_sweep_resplat(H, lc, lt, lm, r, rep_fn, **kw)

    t_sharded = _best(sharded, device, collective=True)
    fused.launches = fused.launches_tc = fused.launches_tf32 = 0
    invz_topk.launches = invz_topk.launches_fft = 0
    res = sharded()
    _sync(device)
    mine = dict(k1=fused.launches, k1_tc=fused.launches_tc,
                k1_tf32=fused.launches_tf32, k2=invz_topk.launches,
                k2_fft=invz_topk.launches_fft)
    launches = [None] * dist.get_world_size()
    dist.all_gather_object(launches, mine)
    t_merge = _best(lambda: merge_rot_shards(mesh, res, 0, n_rot,
                                             cfg.top_k),
                    device, collective=True)
    n_local = -(-n_rot // R)
    t_full = t_local = None
    if rank0:
        t_full = _best(alone(n_rot), device, collective=False)
        t_local = _best(alone(n_local), device, collective=False)
    dist.barrier()
    chunk = cfg.rotation_chunk
    per_shard = -(-n_rot // (R * chunk)) * chunk
    counts = [max(0, min(per_shard, n_rot - r * per_shard))
              for r in range(R)]
    return dict(
        config=name, ranks=R, n_rot=n_rot, grid=cfg.grid_size,
        lig_grid=lig_grid, dtype=cfg.dft_dtype, chunk=chunk,
        top_k=cfg.top_k, device=str(device),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        backend=dist.get_backend(),
        seconds=dict(sharded=t_sharded, unsharded_full=t_full,
                     unsharded_per_rank=t_local),
        merge_ms=t_merge * 1e3,
        speedup=None if t_full is None else t_full / t_sharded,
        efficiency=None if t_full is None else t_full / t_sharded / R,
        rotations_per_rank=counts, padded_per_rank=per_shard,
        skew=max(counts) - min(counts),
        gathered_payload_bytes=R * cfg.top_k * (4 + 4 + 12),
        launches_per_rank=launches, top1_score=float(res.scores[0]))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="measure_scaling")
    ap.add_argument("n_rot", nargs="?", type=int, default=13000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(args.device)
    mesh = make_mesh(rot=dist.get_world_size(), device_type=device.type)
    for name, cfg in configs().items():
        rec = measure(name, cfg, args.n_rot, mesh, device)
        if dist.get_rank() == 0:
            print(json.dumps(rec), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
