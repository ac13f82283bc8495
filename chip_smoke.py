#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Drives ``deeplocalproteindocking_torch`` (never JAX) through its main
path and fails (non-zero exit, no final result line) at the first
phase that does not hold:

1. environment: the card's name and power limit, torch/CUDA versions,
   and the build of the hand-written kernels from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes with a batch of 8 rotations (K1 on both routes:
   bf16 on the tensor-core kernel at the bench complex's box, at box 40
   and at box 64, and the SIMT kernel in float32, in bf16 at box 72 and
   in float32 at box 96; K2 with a real translation mask, drill-down
   top-K; K3 on the summed spectrum of the ``dft`` engine's forward
   half, on its FFT kernel, and on random spectra at L = 64 (FFT) and
   L = 96 (dense)), plus the time of each kernel and its plain version
   at the full batch of 128 (K1 also on its SIMT kernel in bf16 and in
   float32 at box 96; K2 on its FFT kernel at L = 128 on the bench
   complex's D and at L = 64, and on its dense kernel at L = 96; both K2
   kernels, timed in turns, held against plain at b = 128 and at the
   rescore's b = 48 with 16 bias groups; both K3 kernels, timed in turns
   and held against plain at b = 128, beside the library call
   ``torch.fft.ifft2`` that computes K3's function), with each kernel's
   bound at those shapes: the bytes its function must move or the
   operations of that function done as FFTs, whichever takes longer;
3. the slice: the v9p hybrid model (exported weights, rank-3 coupling
   folded into the last conv, bf16, grid 128, top-K 64, chunk 128)
   serves three ``DockingPipeline.dock`` requests, proving through the
   launch counters that K1 (every launch on the tensor-core kernel) and
   K2 (every launch on the FFT kernel) ran in each; then one request at
   grid 96 runs K2's dense kernel, and one float32 request at grid 128
   with a ligand box of 96 runs K1's SIMT kernel;
4. card against CPU: one request at grid 64, 256 rotations, once on CUDA
   tensors (kernels) and once on CPU tensors (plain versions), in
   float32 (top-K values within rtol 1e-3 and the same top-1 pose) and
   in bf16 (top-K values within rtol 2e-2); and the float32 box-96
   request of phase 3 on the CPU (top-K within rtol 1e-3, same top-1);
5. the screening slice: one ``DockingService`` on the same model with
   ``fft_impl="dft_pallas"`` docks the receptor of seed 0 against the
   ligands of seeds 0-2 (``dock`` then ``rescore(top=16, nrot=48)``
   each; the first also ``refine(steps=30)`` through the cached
   engine), proving that K3 ran in every stage, every launch on its FFT
   kernel; then one ``dft_pallas`` dock at grid 96 on K3's dense kernel,
   and one ``rescore`` on the main-path ``dft_fused`` engine, whose K2
   must see 16 bias groups;
6. card against CPU for that path: dock -> rescore -> refine at
   float32, grid 64, 256 rotations, ``dft_pallas`` (K3 on its FFT
   kernel);
7. band 100's local rows on the card: the 48 held-out polymer complexes
   (seeds 100-147, size-diverse, unbound 1.2 A) docked under the local
   protocol (grid 64, 64 rotations in a 50-degree cone, +-8 A, top-K 64,
   NMS 5 A, chunk 64) by the shape baseline (float32, every K1 launch on
   the SIMT kernel) and by the v9p model (bf16, full-rank coupling, every
   K1 launch on the tensor cores), each pose graded with CAPRI metrics
   through the port's ``eval_matrix.eval_row``; at most ``MAX_FLIPS`` of
   the 192 hit decisions may differ from the JAX package's CPU rows
   (``pretrained/synthetic-v9p/eval_matrix_48_cpu_parity.json``), every
   K2 launch must be on the FFT kernel and K3 must not run; each row's
   first K1 launch at each ligand box (24 and 32, b = 64, 2 shape or 16
   learned channels) and its first K2 launch (the local translation
   mask as bias) are held against their plain versions on the
   arguments the row gave them; then the first complex in the learned
   row at float32, graded on the card and on the CPU, its clustered
   poses in rank order and its 64 top-K poses before clustering matched
   by rotation and shift (score, LRMSD, IRMSD and fnat of every pose
   within 1e-3 relative, the same CAPRI classes).
8. batched and ensemble docking on the same model: ``evaluation.
   run_benchmark_batched`` on the complexes of seeds 0-3 as one group
   (2,048 rotations each, chunk 32 per complex: 128 rows per step),
   every K1 launch on the tensor cores with 4 receptor groups and every
   K2 launch on the FFT kernel with 4 bias groups, its first K1 and K2
   launches held against plain; each complex's row of the batched sweep
   against its own sweep at the group's box (top-K values, top-1 pose);
   its hit decisions against the sequential ``run_benchmark``; then
   ``dock_ensemble`` of 2 receptor x 2 ligand models ("product", K1 with
   one receptor group per pair) against four single docks merged on the
   host; then ``dock_batch`` of two complexes at float32, grid 64, 256
   rotations on ``dft_fused`` (SIMT K1, 2 groups; FFT K2) and on
   ``dft_pallas`` (FFT K3), on the card and on the CPU (top-K within
   1e-3 relative, the same top-1 per complex).  Phase 2 also holds K1
   with 4 receptor groups against plain (tensor cores at b = 128, the
   batched step; SIMT in float32 at b = 8) and times G = 4 against
   G = 1 in turns.

Each phase prints one JSON line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROT_SERVE = 2048          # per request; the JAX bench sweeps 13,000
N_ROT_BOX96 = 64            # the float32 box-96 request, also run on the CPU
BENCH_ROTATIONS = 13000
SEEDS = (0, 1, 2)
TOL_F32 = 1e-4              # max |kernel - plain| <= TOL * max |plain|
TOL_BF16 = 2e-2
# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Band 100's local rows: the EM_* knobs of the committed CPU matrix.
V9P_DIR = os.path.join(ROOT, "pretrained", "synthetic-v9p")
BAND100_ENV = dict(EM_COMPLEXES="48", EM_MODES="local", EM_WIDEN="1",
                   EM_SEED0="100", EM_UNBOUND="1.2", EM_BACKBONE="1",
                   EM_DTYPE="bfloat16", EM_RANK="0")
# Decisions that the platform alone flipped between the TPU and the CPU
# on these rows (platform_parity_band100.json).
MAX_FLIPS = 3
GRADE_RTOL = 1e-3
# Phase 8: a batched sweep's rows, and the ensemble's pairs, against the
# same complexes swept alone, top-K values relative (the ensemble's
# single docks may run a smaller ligand box than the pairs' shared one).
BATCH_RTOL = 1e-3


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
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


def rel_err(got, want):
    """(max |got - want| over finite entries, that / max |want|)."""
    import torch
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)),
          "kernel and plain version differ in which entries are finite")
    err = (got[fin] - want[fin]).abs().max().item()
    return err, err / max(want[fin].abs().max().item(), 1e-30)


def bound(nbytes, flops, dtype):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``flops`` on ``dtype`` operands, and which of the
    two bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bytes=nbytes, flops=flops,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def fft_flops(n):
    """Operations of one complex FFT of length ``n`` (5 n log2 n)."""
    return 5 * n * math.log2(n)


def k2_fft_flops(L):
    """Operations of ``invz_blockmax_fft.cu`` per (rotation, x, y) column:
    the packing (12 per k), the radix-8 pass with its twiddles, the
    radix-Q pass, the 1/L scale, the bias add and the max."""
    M = L // 2
    Q = M // 8
    radix = {4: 16, 8: 56}
    return 12 * M + Q * radix[8] + 6 * Q * 7 + 8 * radix[Q] + 3 * L


def k1_check(args):
    """((max abs err, rel err), route, D) of one K1 launch on ``args``,
    held against the plain version."""
    import torch
    from deeplocalproteindocking_torch.correlate import fused
    X, Y = args[0].shape[-2:]
    route = fused.k1_route(args[0].dtype, X, Y, args[6].shape[1],
                           args[4].shape[1], args[8].shape[1],
                           args[10].shape[1])
    tc0 = fused.launches_tc
    got = fused.fused_correlate(*args)
    torch.cuda.synchronize()
    check(fused.launches_tc - tc0 == int(route == "tc"),
          f"K1 at box {X} did not launch its {route} kernel")
    want = fused.fused_correlate_reference(*args)
    e = [rel_err(g, w) for g, w in zip(got, want)]
    return (max(a for a, _ in e), max(r for _, r in e)), route, got


def k2_check(args):
    """((max abs err, rel err), route, output) of one K2 launch on
    ``args``, held against the plain version."""
    import torch
    from deeplocalproteindocking_torch.correlate import invz_topk
    f0 = invz_topk.launches_fft
    got = invz_topk.invz_blockmax(*args)
    torch.cuda.synchronize()
    route = "fft" if invz_topk.launches_fft > f0 else "dense"
    return (rel_err(got, invz_topk.invz_blockmax_reference(*args)), route,
            got)


def band100_local(dev, params):
    """Phase 7: band 100's local rows on ``dev`` against the committed CPU
    matrix, then one complex of the learned row at float32 graded on
    ``dev`` and on the CPU.  Returns the phase's record, with the launch
    counts of each row and the error of its first K1 launch at each
    ligand box and of its first K2 launch against their plain versions,
    on the arguments the row gave them."""
    import torch
    from deeplocalproteindocking_torch import eval_matrix as em
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.correlate import (dft, fused, idft,
                                                         invz_topk)
    from deeplocalproteindocking_torch.evaluation import (grade_poses,
                                                          local_dock_kwargs)
    from deeplocalproteindocking_torch.pipeline import DockingPipeline

    with open(os.path.join(V9P_DIR, "eval_matrix_48_cpu_parity.json")) as f:
        committed = json.load(f)
    ckpt = os.path.join(V9P_DIR, "best")
    settings = em.settings_from_env(BAND100_ENV)
    n_cplx = settings["n_cplx"]
    complexes = em.heldout_complexes(
        n_cplx, widen=settings["widen"], seed0=settings["seed0"],
        unbound=settings["unbound"], backbone=settings["backbone"])
    base = em.protocol_base(settings, "local")
    pipes = {"shape_local": DockingPipeline(
                 DockConfig(rep_features=(8,), **base), device=dev),
             "learned_local": DockingPipeline(
                 em.learned_config(ckpt, settings, "local"), params=params,
                 device=dev)}
    # The sweep reaches K1 through dft's name for it and K2 through
    # invz_topk's; spies keep the arguments of each row's first launch
    # (K1: at each ligand box) and launch as the path would.
    k1_launch, k2_launch = dft.fused_correlate, invz_topk.invz_blockmax
    rows, launches, kernels = {}, {}, {}
    for key, pipe in pipes.items():
        check(em.fingerprint_of(settings) == committed[key]["fingerprint"],
              f"{key}: not the committed protocol")
        seen = {}

        def k1_spy(*args, seen=seen):
            seen.setdefault(f"k1_box{args[0].shape[-1]}", args)
            return k1_launch(*args)

        def k2_spy(*args, seen=seen):
            seen.setdefault("k2", args)
            return k2_launch(*args)

        fused.launches = fused.launches_tc = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dft.fused_correlate, invz_topk.invz_blockmax = k1_spy, k2_spy
        try:
            row = em.eval_row(em.mode_dock_fn(pipe, "local"), complexes,
                              key, device=dev)
        finally:
            dft.fused_correlate, invz_topk.invz_blockmax = (k1_launch,
                                                            k2_launch)
        torch.cuda.synchronize(dev)
        want = committed[key]
        rows[key] = dict(top1=row["top1"], top10=row["top10"],
                         committed_top1=want["top1"],
                         committed_top10=want["top10"],
                         seconds=time.perf_counter() - t0,
                         complexes=row["complexes"])
        launches[key] = dict(k1=fused.launches, k1_tc=fused.launches_tc,
                             k1_simt=fused.launches - fused.launches_tc,
                             k2=invz_topk.launches,
                             k2_fft=invz_topk.launches_fft, k3=idft.launches,
                             k3_fft=idft.launches_fft)
        # The row's launches against their plain versions, on the card,
        # after its counts were read.
        kernels[key] = {}
        with torch.inference_mode():
            for name, args in sorted(seen.items()):
                (err, rel), route, _ = (k1_check if name.startswith("k1")
                                        else k2_check)(args)
                kernels[key][name] = dict(
                    route=route, shape=list(args[0].shape),
                    dtype=str(args[0].dtype).replace("torch.", ""),
                    max_abs_err=err, rel_err=rel)
        del seen

    flips, moved = [], []
    for key, row in rows.items():
        want = {r["name"]: r for r in committed[key]["complexes"]}
        for r in row.pop("complexes"):
            w = want[r["name"]]
            flips += [dict(row=key, name=r["name"], metric=m, card=r[m],
                           committed=w[m])
                      for m in ("hit_top1", "hit_top10") if r[m] != w[m]]
            check(r["best_lrmsd"] is not None,
                  f"{key} {r['name']}: no graded pose")
            moved.append((abs(r["best_lrmsd"] - w["best_lrmsd"]), key,
                          r["name"], r["best_lrmsd"], w["best_lrmsd"]))
    # The complexes whose best LRMSD moved by more than 1e-3 A.
    best_lrmsd_moved = [dict(row=k, name=n, card=a, committed=b)
                        for d, k, n, a, b in sorted(moved, reverse=True)
                        if d > 1e-3]

    # Kernel error apart from bf16 drift: one complex at float32, its
    # clustered poses (what eval_row grades) in rank order, and all top-K
    # poses before clustering matched by (rotation, shift).
    c = complexes[0]
    f32 = em.learned_config(ckpt, dict(settings, dtype="float32"), "local")
    graded, secs = {}, {}
    for where in (dev, torch.device("cpu")):
        p = DockingPipeline(f32, params=params, device=where)
        t0 = time.perf_counter()
        kw = local_dock_kwargs(p, c)
        clustered = grade_poses(c, p.dock_complex(c, **kw), device=where)
        poses = p.dock_complex(c, cluster=False, **kw)
        top_k = {(int(r),) + tuple(int(v) for v in sh): g
                 for r, sh, g in zip(poses.rot_idx, poses.shifts,
                                     grade_poses(c, poses, device=where))}
        graded[where.type] = (clustered, top_k)
        secs[where.type] = time.perf_counter() - t0
    (g, gk), (w, wk) = graded[dev.type], graded["cpu"]
    check(len(g) == len(w) > 0,
          f"float32 {c.name}: {len(g)} poses on the card, {len(w)} on CPU")
    check(gk.keys() == wk.keys(),
          f"float32 {c.name}: the top-K poses differ card vs CPU")
    pairs = list(zip(g, w)) + [(gk[k], wk[k]) for k in wk]

    def rel(m):
        return max(abs(a[m] - b[m]) / max(abs(b[m]), 1e-12)
                   for a, b in pairs)

    f32_rec = dict(complex=c.name, poses=len(g), top_k_poses=len(wk),
                   rtol=GRADE_RTOL, seconds=secs,
                   **{f"{m}_max_rel_diff": rel(m)
                      for m in ("score", "lrmsd", "irmsd", "fnat")},
                   capri_same=all(a["capri"] == b["capri"]
                                  for a, b in pairs))
    record = dict(complexes=n_cplx, decisions=4 * n_cplx,
                  max_flips=MAX_FLIPS, flips=flips, n_flips=len(flips),
                  max_abs_delta_best_lrmsd=max(m[0] for m in moved),
                  best_lrmsd_moved=best_lrmsd_moved, rows=rows,
                  launches=launches, kernels_vs_plain=kernels,
                  tolerance={"shape_local": TOL_F32,
                             "learned_local": TOL_BF16,
                             "k2": TOL_F32},
                  float32_card_vs_cpu=f32_rec,
                  protocol=dict(base, dtype=settings["dtype"],
                                rank=settings["rank"]))
    return record


def check_band100(record):
    """Phase 7's gates, applied after its line is printed."""
    launches = record["launches"]
    check(record["n_flips"] <= MAX_FLIPS,
          f"band 100: {record['n_flips']} of {record['decisions']} "
          f"decisions differ from the committed CPU rows")
    shape, learned = launches["shape_local"], launches["learned_local"]
    check(shape["k1"] > 0 and shape["k1_tc"] == 0,
          f"shape_local: K1 not all on the SIMT kernel {shape}")
    check(learned["k1"] > 0 and learned["k1_tc"] == learned["k1"],
          f"learned_local: K1 not all on the tensor cores {learned}")
    for key, n in launches.items():
        check(n["k2"] > 0 and n["k2_fft"] == n["k2"],
              f"{key}: a K2 launch missed the FFT kernel {n}")
        check(n["k3"] == 0, f"{key}: K3 ran {n}")
    # Each row's K1 launches at its two ligand boxes (24 and 32) and its
    # K2 launch, held against their plain versions.
    k1_route = {"shape_local": "simt", "learned_local": "tc"}
    for key, errs in record["kernels_vs_plain"].items():
        check(sorted(errs) == ["k1_box24", "k1_box32", "k2"],
              f"{key}: launches held against plain {sorted(errs)}")
        for name, e in errs.items():
            route, limit = (("fft", record["tolerance"]["k2"])
                            if name == "k2" else
                            (k1_route[key], record["tolerance"][key]))
            check(e["route"] == route and e["rel_err"] <= limit,
                  f"{key} {name} against its plain version: {e}")
    f32 = record["float32_card_vs_cpu"]
    check(f32["capri_same"] and all(
        f32[f"{m}_max_rel_diff"] <= GRADE_RTOL
        for m in ("score", "lrmsd", "irmsd", "fnat")),
        f"float32 grading differs card vs CPU: {f32}")


def batched_and_ensemble(dev, pipe, params, cmp_cfg, group):
    """Phase 8: batched evaluation, ensemble docking and batched card vs
    CPU, each path driven with the launch counts set to 0 just before it
    and read just after.  Returns the phase's record."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch
    from deeplocalproteindocking_torch.correlate import (dft, fused, idft,
                                                         invz_topk)
    from deeplocalproteindocking_torch.data import synthetic_complex
    from deeplocalproteindocking_torch.evaluation import (
        batch_inputs, run_benchmark, run_benchmark_batched)
    from deeplocalproteindocking_torch.parallel import batch_eval
    from deeplocalproteindocking_torch.pipeline import (DockingPipeline,
                                                        ensemble_pair_batch)
    from deeplocalproteindocking_torch.sweep.resplat import (
        dock_sweep_resplat)

    def reset():
        fused.launches = fused.launches_tc = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0

    def counts():
        return dict(k1=fused.launches, k1_tc=fused.launches_tc,
                    k2=invz_topk.launches, k2_fft=invz_topk.launches_fft,
                    k3=idft.launches, k3_fft=idft.launches_fft)

    # Spies record each launch's receptor and bias groups, keep the first
    # launch's arguments and time each batched sweep; each launches as
    # the path would.
    k1_launch, k2_launch = dft.fused_correlate, invz_topk.invz_blockmax
    dock_batch = batch_eval.dock_batch
    seen = {}

    def k1_spy(*args):
        seen.setdefault("k1_groups", []).append(
            args[2].shape[0] if args[2].ndim == 5 else 1)
        seen.setdefault("k1", args)
        return k1_launch(*args)

    def k2_spy(*args):
        seen.setdefault("k2_groups", []).append(
            args[4].shape[0] if args[4].ndim == 4 else 1)
        seen.setdefault("k2", args)
        return k2_launch(*args)

    def sweep_spy(*args, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = dock_batch(*args, **kw)
        torch.cuda.synchronize(dev)
        seen.setdefault("sweeps", []).append(
            dict(args=args, kw=kw, res=res,
                 seconds=time.perf_counter() - t0))
        return res

    def spied(fn):
        seen.clear()
        reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dft.fused_correlate, invz_topk.invz_blockmax = k1_spy, k2_spy
        batch_eval.dock_batch = sweep_spy
        try:
            out = fn()
        finally:
            dft.fused_correlate, invz_topk.invz_blockmax = (k1_launch,
                                                            k2_launch)
            batch_eval.dock_batch = dock_batch
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0, counts()

    def max_rel(a, w):
        a, w = np.sort(np.asarray(a)), np.sort(np.asarray(w))
        return float(np.max(np.abs(a - w) / np.abs(w)))

    n_rot = pipe.config.num_rotations
    tmp = tempfile.mkdtemp(prefix="dlpd_batched_")
    try:
        # -- batched evaluation: the four complexes as one group --
        _, wall, launches = spied(lambda: run_benchmark_batched(
            pipe, group, os.path.join(tmp, "batched"),
            group_size=len(group)))
        sweep = seen["sweeps"][0]
        k1_groups = sorted(set(seen["k1_groups"]))
        k2_groups = sorted(set(seen["k2_groups"]))
        with torch.inference_mode():
            (k1_err, k1_rel), k1_route, _ = k1_check(seen["k1"])
            (k2_err, k2_rel), k2_route, _ = k2_check(seen["k2"])
        # Each complex's row against its own sweep at the group's box.
        H_b, lc, lt, lm, rots, rep_fn = sweep["args"]
        kw, res = sweep["kw"], sweep["res"]
        rows = []
        for i, c in enumerate(group):
            one = dock_sweep_resplat(
                H_b[i], lc[i], lt[i], lm[i], rots, rep_fn,
                **dict(kw, score_mask=(None if kw["score_mask"] is None
                                       else kw["score_mask"][i])))
            a, w = res.scores[i].cpu().numpy(), one.scores.cpu().numpy()
            rows.append(dict(
                name=c.name, max_rel_diff=max_rel(a, w),
                top1_same=(int(res.rot_idx[i, 0]) == int(one.rot_idx[0])
                           and res.shifts[i, 0].tolist()
                           == one.shifts[0].tolist())))
        seq_t0 = time.perf_counter()
        run_benchmark(pipe, group, os.path.join(tmp, "seq"))
        seq_s = time.perf_counter() - seq_t0
        decisions = []
        for c in group:
            got = {}
            for mode in ("batched", "seq"):
                with open(os.path.join(tmp, mode, f"{c.name}.json")) as f:
                    got[mode] = json.load(f)
            decisions.append(dict(
                name=c.name,
                **{f"{m}_{k}": got[m][k] for m in ("batched", "seq")
                   for k in ("hit_top1", "hit_top10")}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batched = dict(
        complexes=[c.name for c in group], rotations=n_rot,
        group_size=len(group), lig_grid=kw["lig_grid"], chunk=kw["chunk"],
        rows_per_step=kw["chunk"] * len(group),
        atoms_padded=int(lc.shape[1]), sweep_seconds=sweep["seconds"],
        rotations_per_second=len(group) * n_rot / sweep["seconds"],
        wall_seconds=wall, sequential_wall_seconds=seq_s,
        launches=launches, k1_groups=k1_groups, k2_groups=k2_groups,
        k1_first=dict(route=k1_route, shape=list(seen["k1"][0].shape),
                      h_shape=list(seen["k1"][2].shape), max_abs_err=k1_err,
                      rel_err=k1_rel),
        k2_first=dict(route=k2_route, bias_shape=list(seen["k2"][4].shape),
                      max_abs_err=k2_err, rel_err=k2_rel),
        rows_vs_single=rows, decisions=decisions)
    del seen["sweeps"], sweep, res, H_b

    # -- ensemble: 2 receptor x 2 ligand models, "product" --
    c0 = group[0]
    ub = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30,
                           unbound_rmsd=1.2)
    recs, ligs = [c0.receptor, ub.receptor], [c0.ligand, ub.ligand]
    with torch.no_grad():
        _, rep0, cpl0 = pipe._receptor_half(recs[0])
        pair_batch = ensemble_pair_batch(pipe._engine_parts(rep0, cpl0)[1])
    (merged, pairs), ens_s, ens_launches = spied(
        lambda: pipe.dock_ensemble(recs, ligs, cluster=False))
    ens_k1_groups = sorted(set(seen["k1_groups"]))
    clustered, cpairs = pipe._merge_ensemble(merged, pairs, ligs, True)
    singles, tags = [], []
    for ri, li in itertools.product(range(2), range(2)):
        p = pipe.dock(recs[ri], ligs[li], cluster=False)
        singles.append(p.scores)
        tags += [(ri, li)] * len(p)
    single = np.concatenate(singles)
    top = int(np.argmax(single))
    ensemble = dict(
        models="seed 0 bound and unbound (1.2 A) sides", pairing="product",
        pairs=4, pair_batch=pair_batch, seconds=ens_s, launches=ens_launches,
        k1_groups=ens_k1_groups, poses_before_nms=len(merged),
        poses_after_nms=len(clustered),
        max_rel_diff_vs_single_docks=max_rel(merged.scores, single),
        top1_pair=[int(v) for v in pairs[0]], top1_pair_single=list(tags[top]),
        top1_score=float(merged.scores[0]), top1_score_single=float(
            single[top]))

    # -- card against CPU: dock_batch of two complexes at float32 --
    vs_cpu = {}
    for engine in ("dft_fused", "dft_pallas"):
        cfg = cmp_cfg.replace(fft_impl=engine)
        out = {}
        for where in ("card", "cpu"):
            p = DockingPipeline(cfg, params=params,
                                device=dev if where == "card" else "cpu")
            rots = torch.as_tensor(p.rotation_set(), dtype=torch.float32,
                                   device=p.device)
            args, kw2 = batch_inputs(p, group[:2], rots)
            if where == "card":
                r, secs, n = spied(lambda: batch_eval.dock_batch(*args,
                                                                 **kw2))
                groups = sorted(set(seen.get("k1_groups", [])))
            else:
                t0 = time.perf_counter()
                r, n, groups = batch_eval.dock_batch(*args, **kw2), None, None
                secs = time.perf_counter() - t0
            out[where] = (r.scores.cpu().numpy(), r.rot_idx.cpu().numpy(),
                          r.shifts.cpu().numpy(), secs, n, groups)
        (gs, gr, gsh, g_s, g_n, g_groups) = out["card"]
        (ws, wr, wsh, w_s, _, _) = out["cpu"]
        vs_cpu[engine] = dict(
            grid=cfg.grid_size, rotations=cfg.num_rotations,
            dtype=cfg.dft_dtype, complexes=2, lig_grid=kw2["lig_grid"],
            cuda_seconds=g_s, cpu_seconds=w_s, launches=g_n,
            k1_groups=g_groups,
            max_rel_diff=max(max_rel(gs[i], ws[i]) for i in range(2)),
            top1_same=all(int(gr[i, 0]) == int(wr[i, 0])
                          and gsh[i, 0].tolist() == wsh[i, 0].tolist()
                          for i in range(2)))
    return dict(batched=batched, ensemble=ensemble, card_vs_cpu=vs_cpu)


def check_batched(record):
    """Phase 8's gates, applied after its line is printed."""
    b, e, v = record["batched"], record["ensemble"], record["card_vs_cpu"]
    n, G = b["launches"], b["group_size"]
    check(n["k1"] > 0 and n["k1_tc"] == n["k1"] and b["k1_groups"] == [G],
          f"batched: K1 not all on the tensor cores with {G} groups "
          f"{n} {b['k1_groups']}")
    check(n["k2"] > 0 and n["k2_fft"] == n["k2"] and b["k2_groups"] == [G]
          and n["k3"] == 0,
          f"batched: K2 not all FFT with {G} groups {n} {b['k2_groups']}")
    check(b["k1_first"]["route"] == "tc"
          and b["k1_first"]["rel_err"] <= TOL_BF16
          and b["k2_first"]["route"] == "fft"
          and b["k2_first"]["rel_err"] <= TOL_F32,
          f"batched: first launches against plain {b['k1_first']} "
          f"{b['k2_first']}")
    for r in b["rows_vs_single"]:
        check(r["max_rel_diff"] <= BATCH_RTOL and r["top1_same"],
              f"batched row against its own sweep: {r}")
    for d in b["decisions"]:
        check(d["batched_hit_top1"] == d["seq_hit_top1"]
              and d["batched_hit_top10"] == d["seq_hit_top10"],
              f"batched decisions differ from run_benchmark: {d}")
    check(e["k1_groups"] == [min(e["pair_batch"], e["pairs"])]
          and e["launches"]["k1_tc"] == e["launches"]["k1"] > 0,
          f"ensemble: K1 groups {e['k1_groups']}, launches {e['launches']}")
    check(e["max_rel_diff_vs_single_docks"] <= BATCH_RTOL
          and e["top1_pair"] == e["top1_pair_single"],
          f"ensemble against four single docks: {e}")
    for engine, r in v.items():
        n = r["launches"]
        check(r["max_rel_diff"] <= 1e-3 and r["top1_same"],
              f"{engine} dock_batch card vs CPU: {r}")
        if engine == "dft_fused":
            check(n["k1"] > 0 and n["k1_tc"] == 0 and r["k1_groups"] == [2]
                  and n["k2_fft"] == n["k2"] > 0,
                  f"dft_fused dock_batch launches {n} {r['k1_groups']}")
        else:
            check(n["k3_fft"] == n["k3"] > 0,
                  f"dft_pallas dock_batch launches {n}")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, ROOT)
    from deeplocalproteindocking_torch import _build, weights
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.correlate import fused, idft, invz_topk
    from deeplocalproteindocking_torch.correlate._contract import mm
    from deeplocalproteindocking_torch.correlate.dft import get_correlator
    from deeplocalproteindocking_torch.correlate.fft import (
        receptor_transform)
    from deeplocalproteindocking_torch.data import (structure_to_device,
                                                    synthetic_complex)
    from deeplocalproteindocking_torch.evaluation import batch_inputs
    from deeplocalproteindocking_torch.grids.voxelize import (
        separable_splat)
    from deeplocalproteindocking_torch.pipeline import (DockingPipeline,
                                                        PoseSet,
                                                        dock_score_mask)
    from deeplocalproteindocking_torch.serving import DockingService
    from deeplocalproteindocking_torch.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_torch.sweep.resplat import (
        auto_ligand_grid)
    from deeplocalproteindocking_torch.sweep.topk import exact_block_topk

    # ---- phase 1: environment and kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fresh = not os.path.exists(_build.library_path())
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         kernel_build_seconds=build_s, built_fresh=fresh,
         library=os.path.relpath(_build.library_path(), ROOT))

    # ---- shared set-up: the v9p model on the bench complex ----
    params = weights.load_npz(os.path.join(
        ROOT, "pretrained", "synthetic-v9p", "best_params.npz"))
    serve_cfg = DockConfig(
        grid_size=128, resolution=1.25, rep_features=(32, 14),
        shape_prior=True, compute_dtype="bfloat16", dft_dtype="bfloat16",
        coupling_rank=3, top_k=64, rotation_chunk=128,
        num_rotations=N_ROT_SERVE, fft_impl="dft_fused",
        sweep_mode="resplat")
    pipe = DockingPipeline(serve_cfg, params=params, device=dev)
    cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
    rec_c, lig_c, rep_rec, _, coupling = pipe._prepare(cplx.receptor,
                                                       cplx.ligand)
    _, H, rep_fn = pipe._engine_parts(rep_rec, coupling)
    L = serve_cfg.grid_size
    Ls = auto_ligand_grid(lig_c.typed().coords, serve_cfg.resolution,
                          serve_cfg.sigma, pipe._receptive_field(), L)
    lc, lt, lm = structure_to_device(lig_c, bucket=serve_cfg.atom_bucket,
                                     device=dev)
    mask = dock_score_mask(serve_cfg, lig_c, device=dev)
    check(mask is not None, "the bench complex should need a wrap mask")
    bias = torch.where(mask, 0.0, float("-inf")).to(torch.float32)
    # Phase 8's group: the complexes of seeds 0-3, whose four receptor
    # spectra (from the batched receptor engine) phase 2 gives K1 too.
    group = [synthetic_complex(seed=s, n_res_rec=60, n_res_lig=30)
             for s in range(4)]
    (H4, *_), _ = batch_inputs(pipe, group,
                               super_fibonacci_rotations(8, dev))

    def grouped(corr, args):
        """``args`` with the four receptor spectra as K1's H groups."""
        return args[:2] + corr.prep_H(H4) + args[4:]

    def k1_inputs(b, dtype_name, box=Ls):
        """K1's arguments as the main path builds them for b rotations
        (the bench complex's ligand splatted into a ``box`` grid)."""
        corr = get_correlator(L, box, dtype_name, dev)
        with torch.inference_mode():
            R = super_fibonacci_rotations(b, dev)
            vols = separable_splat(torch.einsum("bij,nj->bni", R, lc), lt,
                                   lm, grid_size=box,
                                   resolution=serve_cfg.resolution,
                                   sigma=serve_cfg.sigma, num_types=11)
            v = rep_fn(vols).to(corr.dtype)
            are = mm("bxyzc,zk->bkcxy", v, corr.WzRe).to(corr.dtype)
            aim = mm("bxyzc,zk->bkcxy", v, corr.WzIm).to(corr.dtype)
        Ht = corr.prep_H(H)
        return corr, (are.contiguous(), aim.contiguous(), Ht[0], Ht[1],
                      corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm,
                      corr.UxRe, corr.UxIm, corr.UyRe, corr.UyIm)

    def k1_random_inputs(b, box, C=3, seed=0, dtype_name="bfloat16"):
        """K1's arguments from random volumes and receptor grid."""
        g = torch.Generator().manual_seed(seed)
        corr = get_correlator(L, box, dtype_name, dev)
        with torch.inference_mode():
            Hr = receptor_transform(torch.randn(L, L, L, C,
                                                generator=g).to(dev))
            v = torch.randn(b, box, box, box, C, generator=g).to(
                dev, corr.dtype)
            are = mm("bxyzc,zk->bkcxy", v, corr.WzRe).to(corr.dtype)
            aim = mm("bxyzc,zk->bkcxy", v, corr.WzIm).to(corr.dtype)
            Ht = corr.prep_H(Hr)
        return (are.contiguous(), aim.contiguous(), Ht[0], Ht[1],
                corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm, corr.UxRe,
                corr.UxIm, corr.UyRe, corr.UyIm)

    def k2_random_check(Lk, b=8, seed=0):
        """((max abs err, rel err), route) of one K2 launch at grid Lk on
        a random D, with a random mask (40% masked, one whole y run),
        held against the plain version."""
        g = torch.Generator(device=dev).manual_seed(seed)
        corr = get_correlator(Lk, 16, "float32", dev)
        Dk = [torch.randn((b, Lk // 2 + 1, Lk, Lk), generator=g, device=dev)
              for _ in range(2)]
        bk = torch.where(torch.rand((Lk,) * 3, generator=g, device=dev)
                         < 0.6, 0.0, float("-inf"))
        bk[3, 0:32, 5] = float("-inf")
        err, route, got = k2_check((*Dk, corr.MzRe, corr.MzIm, bk))
        check(bool((got[:, 3, 0, 5] == float("-inf")).all()),
              f"K2 at L={Lk}: a fully masked run is not -inf")
        return err, route

    def k3_inputs(b):
        """K3's arguments as the ``dft_pallas`` sweep builds them for b
        rotations: the bf16 forward half and coupling of the ``dft``
        engine, the float32 summed spectrum G, then pass A."""
        corr = get_correlator(L, Ls, serve_cfg.dft_dtype, dev)
        with torch.inference_mode():
            R = super_fibonacci_rotations(b, dev)
            vols = separable_splat(torch.einsum("bij,nj->bni", R, lc), lt,
                                   lm, grid_size=Ls,
                                   resolution=serve_cfg.resolution,
                                   sigma=serve_cfg.sigma, num_types=11)
            fre, fim = corr._cast(*corr.ligand_spectrum(rep_fn(vols)))
            hre, him = corr._cast(H.real, H.imag)
            gre = (mm("ijkc,bijkc->bijk", hre, fre)
                   + mm("ijkc,bijkc->bijk", him, fim))
            gim = (mm("ijkc,bijkc->bijk", him, fre)
                   - mm("ijkc,bijkc->bijk", hre, fim))
            del fre, fim
            ere, eim = idft._pass_a(gre, gim, corr.MzRe, corr.MzIm)
        return (ere, eim, corr.UxRe32, corr.UxIm32, corr.UxRe32,
                corr.UxIm32)

    def k3_random_check(Lk, b=8, seed=0):
        """((max abs err, rel err), route) of one K3 launch at grid Lk on
        a random E, held against the plain version."""
        g = torch.Generator(device=dev).manual_seed(seed)
        corr = get_correlator(Lk, 16, "float32", dev)
        args = [torch.randn((b, Lk, Lk, Lk), generator=g, device=dev)
                for _ in range(2)] + [corr.UxRe32, corr.UxIm32] * 2
        f0 = idft.launches_fft
        got = idft.idft_bc(*args)
        torch.cuda.synchronize()
        route = "fft" if idft.launches_fft > f0 else "dense"
        return rel_err(got, idft.idft_bc_reference(*args)), route

    # ---- phase 2: kernels against their plain versions ----
    errs, routes = {}, {}
    with torch.inference_mode():
        for name in ("float32", "bfloat16"):
            corr, args = k1_inputs(8, name)
            errs["k1_" + name], routes["k1_" + name], got = k1_check(args)
            if name == "float32":
                corr32, D = corr, got
        errs["k1_bf16_box40"], routes["k1_bf16_box40"], _ = k1_check(
            k1_inputs(2, "bfloat16", box=40)[1])
        for box in (64, 72):
            key = f"k1_bf16_box{box}_random"
            errs[key], routes[key], _ = k1_check(k1_random_inputs(2, box))
        errs["k1_f32_box96_random"], routes["k1_f32_box96_random"], _ = (
            k1_check(k1_random_inputs(2, 96, dtype_name="float32")))
        errs["k1_f32_G4"], routes["k1_f32_G4"], _ = k1_check(
            grouped(*k1_inputs(8, "float32")))
        errs["k2_fft"], route, bk = k2_check(
            (D[0], D[1], corr32.MzRe, corr32.MzIm, bias))
        check(route == "fft", "K2 at L=128 did not launch its FFT kernel")
        k2_routes = {}
        for key, Lk in (("k2_fft_L64", 64), ("k2_dense_L96", 96)):
            errs[key], k2_routes[key] = k2_random_check(Lk)
        top_k = serve_cfg.top_k
        dv, dflat = invz_topk.drill_topk(D[0], D[1], corr32.MzRe,
                                         corr32.MzIm, bias.reshape(-1), bk,
                                         top_k)
        S = (torch.einsum("bkxy,kz->bxyz", D[0], corr32.MzRe)
             - torch.einsum("bkxy,kz->bxyz", D[1], corr32.MzIm))
        S = torch.where(mask[None], S, float("-inf"))
        ev, _ = exact_block_topk(S.reshape(S.shape[0], -1), top_k)
        drill_err = rel_err(dv.sort(dim=1).values, ev.sort(dim=1).values)
        looked = torch.gather(S.reshape(S.shape[0], -1), 1, dflat)
        drill_idx_err = rel_err(looked, dv)
        k3_args = k3_inputs(8)
        f0 = idft.launches_fft
        k3_got = idft.idft_bc(*k3_args)
        torch.cuda.synchronize()
        check(idft.launches_fft == f0 + 1,
              "K3 at L=128 did not launch its FFT kernel")
        errs["k3"] = rel_err(k3_got, idft.idft_bc_reference(*k3_args))
        del k3_args, k3_got
        k3_routes = {}
        for key, Lk in (("k3_fft_L64", 64), ("k3_dense_L96", 96)):
            errs[key], k3_routes[key] = k3_random_check(Lk)
    emit("kernels_vs_plain", batch=8, L=L, Ls=Ls, C=3, K=L // 2 + 1,
         k1_float32_max_abs_err=errs["k1_float32"][0],
         k1_float32_rel_err=errs["k1_float32"][1],
         k1_bf16_max_abs_err=errs["k1_bfloat16"][0],
         k1_bf16_rel_err=errs["k1_bfloat16"][1],
         k1_more={k: dict(rel_err=v[1], max_abs_err=v[0],
                          batch=8 if k.endswith("G4") else 2)
                  for k, v in errs.items()
                  if k.startswith(("k1_bf16_", "k1_f32_"))},
         k1_routes=routes,
         k2_fft_max_abs_err=errs["k2_fft"][0],
         k2_fft_rel_err=errs["k2_fft"][1],
         k2_fft_L64_rel_err=errs["k2_fft_L64"][1],
         k2_dense_L96_rel_err=errs["k2_dense_L96"][1], k2_routes=k2_routes,
         drill_topk_rel_err=drill_err[1],
         drill_index_rel_err=drill_idx_err[1],
         k3_max_abs_err=errs["k3"][0], k3_rel_err=errs["k3"][1],
         k3_fft_L64_rel_err=errs["k3_fft_L64"][1],
         k3_dense_L96_rel_err=errs["k3_dense_L96"][1], k3_routes=k3_routes,
         tolerance={"float32": TOL_F32, "bfloat16": TOL_BF16},
         masked_fraction=1.0 - mask.float().mean().item())
    for key in ("k1_float32", "k1_f32_box96_random", "k1_f32_G4"):
        check(errs[key][1] <= TOL_F32, f"K1 {key} {errs}")
    for key in ("k1_bfloat16", "k1_bf16_box40", "k1_bf16_box64_random",
                "k1_bf16_box72_random"):
        check(errs[key][1] <= TOL_BF16, f"K1 {key} {errs}")
    check(routes == {"k1_float32": "simt", "k1_bfloat16": "tc",
                     "k1_bf16_box40": "tc", "k1_bf16_box64_random": "tc",
                     "k1_bf16_box72_random": "simt",
                     "k1_f32_box96_random": "simt", "k1_f32_G4": "simt"},
          f"K1 routes {routes}")
    for key in ("k2_fft", "k2_fft_L64", "k2_dense_L96"):
        check(errs[key][1] <= TOL_F32, f"K2 {key} {errs}")
    check(k2_routes == {"k2_fft_L64": "fft", "k2_dense_L96": "dense"},
          f"K2 routes {k2_routes}")
    for key in ("k3", "k3_fft_L64", "k3_dense_L96"):
        check(errs[key][1] <= TOL_F32, f"K3 {key} {errs}")
    check(k3_routes == {"k3_fft_L64": "fft", "k3_dense_L96": "dense"},
          f"K3 routes {k3_routes}")
    check(drill_err[1] <= 1e-5 and drill_idx_err[1] <= 1e-5,
          f"drill_topk vs exact_block_topk: {drill_err} {drill_idx_err}")

    def both_routes(launch, plain, args):
        """A kernel's two routes (``launch``: route -> function) on
        ``args``, timed in turns (dense, FFT, FFT, dense) on the same
        inputs, then each output held against ``plain``.  Returns (turns,
        plain ms, {route: (max abs err, rel err)}, plain's output)."""
        turns = {"dense": [], "fft": []}
        for route in ("dense", "fft", "fft", "dense"):
            turns[route].append(cuda_time_ms(lambda: launch[route](*args)))
        plain_ms = cuda_time_ms(lambda: plain(*args))
        want = plain(*args)
        route_errs = {r: rel_err(launch[r](*args), want) for r in launch}
        return turns, plain_ms, route_errs, want

    def k2_both_routes(args):
        """Both K2 kernels on ``args`` (bias ``[G, X, Y, Z]``), as
        ``both_routes``; returns (turns, plain ms, errors, bound)."""
        turns, plain_ms, route_errs, _ = both_routes(
            {"dense": invz_topk._launch_dense, "fft": invz_topk._launch_fft},
            invz_topk.invz_blockmax_reference, args)
        # Both routes compute one function; its least work is the FFT's.
        Dre, bk = args[0], args[4]
        bb = Dre.shape[0]
        return turns, plain_ms, route_errs, bound(
            (2 * Dre.numel() + bk.numel() + bb * L ** 3 // 32) * 4,
            k2_fft_flops(L) * bb * L * L, "float32")

    # Times at the main path's full chunk: b=128 rotations, bf16.
    with torch.inference_mode():
        corr16, args16 = k1_inputs(128, "bfloat16")
        D16 = fused.fused_correlate(*args16)
        dims = tuple(args16[0].shape) + (L, L, L, L)
        k1_ms = cuda_time_ms(lambda: fused.fused_correlate(*args16))
        k1_simt_ms = cuda_time_ms(
            lambda: fused._launch_simt(args16, dims, *D16))
        k1_plain_ms = cuda_time_ms(
            lambda: fused.fused_correlate_reference(*args16))
        b, K, C, X, Y = args16[0].shape
        # K1's function as FFTs, per (rotation, kz): forward along y (X
        # rows) and x (L columns) per channel, the product with H summed
        # over channels, inverse along x and y.
        k1_flops = (C * (X + L) * fft_flops(L) + 8 * C * L * L
                    + 2 * L * fft_flops(L)) * K * b

        def k1_bound(args):
            return bound(sum(t.numel() * t.element_size() for t in args)
                         + 2 * D16[0].numel() * 4, k1_flops, "bfloat16")

        bounds = {"k1": k1_bound(args16)}
        # The batched step: 4 complexes x 32 rotations against their own
        # spectra (the bound's bytes gain 3 spectra), against plain, and
        # timed in turns with G = 1 on the same A.
        args16_g4 = grouped(corr16, args16)
        bounds["k1_G4"] = k1_bound(args16_g4)
        k1g_err, k1g_route, _ = k1_check(args16_g4)
        k1_turns = {"G1": [], "G4": []}
        for key in ("G1", "G4", "G4", "G1"):
            a = args16_g4 if key == "G4" else args16
            k1_turns[key].append(cuda_time_ms(
                lambda: fused.fused_correlate(*a)))
        k1_g4_ms = sum(k1_turns["G4"]) / 2
        del args16_g4
        k2_turns, k2_plain_ms, k2_errs, bounds["k2"] = k2_both_routes(
            (D16[0], D16[1], corr16.MzRe, corr16.MzIm, bias[None]))
        k2_fft_ms = sum(k2_turns["fft"]) / 2
        k2_dense_ms = sum(k2_turns["dense"]) / 2
        # The 16-head rescore's K2 launch: 48 rows, 16 bias groups.
        g16 = torch.Generator(device=dev).manual_seed(16)
        bias16 = torch.where(torch.rand((16, L, L, L), generator=g16,
                                        device=dev) < 0.6, 0.0, float("-inf"))
        k2g_turns, k2g_plain_ms, k2g_errs, k2g_bound = k2_both_routes(
            (D16[0][:48], D16[1][:48], corr16.MzRe, corr16.MzIm, bias16))
        del D16, args16, bias16
        # Both K3 kernels on the dft_pallas path's chunk.
        k3_args = k3_inputs(128)
        k3_turns, k3_plain_ms, k3_errs, k3_want = both_routes(
            {"dense": idft._launch_dense, "fft": idft._launch_fft},
            idft.idft_bc_reference, k3_args)
        k3_fft_ms = sum(k3_turns["fft"]) / 2
        k3_dense_ms = sum(k3_turns["dense"]) / 2

        # The one PyTorch call that computes K3's function; never used by
        # the port, only its yardstick.
        def k3_library():
            return torch.fft.ifft2(torch.complex(k3_args[0], k3_args[1]),
                                   dim=(1, 2)).real

        k3_library_ms = cuda_time_ms(k3_library)
        k3_library_err = rel_err(k3_library(), k3_want)
        # K3's function as FFTs: one along kx and one along ky per line;
        # both routes share this bound.
        nvol = k3_args[0].numel()
        bounds["k3"] = bound((3 * nvol + 4 * L * L) * 4,
                             2 * (nvol // L) * fft_flops(L), "float32")
        del k3_args, k3_want
        # The SIMT K1 in float32 at box 96 (boxes it refused before its
        # A slab left shared memory).
        a96 = k1_random_inputs(128, 96, dtype_name="float32")
        D96 = [torch.empty((128, L // 2 + 1, L, L), device=dev)
               for _ in range(2)]
        k1_simt_f32_box96_ms = cuda_time_ms(lambda: fused._launch_simt(
            a96, tuple(a96[0].shape) + (L, L, L, L), *D96), reps=2)
        del a96, D96
    emit("kernel_times", batch=128, dtype="bfloat16", Ls=Ls, k1_ms=k1_ms,
         k1_simt_ms=k1_simt_ms, k1_plain_ms=k1_plain_ms,
         k1_groups=dict(G=4, turns=k1_turns, ms=k1_g4_ms, route=k1g_route,
                        max_abs_err=k1g_err[0], rel_err=k1g_err[1]),
         k2_fft_ms=k2_fft_ms, k2_dense_ms=k2_dense_ms, k2_turns=k2_turns,
         k2_plain_ms=k2_plain_ms, k2_dtype="float32",
         k2_rel_err={r: e[1] for r, e in k2_errs.items()},
         k2_rescore=dict(batch=48, groups=16, turns=k2g_turns,
                         plain_ms=k2g_plain_ms, bound=k2g_bound,
                         rel_err={r: e[1] for r, e in k2g_errs.items()}),
         k1_simt_float32_box96_ms=k1_simt_f32_box96_ms,
         k3_fft_ms=k3_fft_ms, k3_dense_ms=k3_dense_ms, k3_turns=k3_turns,
         k3_rel_err={r: e[1] for r, e in k3_errs.items()},
         k3_plain_ms=k3_plain_ms, k3_library_ms=k3_library_ms,
         k3_library_rel_err=k3_library_err[1], k3_dtype="float32",
         k3_library="torch.fft.ifft2(torch.complex(Ere, Eim), "
                    "dim=(1, 2)).real",
         bounds=bounds, peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                               "flops_per_s": PEAK_FLOPS},
         timer="cuda events, mean of 5 after 1 warm-up (2 for the box-96 "
               "SIMT K1)", card=card)
    check(k3_library_err[1] <= TOL_F32,
          f"torch.fft.ifft2 is not K3's function: {k3_library_err}")
    check(k1g_route == "tc" and k1g_err[1] <= TOL_BF16,
          f"K1 with 4 receptor groups at b=128: {k1g_route} {k1g_err}")
    for shape, route_errs in (("b=128", k2_errs), ("b=48, G=16", k2g_errs)):
        for route, e in route_errs.items():
            check(e[1] <= TOL_F32, f"K2 {route} at {shape}: {e}")
    for route, e in k3_errs.items():
        check(e[1] <= TOL_F32, f"K3 {route} at b=128: {e}")

    # ---- phase 3: the slice serves three dock requests ----
    emit("serve_config", rotations_per_request=N_ROT_SERVE,
         cut_from=BENCH_ROTATIONS, grid=L, lig_grid=Ls, top_k=top_k,
         chunk=serve_cfg.rotation_chunk, dtype="bfloat16", coupling_rank=3,
         model="pretrained/synthetic-v9p/best_params.npz")
    fused.launches = fused.launches_tc = 0
    invz_topk.launches = invz_topk.launches_fft = 0
    requests = []
    for seed in SEEDS:
        c = synthetic_complex(seed=seed, n_res_rec=60, n_res_lig=30)
        k1_0, tc_0, k2_0, fft_0 = (fused.launches, fused.launches_tc,
                                   invz_topk.launches, invz_topk.launches_fft)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = pipe.dock_complex(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(seed=seed, wall_seconds=wall,
                   rotations_per_second=N_ROT_SERVE / wall,
                   poses=len(poses), top1_score=float(poses.scores[0]),
                   top1_rot_idx=int(poses.rot_idx[0]),
                   top1_shift=[int(v) for v in poses.shifts[0]],
                   k1_launches=fused.launches - k1_0,
                   k1_tc_launches=fused.launches_tc - tc_0,
                   k2_launches=invz_topk.launches - k2_0,
                   k2_fft_launches=invz_topk.launches_fft - fft_0)
        emit("dock_request", **rec)
        requests.append(rec)
        check(len(poses) > 0, f"request {seed}: no poses")
        check(bool(np.isfinite(poses.scores).all()),
              f"request {seed}: non-finite scores")
        check(rec["k1_launches"] > 0 and rec["k2_launches"] > 0,
              f"request {seed}: kernels not launched {rec}")
        check(rec["k1_tc_launches"] == rec["k1_launches"],
              f"request {seed}: a K1 launch missed the tensor cores {rec}")
        check(rec["k2_fft_launches"] == rec["k2_launches"],
              f"request {seed}: a K2 launch missed the FFT kernel {rec}")
    main_launches = {"fused_correlate": fused.launches,
                     "fused_correlate_tc": fused.launches_tc,
                     "invz_blockmax_fft": invz_topk.launches_fft}

    # One request at grid 96, where K2 runs its dense kernel.
    pipe96 = DockingPipeline(serve_cfg.replace(grid_size=96,
                                               num_rotations=256),
                             params=params, device=dev)
    invz_topk.launches = invz_topk.launches_fft = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses96 = pipe96.dock_complex(cplx)
    torch.cuda.synchronize()
    dense_path = dict(grid=96, rotations=256,
                      wall_seconds=time.perf_counter() - t0,
                      poses=len(poses96), top1_score=float(poses96.scores[0]),
                      k2_launches=invz_topk.launches,
                      k2_fft_launches=invz_topk.launches_fft)
    emit("dock_request_grid96", **dense_path)
    check(len(poses96) > 0 and bool(np.isfinite(poses96.scores).all()),
          f"grid-96 request: no or non-finite poses {dense_path}")
    check(dense_path["k2_launches"] > 0 and dense_path["k2_fft_launches"] == 0,
          f"grid-96 request: K2 did not run its dense kernel {dense_path}")

    # One float32 request at grid 128 with a ligand box of 96, where K1
    # runs its SIMT kernel; phase 4 runs the same request on the CPU.
    cfg_box96 = serve_cfg.replace(compute_dtype="float32", dft_dtype="float32",
                                  lig_grid_size=96, num_rotations=N_ROT_BOX96,
                                  rotation_chunk=16)
    pipe_box96 = DockingPipeline(cfg_box96, params=params, device=dev)
    fused.launches = fused.launches_tc = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses_box96 = pipe_box96.dock_complex(cplx, cluster=False)
    torch.cuda.synchronize()
    box96 = dict(grid=L, lig_grid=96, dtype="float32",
                 rotations=N_ROT_BOX96, chunk=16,
                 wall_seconds=time.perf_counter() - t0,
                 poses=len(poses_box96),
                 top1_score=float(poses_box96.scores[0]),
                 k1_launches=fused.launches,
                 k1_tc_launches=fused.launches_tc)
    emit("dock_request_box96", **box96)
    check(len(poses_box96) > 0 and bool(np.isfinite(poses_box96.scores).all()),
          f"box-96 request: no or non-finite poses {box96}")
    check(box96["k1_launches"] > 0 and box96["k1_tc_launches"] == 0,
          f"box-96 request: K1 did not run its SIMT kernel {box96}")

    # ---- phase 4: card against CPU at grid 64, float32 and bf16 ----
    cmp_cfg = serve_cfg.replace(grid_size=64, compute_dtype="float32",
                                dft_dtype="float32", num_rotations=256)
    for dtype, rtol in (("float32", 1e-3), ("bfloat16", TOL_BF16)):
        cfg = cmp_cfg.replace(compute_dtype=dtype, dft_dtype=dtype)
        results = {}
        for where in ("cuda", "cpu"):
            p = DockingPipeline(cfg, params=params, device=where)
            n0, tc0 = fused.launches, fused.launches_tc
            k2_0, fft0 = invz_topk.launches, invz_topk.launches_fft
            t0 = time.perf_counter()
            results[where] = p.dock_complex(cplx, cluster=False)
            results[where + "_s"] = time.perf_counter() - t0
            results[where + "_k1"] = (fused.launches - n0,
                                      fused.launches_tc - tc0)
            results[where + "_k2"] = (invz_topk.launches - k2_0,
                                      invz_topk.launches_fft - fft0)
        g, w = results["cuda"], results["cpu"]
        vals_ok = np.allclose(np.sort(g.scores), np.sort(w.scores),
                              rtol=rtol, atol=0)
        top1_ok = (int(g.rot_idx[0]) == int(w.rot_idx[0])
                   and list(g.shifts[0]) == list(w.shifts[0]))
        emit("card_vs_cpu", grid=64, rotations=256, dtype=dtype, rtol=rtol,
             cuda_seconds=results["cuda_s"], cpu_seconds=results["cpu_s"],
             max_rel_diff=float(np.max(np.abs(np.sort(g.scores)
                                               - np.sort(w.scores))
                                        / np.abs(np.sort(w.scores)))),
             k1_launches=results["cuda_k1"][0],
             k1_tc_launches=results["cuda_k1"][1],
             k2_launches=results["cuda_k2"][0],
             k2_fft_launches=results["cuda_k2"][1], top1_same=top1_ok,
             top1_cuda=[int(g.rot_idx[0])] + [int(v) for v in g.shifts[0]],
             top1_cpu=[int(w.rot_idx[0])] + [int(v) for v in w.shifts[0]])
        check(vals_ok, f"{dtype}: top-K values differ between card and CPU")
        check(results["cuda_k1"][0] > 0
              and results["cuda_k1"][1] == (results["cuda_k1"][0]
                                            if dtype == "bfloat16" else 0),
              f"{dtype}: K1 routes on the card {results['cuda_k1']}")
        check(results["cuda_k2"][0] > 0
              and results["cuda_k2"][1] == results["cuda_k2"][0]
              and results["cpu_k2"] == (0, 0),
              f"{dtype}: K2 routes {results['cuda_k2']} {results['cpu_k2']}")
        if dtype == "float32":
            check(top1_ok, "top-1 pose differs between card and CPU")

    t0 = time.perf_counter()
    cpu_box96 = DockingPipeline(cfg_box96, params=params,
                                device="cpu").dock_complex(cplx, cluster=False)
    g, w = poses_box96, cpu_box96
    top1_ok = (int(g.rot_idx[0]) == int(w.rot_idx[0])
               and list(g.shifts[0]) == list(w.shifts[0]))
    emit("card_vs_cpu_box96", grid=L, lig_grid=96, rotations=N_ROT_BOX96,
         dtype="float32", rtol=1e-3, cuda_seconds=box96["wall_seconds"],
         cpu_seconds=time.perf_counter() - t0,
         max_rel_diff=float(np.max(np.abs(np.sort(g.scores)
                                           - np.sort(w.scores))
                                    / np.abs(np.sort(w.scores)))),
         top1_same=top1_ok,
         top1_cuda=[int(g.rot_idx[0])] + [int(v) for v in g.shifts[0]],
         top1_cpu=[int(w.rot_idx[0])] + [int(v) for v in w.shifts[0]])
    check(np.allclose(np.sort(g.scores), np.sort(w.scores), rtol=1e-3,
                      atol=0), "box-96: top-K values differ card vs CPU")
    check(top1_ok, "box-96: top-1 pose differs between card and CPU")

    # ---- phase 5: the screening slice (DockingService, dft_pallas) ----
    screen_cfg = serve_cfg.replace(fft_impl="dft_pallas")
    svc = DockingService(screen_cfg, params, device=dev)
    receptor = cplx.receptor
    emit("screen_config", engine="dft_pallas", receptor_seed=0,
         ligand_seeds=list(SEEDS), rotations_per_query=N_ROT_SERVE,
         rescore={"top": 16, "nrot": 48}, refine_steps=30, grid=L,
         top_k=top_k, chunk=serve_cfg.rotation_chunk, dtype="bfloat16")

    def stage(fn):
        """(result, wall seconds, K3 launches) of one stage."""
        n0 = idft.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, idft.launches - n0

    def bf16_tol(scores):
        return TOL_BF16 * float(np.abs(scores).max())

    idft.launches = idft.launches_fft = 0
    dock_stats = {"hits": 0, "misses": 0}
    lig0 = None
    for seed in SEEDS:
        lig = synthetic_complex(seed=seed, n_res_rec=60,
                                n_res_lig=30).ligand
        h0, m0 = svc.hits, svc.misses
        poses, dock_s, dock_k3 = stage(lambda: svc.dock(receptor, lig))
        dock_stats["hits"] += svc.hits - h0
        dock_stats["misses"] += svc.misses - m0
        resc, resc_s, resc_k3 = stage(lambda: svc.rescore(
            receptor, lig, poses, top=16, nrot=48))
        n = min(16, len(poses))
        rec = dict(ligand_seed=seed, poses=len(poses), heads=n,
                   dock_seconds=dock_s, dock_k3_launches=dock_k3,
                   rescore_seconds=resc_s, rescore_k3_launches=resc_k3,
                   top1_before=float(poses.scores[0]),
                   top1_after=float(resc.scores[0]))
        check(np.isfinite(poses.scores).all()
              and np.isfinite(resc.scores).all(),
              f"query {seed}: non-finite scores")
        check(dock_k3 > 0 and resc_k3 > 0, f"query {seed}: K3 idle {rec}")
        # Each head's cone holds the head, so sorted rescored heads sit
        # at or above the sorted coarse heads (up to bf16 rounding).
        check(np.all(np.sort(resc.scores[:n]) >= np.sort(poses.scores[:n])
                     - bf16_tol(poses.scores)),
              f"query {seed}: a rescored head fell below the coarse scores")
        if lig0 is None:
            lig0 = lig
            prep, engine = svc.cached(receptor, lig)
            heads = PoseSet(*(f[:n] for f in resc[:5]))
            ref, ref_s, ref_k3 = stage(lambda: svc.pipeline.refine(
                receptor, lig, heads, steps=30, prep=prep, engine=engine))
            rec.update(refine_seconds=ref_s, refine_poses=n,
                       top1_refined=float(ref.scores[0]))
            check(np.isfinite(ref.scores).all(), "refine: non-finite")
            check(np.all(np.sort(ref.scores) >= np.sort(heads.scores)
                         - bf16_tol(heads.scores)),
                  "refine: a refined score fell below the initial ones")
        emit("screen_query", **rec)
    screen_launches = idft.launches
    screen_fft_launches = idft.launches_fft
    emit("screen_service", dock_stats=dock_stats, stats=svc.stats,
         k3_launches=screen_launches, k3_fft_launches=screen_fft_launches)
    check(dock_stats == {"hits": 2, "misses": 1} and svc.misses == 1
          and svc.stats["entries"] == 1,
          f"service cache: docks {dock_stats}, all {svc.stats}")
    check(screen_fft_launches == screen_launches > 0,
          f"a grid-128 K3 launch missed the FFT kernel: {screen_launches} "
          f"launches, {screen_fft_launches} FFT")

    # One dft_pallas dock at grid 96, where K3 runs its dense kernel.
    pipe96p = DockingPipeline(screen_cfg.replace(grid_size=96,
                                                 num_rotations=256),
                              params=params, device=dev)
    idft.launches = idft.launches_fft = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses96p = pipe96p.dock_complex(cplx)
    torch.cuda.synchronize()
    k3_dense_path = dict(grid=96, rotations=256,
                         wall_seconds=time.perf_counter() - t0,
                         poses=len(poses96p),
                         top1_score=float(poses96p.scores[0]),
                         k3_launches=idft.launches,
                         k3_fft_launches=idft.launches_fft)
    emit("screen_dock_grid96", **k3_dense_path)
    check(len(poses96p) > 0 and bool(np.isfinite(poses96p.scores).all()),
          f"grid-96 dft_pallas dock: no or non-finite poses {k3_dense_path}")
    check(k3_dense_path["k3_launches"] > 0
          and k3_dense_path["k3_fft_launches"] == 0,
          f"grid-96 dft_pallas dock: K3 did not run its dense kernel "
          f"{k3_dense_path}")

    # One rescore on the main-path dft_fused engine: K2 takes the 16 head
    # masks as bias groups.
    groups = []
    blockmax = invz_topk.invz_blockmax

    def spy(Dre, Dim, MzRe, MzIm, bias):
        groups.append(1 if bias.ndim == 3 else int(bias.shape[0]))
        return blockmax(Dre, Dim, MzRe, MzIm, bias)

    # Its coarse poses unclustered, so that 16 heads exist.
    svc_fused = DockingService(serve_cfg, params, device=dev)
    coarse = svc_fused.dock(receptor, lig0, cluster=False)
    fused.launches = fused.launches_tc = invz_topk.launches = 0
    invz_topk.launches_fft = 0
    invz_topk.invz_blockmax = spy
    try:
        fres, fres_s, _ = stage(lambda: svc_fused.rescore(
            receptor, lig0, coarse, top=16, nrot=48))
    finally:
        invz_topk.invz_blockmax = blockmax
    emit("fused_rescore", seconds=fres_s, k1_launches=fused.launches,
         k1_tc_launches=fused.launches_tc, k2_launches=invz_topk.launches,
         k2_fft_launches=invz_topk.launches_fft,
         k2_bias_groups=sorted(set(groups)),
         top1_after=float(fres.scores[0]))
    check(fused.launches > 0
          and invz_topk.launches == invz_topk.launches_fft > 0,
          "dft_fused rescore did not launch K1 and the FFT K2")
    check(set(groups) == {16}, f"K2 bias groups {groups}, expected 16")

    # ---- phase 6: card against CPU on the dft_pallas path ----
    cmp6_cfg = cmp_cfg.replace(fft_impl="dft_pallas")
    out6 = {}
    idft.launches = idft.launches_fft = 0
    for where in ("cuda", "cpu"):
        p = DockingPipeline(cmp6_cfg, params=params, device=where)
        t0 = time.perf_counter()
        d = p.dock(receptor, cplx.ligand, cluster=False)
        r = p.rescore(receptor, cplx.ligand, d, top=4, nrot=16)
        f = p.refine(receptor, cplx.ligand, PoseSet(*(x[:4] for x in r[:5])),
                     steps=5)
        out6[where] = (d, r, f, time.perf_counter() - t0)
    (gd, gr, gf, gs), (wd, wr, wf, ws) = out6["cuda"], out6["cpu"]
    k3_cmp = (idft.launches, idft.launches_fft)

    def max_rel(a, b):
        return float(np.max(np.abs(np.sort(a) - np.sort(b))
                            / np.abs(np.sort(b))))

    emit("card_vs_cpu_screen", grid=64, rotations=256, dtype="float32",
         engine="dft_pallas", cuda_seconds=gs, cpu_seconds=ws,
         dock_max_rel_diff=max_rel(gd.scores, wd.scores),
         rescore_max_rel_diff=max_rel(gr.scores, wr.scores),
         refine_max_rel_diff=max_rel(gf.scores, wf.scores),
         top1_cuda=[int(gd.rot_idx[0])] + [int(v) for v in gd.shifts[0]],
         top1_cpu=[int(wd.rot_idx[0])] + [int(v) for v in wd.shifts[0]],
         rescored_top1_cuda=[int(v) for v in gr.shifts[0]],
         rescored_top1_cpu=[int(v) for v in wr.shifts[0]],
         k3_launches=k3_cmp[0], k3_fft_launches=k3_cmp[1])
    check(k3_cmp[0] > 0 and k3_cmp[1] == k3_cmp[0],
          f"grid-64 dft_pallas: K3 launches {k3_cmp}, expected all FFT")
    check(np.allclose(np.sort(gd.scores), np.sort(wd.scores), rtol=1e-3,
                      atol=0), "dft_pallas dock: top-K differs card vs CPU")
    check(int(gd.rot_idx[0]) == int(wd.rot_idx[0])
          and list(gd.shifts[0]) == list(wd.shifts[0]),
          "dft_pallas dock: top-1 pose differs card vs CPU")
    check(np.allclose(gr.rotations[0], wr.rotations[0], atol=1e-5)
          and list(gr.shifts[0]) == list(wr.shifts[0])
          and np.allclose(gr.scores, wr.scores, rtol=1e-3, atol=0),
          "rescore differs card vs CPU")
    check(np.allclose(gf.scores, wf.scores, rtol=1e-3, atol=0),
          "refine differs card vs CPU")

    # ---- phase 7: band 100's local rows against the committed CPU rows ----
    band = band100_local(dev, params)
    emit("band100_local", card=card, **band)
    check_band100(band)
    band_launches = band["launches"]

    # ---- phase 8: batched and ensemble docking ----
    del H4
    phase8 = batched_and_ensemble(dev, pipe, params, cmp_cfg, group)
    phase8["batched"]["phase3_request_seconds"] = [
        r["wall_seconds"] for r in requests]
    phase8["batched"]["phase3_rotations_per_second"] = [
        r["rotations_per_second"] for r in requests]
    emit("batched_and_ensemble", card=card, rtol=BATCH_RTOL, **phase8)
    check_batched(phase8)
    batched_launches = phase8["batched"]["launches"]

    def band_count(name):
        return sum(n[name] for n in band_launches.values())

    def band_errs(prefix):
        """Phase 7's max abs errors against plain, by row and launch."""
        return {row: {n: e["max_abs_err"] for n, e in errs.items()
                      if n.startswith(prefix)}
                for row, errs in band["kernels_vs_plain"].items()}

    src = "deeplocalproteindocking_torch/csrc/"
    tpu = "deeplocalproteindocking_tpu/correlate/"
    print(json.dumps({"kernels": [
        {"name": "fused_correlate", "route": "cuda",
         "source": src + "fused_correlate_tc.cu",
         "sources": {"tc": src + "fused_correlate_tc.cu",
                     "simt": src + "fused_correlate.cu"},
         "replaces": tpu + "pallas_fused.py:57",
         "launches": main_launches["fused_correlate"],
         "launches_by_route": {
             "tc": main_launches["fused_correlate_tc"],
             "simt": main_launches["fused_correlate"]
             - main_launches["fused_correlate_tc"]},
         "launches_band100": {"tc": band_count("k1_tc"),
                              "simt": band_count("k1_simt")},
         "max_abs_err": errs["k1_bfloat16"][0],
         "max_abs_err_float32": errs["k1_float32"][0],
         "max_abs_err_band100": band_errs("k1"),
         "launches_batched": {"tc": batched_launches["k1_tc"],
                              "simt": batched_launches["k1"]
                              - batched_launches["k1_tc"],
                              "h_groups": phase8["batched"]["k1_groups"]},
         "max_abs_err_groups": {
             "tc_G4_b128": k1g_err[0], "simt_float32_G4_b8":
             errs["k1_f32_G4"][0],
             "batched_first_launch": phase8["batched"]["k1_first"][
                 "max_abs_err"]},
         "ms_groups": k1_g4_ms, "ms_groups_turns": k1_turns,
         "bound_ms_groups": bounds["k1_G4"]["bound_ms"],
         "tolerance": f"bf16 {TOL_BF16}, float32 {TOL_F32} x max|plain|",
         "ms": k1_ms, "simt_ms": k1_simt_ms,
         "simt_float32_box96_ms": k1_simt_f32_box96_ms,
         "plain_ms": k1_plain_ms,
         "bound_ms": bounds["k1"]["bound_ms"],
         "bound_by": bounds["k1"]["bound_by"], "library_ms": None},
        {"name": "invz_blockmax_fft", "route": "cuda",
         "source": src + "invz_blockmax_fft.cu",
         "replaces": tpu + "pallas_invz_topk.py:54",
         "launches": main_launches["invz_blockmax_fft"],
         "launches_band100": band_count("k2_fft"),
         "launches_batched": batched_launches["k2_fft"],
         "max_abs_err": errs["k2_fft"][0],
         "max_abs_err_L64": errs["k2_fft_L64"][0],
         "max_abs_err_b128": k2_errs["fft"][0],
         "max_abs_err_band100": band_errs("k2"),
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k2_fft_ms, "plain_ms": k2_plain_ms,
         "bound_ms": bounds["k2"]["bound_ms"],
         "bound_by": bounds["k2"]["bound_by"], "library_ms": None},
        {"name": "invz_blockmax", "route": "cuda",
         "source": src + "invz_blockmax.cu",
         "replaces": tpu + "pallas_invz_topk.py:54",
         "launches": dense_path["k2_launches"],
         "launches_path": "one dock request at grid 96 (K2's dense route)",
         "launches_band100": band_count("k2") - band_count("k2_fft"),
         "max_abs_err": errs["k2_dense_L96"][0],
         "max_abs_err_b128": k2_errs["dense"][0],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k2_dense_ms, "plain_ms": k2_plain_ms,
         "bound_ms": bounds["k2"]["bound_ms"],
         "bound_by": bounds["k2"]["bound_by"], "library_ms": None},
        {"name": "idft_fft", "route": "cuda",
         "source": src + "idft_fft.cu",
         "replaces": tpu + "pallas_idft.py:34",
         "launches": screen_fft_launches,
         "launches_path": "the screening service at grid 128 (phase 5)",
         "launches_band100": band_count("k3_fft"),
         "max_abs_err": errs["k3"][0],
         "max_abs_err_L64": errs["k3_fft_L64"][0],
         "max_abs_err_b128": k3_errs["fft"][0],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k3_fft_ms, "plain_ms": k3_plain_ms,
         "bound_ms": bounds["k3"]["bound_ms"],
         "bound_by": bounds["k3"]["bound_by"],
         "library_ms": k3_library_ms},
        {"name": "idft_bc", "route": "cuda",
         "source": src + "idft_bc.cu",
         "replaces": tpu + "pallas_idft.py:34",
         "launches": k3_dense_path["k3_launches"],
         "launches_path": "one dft_pallas dock at grid 96 (K3's dense "
                          "route)",
         "launches_band100": band_count("k3") - band_count("k3_fft"),
         "max_abs_err": errs["k3_dense_L96"][0],
         "max_abs_err_b128": k3_errs["dense"][0],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k3_dense_ms, "plain_ms": k3_plain_ms,
         "bound_ms": bounds["k3"]["bound_ms"],
         "bound_by": bounds["k3"]["bound_by"],
         "library_ms": k3_library_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
