#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Drives ``deeplocalproteindocking_torch`` (never JAX) through its main
path and fails (non-zero exit, no final result line) at the first
phase that does not hold:

1. environment: the card's name and power limit, torch/CUDA versions,
   and the build of the hand-written kernels from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes with a batch of 8 rotations (K1 on its two
   routes: bf16 on the tc kernel at the bench complex's box, at box 40,
   at box 64 and at the boxes above 64 that run in tiles of A (72, 96,
   128), float32 on the tf32 kernel at the bench box and at boxes 72,
   96, 128 (with 4 receptor groups at the bench box and at box 96, in
   both dtypes at 96), and both at L = 120, padded to 128 in the kernel
   (bf16 at the bench box, float32 at box 72); K2 with a real
   translation mask, drill-down top-K; K3 on the summed spectrum of the
   ``dft`` engine's forward half, and on random spectra at L = 16, 32,
   48, 64, 80, 96 and 112), plus the time of each kernel and its plain
   version at the
   full batch of 128 (K1 at L = 120, the grid-120 request's shape, on
   tc and in float32 at box 72 on tf32; each tensor-core route at boxes
   72, 96 and 128, each held against plain, with its bound; in float32
   on its tf32 kernel, held against plain, at the bench box and at the
   v9p checkpoint's config (grid 64, box 40, C = 16, 16 rows); K2 (its
   FFT kernel, the only one) at L = 128 on the bench complex's D and at
   L = 32, 64 and 96, timed and held against plain at b = 128 and at the
   rescore's b = 48 with 16 bias groups, and at L = 32 and 96, b = 128;
   K3 (its FFT kernel, the only one) timed and held against plain at
   b = 128 and L = 16, 32, 48, 80, 96, 112 and 128, each beside the
   library call ``torch.fft.ifft2`` that computes K3's function, which
   it must beat at every L; every K2 and K3 time with its
   launches queued behind a device sleep, so that the host's launch
   overhead, which is of the size of the kernels at L = 16 and 32, is
   not counted), with each kernel's
   bound at those shapes: the bytes its function must move or the
   operations of that function done as FFTs at the peak rate for how
   they can run (float32 K1 on the tensor cores as 3xTF32), whichever
   takes longer; and the splat kernel (``csrc/separable_splat.cu``) at
   the sweeps' chunks (128 rotations of a 250-residue ligand at box 72,
   16 of a 35-residue one at box 40), timed beside its plain version and
   the ``torch.bmm`` it replaces, with its bound (its FMAs at the
   float32 peak or its output's bytes), held against plain voxel by
   voxel;
3. the slice: the v9p hybrid model (exported weights, rank-3 coupling
   folded into the last conv, bf16, grid 128, top-K 64, chunk 128)
   serves three ``DockingPipeline.dock`` requests, proving through the
   launch counters that K1 (every launch on the tensor-core kernel) and
   K2 (every launch on the FFT kernel) ran in each; then two float32
   requests of 64 rotations, each also on the CPU (top-K values within
   rtol 1e-3, the same top-1) and each first K2 launch held against
   plain: one at grid 96 (the rep-score and train presets' grid) and
   one at grid 32, every K2 launch of both on its FFT kernel; one at grid 120
   (not a multiple of 16) runs K1's tc kernel padded to 128 (bf16, 256
   rotations), and one more at grid 120 in float32 (64 rotations, also
   on the CPU) its tf32 kernel; one float32 request at grid 128 with a
   ligand box of 96 runs K1's tf32 kernel in 2 x 2 tiles of A, and two
   float32
   requests of 2,048 rotations run every K1 launch on the tf32 kernel:
   the bench config in float32 and the v9p checkpoint's own
   ``config.json`` (grid 64, box 40, chunk 16, full-rank coupling);
   then two requests uncut at 13,000 rotations on a 250-residue polymer
   ligand whose own box (``auto_ligand_grid``) is above 64: the
   ``full-sweep`` preset's settings in float32 and the serve config in
   bf16, every K1 launch on the tensor cores (tf32, tc), every splat on
   its kernel (one a chunk in the sweep, none on the plain version);
4. card against CPU: one request at grid 64, 256 rotations, once on CUDA
   tensors (kernels) and once on CPU tensors (plain versions), in
   float32 (K1 on the tf32 kernel; top-K values within rtol 1e-3 and the
   same top-1 pose) and
   in bf16 (top-K values within rtol 2e-2); and the float32 box-96
   request of phase 3 on the CPU (top-K within rtol 1e-3, same top-1);
5. the screening slice: one ``DockingService`` on the same model with
   ``fft_impl="dft_pallas"`` docks the receptor of seed 0 against the
   ligands of seeds 0-2 (``dock`` then ``rescore(top=16, nrot=48)``
   each; the first also ``refine(steps=30)`` through the cached
   engine), proving that K3 ran in every stage, every launch on its FFT
   kernel; then four float32 ``dft_pallas`` docks of 64 rotations, each
   also on the CPU and each first K3 launch held against plain: grids
   96, 80, 112 and 32, every K3 launch on its FFT kernel; and one
   ``rescore``
   on the main-path ``dft_fused`` engine, whose K2 must see 16 bias
   groups;
6. card against CPU for that path: dock -> rescore -> refine at
   float32, grid 64, 256 rotations, ``dft_pallas`` (K3 on its FFT
   kernel);
7. band 100's local rows on the card: the 48 held-out polymer complexes
   (seeds 100-147, size-diverse, unbound 1.2 A) docked under the local
   protocol (grid 64, 64 rotations in a 50-degree cone, +-8 A, top-K 64,
   NMS 5 A, chunk 64) by the shape baseline (float32, every K1 launch on
   the tf32 kernel) and by the v9p model (bf16, full-rank coupling, every
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
   rotations on ``dft_fused`` (tf32 K1, 2 groups; FFT K2) and on
   ``dft_pallas`` (FFT K3), on the card and on the CPU (top-K within
   1e-3 relative, the same top-1 per complex).  Phase 2 also holds K1
   with 4 receptor groups against plain (tensor cores at b = 128, the
   batched step; tf32 in float32 at b = 8; both tensor-core routes at
   box 96, b = 8) and times G = 4 against G = 1 in turns.
9. training at the full width of the v9p config (its ``config.json`` as
   committed: grid 64, box 40, C = 16, 24 decoys x 2 complexes, AdamW
   lr 1e-4, wd 1e-4, cosine over 3,000 steps): the port's flagship
   driver (``train_flagship.run``) for 12 steps from a seeded init on 8
   training complexes (seeds 200+, unbound 1.2 A), mining every 4 steps
   over 4 complexes at 320 rotations (top-K 24), validation at step 0
   and step 12 on 2 complexes (seeds 50+) at 256 rotations; every loss
   and accuracy finite, every K1 launch of mining and validation on the
   tf32 kernel, every K2 launch on the FFT kernel, K3 idle, the first
   mining K1 and K2 launches held against their plain versions; then 8
   steps from the run's trained params on one fixed batch (with its
   mined negatives) must lower the loss, one step (1 complex x 8
   decoys, the run's trained params) on the card against the CPU (loss
   and accuracy rtol 1e-4, every gradient within 1e-3 of its leaf's
   largest), and a checkpoint saved and restored bit for bit.
10. the CLI (``deeplocalproteindocking_torch.cli.main``, in process),
   each command with the launch counts set to 0 just before it and read
   just after, one JSON line each: ``generate-dataset`` (3 polymer
   complexes, unbound 1.2 A; one ligand rewritten as mmCIF, one as two
   NMR models); ``dock --checkpoint pretrained/synthetic-v9p`` at the
   checkpoint's own config, the full 13,000 rotations (grid 64, box 40,
   float32, chunk 16: 813 K1 launches, all tf32, and 813 K2, all FFT),
   cold then warm, and at 256 rotations on the card (profiled:
   ``--profile`` must write a trace) against the CPU (top-K within rtol
   1e-3, the same top-1); ``dock --preset full-sweep`` without a
   checkpoint (the shape channels, as the JAX CLI docks; grid 128,
   13,000 rotations, chunk 128: 102 K1 tf32, 102 K2 FFT), cold then
   warm; v9p docks of 2,048 rotations with ``--rescore-top 4
   --refine-steps 5`` and with ``--ensemble product --max-models 2``;
   ``screen --fft-impl dft_pallas --rescore-top 4`` of one receptor
   against 3 ligands (one mmCIF; every K3 launch FFT; one receptor
   preparation); ``evaluate --batch-size 3`` of the generated directory
   (K1 with 3 receptor groups); ``train`` 4 steps, then ``--resume`` to
   6 (every loss finite), and a dock from its ``state.pt``; ``doctor``
   (the card named; K1 tf32, K2 and K3 FFT at grid 64).  Phase 10 runs
   under torch's TF32 defaults (cuDNN on, matmul off), as a user's CLI
   does; the earlier phases turn both off.  The full-depth
   request's first K1 and K2 launches and the screen's first K3 launch
   are held against their plain versions.
11. grids above 128^3 and the resample sweep (no kernel on either
   path: ``torch.fft`` and ``torch`` gathers, as the JAX package runs
   them outside Pallas), TF32 off, the v9p hybrid unless a step says
   otherwise, one JSON line per step, the launch counts set to 0 before
   each request and read after it: the checkpoint's ``config.json`` at
   grid 128 (float32, full rank, 256 rotations) under ``fft_impl=
   "block"`` (block 32; no K1, K2 or K3) against ``dft_fused`` (16 tf32
   K1, 16 FFT K2), top-K within rtol 1e-3 and the same top-1;
   ``measure_256`` at grids 192 and 256 (shape mode, bf16, block 64,
   64 rotations) and v9p at grid 256 (block 64, 256 rotations, cold and
   warm) through the default engine, which resolves to block, with
   seconds, rotations/s, ms per rotation, peak MB and one chunk's
   full-grid spectra beside it; card against CPU under block at grid 64
   (dock -> rescore(4 x 16) -> refine(5), rtol 1e-3, the same top-1);
   resample: ``tests/golden_sweep.json``'s protocol under its gate, the
   checkpoint's config and ``PRESETS["full-sweep"]`` (shape channels)
   at 2,048 rotations, timed warm after a cold request of 256, card
   against CPU at grid 64 (256
   rotations), a 2 x 2 ensemble against four single docks merged;
   ``topk_impl="approx"`` on the bench config (2,048 rotations: K1, no
   K2) against exact (rtol 2e-2, the same top-1); one train step under
   resample and under block card against CPU (phase 9's gates); the CLI
   docking v9p at grid 192 (the geometry warning prints) and in resample
   mode.  Rotation counts are cut below 13,000 (``reduced`` in each
   line); widths are not.
12. the multi-GPU layer (``parallel/``): ``max(2, cards)`` ranks spawned
   from here, rank r on ``cuda:(r % cards)``, over gloo when ranks share
   a card (one card: NCCL refuses two ranks on it) and NCCL when each has
   its own, TF32 off.  In every rank: the rotation-sharded docks of the
   bf16 bench config and of the v9p checkpoint's config at 2,048
   rotations, with the launch counts set to 0 just before and read just
   after (every rank must launch K1 on its tc / tf32 kernel and K2 on
   its FFT kernel, and no K3; each config's first K1 and K2 launch held
   against plain), against the single-card dock (top-K within rtol 1e-3,
   the same top-1, the same result on every rank); ``dock_batch`` of one
   complex per rank over ``(1, ranks)`` and ``(ranks, 1)`` against each
   complex's own sweep; ``sharded_block_correlate`` at L = 128, block 32,
   its gathered slabs against the whole grid; one data-parallel train
   step at the v9p config's width (2 complexes x 24 decoys over ``(2,
   ranks / 2)``) against ``Trainer.value_and_grad`` on one rank (phase
   9's tolerances), then three steps with the params identical on every
   rank; ``cli dock --mesh-rot <ranks>`` against ``--mesh-rot 1``.
13. the JAX package's Orbax checkpoints, restored through the port's own
   reader (``train/checkpoint.py``; no JAX, tensorstore, orbax or
   zstandard), TF32 off: v9p's ``best/`` held equal to
   ``best_params.npz``; the latest ``best/`` (or step) of each of the
   eight families docked on the checkpoint's own ``config.json`` on the
   card and on the CPU (top-K within rtol 1e-3, the same top-1; 32
   rotations, cut from 256 for the CPU half), the launch counts set to 0
   before each card dock and read after it (``dft_fused`` configs must
   launch K1 on its tf32 kernel and K2 on its FFT kernel, the ``dft``
   engine none); v1 again under ``dft_fused`` (tf32 K1, FFT K2 at
   L = 32) and v2 under ``dft_pallas`` (FFT K3 at L = 48), 256 rotations
   each; v9p's ``step_00003000`` resumed as a whole training state
   (params, Adam's moments, count 3000) and stepped once on the card and
   on the CPU (phase 9's tolerances; Adam's updates recorded beside);
   ``coupling_spectrum`` on v5u's ``best/``; the decode seconds of each
   checkpoint.

Each phase prints one JSON line (phase 11 one per step, phase 13 one per
dock and its summary).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

    python3 chip_smoke.py --multi-gpu    # on several cards

runs phase 1 and phase 12 with every card a rank, plus the
13,000-rotation CLI docks (``--preset benchmark-v5e8`` and the v9p
checkpoint) on the mesh and on one card, cold then warm, then once more
with the stages of the command timed (``_cli_dock_split``), then the same
two docks as ``torchrun`` commands against one process, and
``measure_scaling`` at 1, 2, ... ranks up to every card.
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
# The float32 requests at grids 96, 32, 120 (dft_fused) and 96, 80, 112,
# 32 (dft_pallas), each also run on the CPU: two launches each.
N_ROT_SMALL_GRID = 64
SMALL_GRID_CHUNK = 32
# K3 on random spectra (b = 8, phase 2): its FFT kernel at every L it
# takes; key k3_<route>_L<L>.
K3_RANDOM_CHECKS = {"k3_fft_L16": 16, "k3_fft_L32": 32, "k3_fft_L48": 48,
                    "k3_fft_L64": 64, "k3_fft_L80": 80, "k3_fft_L96": 96,
                    "k3_fft_L112": 112}
# Device cycles of the sleep queued ahead of a timed run of small kernels
# (about 10 ms at the H100's 1.98 GHz): long enough for the host to queue
# every launch, so that the events time the device alone.
QUEUE_CYCLES = 20_000_000
# The full-depth requests' complex: a 250-residue polymer ligand, whose
# own box at grid 128 (auto_ligand_grid) is 72.
BIG_COMPLEX = dict(seed=0, n_res_rec=300, n_res_lig=250, backbone=True)
BENCH_ROTATIONS = 13000
SEEDS = (0, 1, 2)
TOL_F32 = 1e-4              # max |kernel - plain| <= TOL * max |plain|
TOL_BF16 = 2e-2
# The card's published peaks (H100 SXM data sheet, dense, at 700 W):
# bf16 and TF32 on the tensor cores, float32 outside them.  Float32 work
# on the tensor cores (3xTF32) takes three TF32 products per product.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
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
# Phase 9: the flagship driver's knobs (v9p's TRAINING.json: training
# seeds 200+, size-diverse, unbound 1.2 A, mining at 320 rotations, EMA
# 0.998), cut to 12 steps, 8 training and 2 validation complexes.
TRAIN_STEPS = 12
TRAIN_ENV = dict(TF_GRID="64", TF_SEEDS="8", TF_SEED0="200",
                 TF_UNBOUND="1.2", TF_MINE_EVERY="4", TF_MINE_CHUNK="4",
                 TF_NROT_MINE="320", TF_VAL_EVERY=str(TRAIN_STEPS),
                 TF_VAL_NROT="256", TF_VAL_COMPLEXES="2", TF_VAL_SEED0="50",
                 TF_EMA="0.998")
TRAIN_RTOL = 1e-4           # loss and accuracy, card vs CPU
GRAD_TOL = 1e-3             # each gradient leaf, x its largest component


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps=5, queued=False):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up.
    ``queued``: the runs wait behind a device sleep of ``QUEUE_CYCLES``
    while the host queues them, so that kernels shorter than their
    launch's host overhead are timed back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
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
    radix-Q pass (radix 2: one butterfly of 4; radix 6: two radix-3
    DFTs of 16 and a radix-2 step of 24), the 1/L scale, the bias add
    and the max."""
    M = L // 2
    Q = M // 8
    radix = {2: 4, 4: 16, 6: 56, 8: 56}
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
    tc0, tf0 = fused.launches_tc, fused.launches_tf32
    got = fused.fused_correlate(*args)
    torch.cuda.synchronize()
    check(fused.launches_tc - tc0 == int(route == "tc")
          and fused.launches_tf32 - tf0 == int(route == "tf32"),
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
    route = "fft" if invz_topk.launches_fft > f0 else "none"
    return (rel_err(got, invz_topk.invz_blockmax_reference(*args)), route,
            got)


def k3_check(args):
    """((max abs err, rel err), route) of one K3 launch on ``args``, held
    against the plain version."""
    import torch
    from deeplocalproteindocking_torch.correlate import idft
    f0 = idft.launches_fft
    got = idft.idft_bc(*args)
    torch.cuda.synchronize()
    route = "fft" if idft.launches_fft > f0 else "none"
    return rel_err(got, idft.idft_bc_reference(*args)), route


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

        def k1_spy(*args, seen=seen, **kw):
            seen.setdefault(f"k1_box{args[0].shape[-1]}", args)
            return k1_launch(*args, **kw)

        def k2_spy(*args, seen=seen):
            seen.setdefault("k2", args)
            return k2_launch(*args)

        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
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
                             k1_tf32=fused.launches_tf32,
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
    check(shape["k1"] > 0 and shape["k1_tf32"] == shape["k1"],
          f"shape_local: K1 not all on the tf32 kernel {shape}")
    check(learned["k1"] > 0 and learned["k1_tc"] == learned["k1"],
          f"learned_local: K1 not all on the tensor cores {learned}")
    for key, n in launches.items():
        check(n["k2"] > 0 and n["k2_fft"] == n["k2"],
              f"{key}: a K2 launch missed the FFT kernel {n}")
        check(n["k3"] == 0, f"{key}: K3 ran {n}")
    # Each row's K1 launches at its two ligand boxes (24 and 32) and its
    # K2 launch, held against their plain versions.
    k1_route = {"shape_local": "tf32", "learned_local": "tc"}
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
        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0

    def counts():
        return dict(k1=fused.launches, k1_tc=fused.launches_tc,
                    k1_tf32=fused.launches_tf32, k2=invz_topk.launches, k2_fft=invz_topk.launches_fft,
                    k3=idft.launches, k3_fft=idft.launches_fft)

    # Spies record each launch's receptor and bias groups, keep the first
    # launch's arguments and time each batched sweep; each launches as
    # the path would.
    k1_launch, k2_launch = dft.fused_correlate, invz_topk.invz_blockmax
    dock_batch = batch_eval.dock_batch
    seen = {}

    def k1_spy(*args, **kw):
        seen.setdefault("k1_groups", []).append(
            args[2].shape[0] if args[2].ndim == 5 else 1)
        seen.setdefault("k1", args)
        return k1_launch(*args, **kw)

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
            check(n["k1"] > 0 and n["k1_tf32"] == n["k1"]
                  and r["k1_groups"] == [2]
                  and n["k2_fft"] == n["k2"] > 0,
                  f"dft_fused dock_batch launches {n} {r['k1_groups']}")
        else:
            check(n["k3_fft"] == n["k3"] > 0,
                  f"dft_pallas dock_batch launches {n}")


def training(dev):
    """Phase 9: the flagship driver at the v9p config's full width, with
    the launch counts set to 0 just before the run and read just after;
    then the overfit, card-vs-CPU and checkpoint checks.  Returns the
    phase's record."""
    import shutil
    import statistics
    import tempfile

    import torch
    from deeplocalproteindocking_torch import train_flagship
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.correlate import (dft, fused, idft,
                                                         invz_topk)
    from deeplocalproteindocking_torch.data.benchmark import synthetic_band
    from deeplocalproteindocking_torch.train import Trainer
    from deeplocalproteindocking_torch.train.data_gen import (
        make_training_batch)
    from deeplocalproteindocking_torch.train.mining import load_mined

    # Spies keep the first K1 and K2 launch of mining and of validation
    # (mining is told apart by a wrapper on the driver's miner) and
    # launch as the path would.
    k1_launch, k2_launch = dft.fused_correlate, invz_topk.invz_blockmax
    mine = train_flagship.mine_hard_negatives
    seen, stage = {}, ["val"]

    def k1_spy(*args, **kw):
        seen.setdefault(stage[0] + "_k1", args)
        return k1_launch(*args, **kw)

    def k2_spy(*args):
        seen.setdefault(stage[0] + "_k2", args)
        return k2_launch(*args)

    def mine_spy(*args, **kw):
        stage[0] = "mine"
        try:
            return mine(*args, **kw)
        finally:
            stage[0] = "val"

    tmp = tempfile.mkdtemp(prefix="dlpd_train_")
    try:
        # The committed v9p config.json beside no checkpoint: the driver
        # starts a run under it.
        ckpt = os.path.join(tmp, "run")
        os.makedirs(ckpt)
        shutil.copy(os.path.join(V9P_DIR, "config.json"), ckpt)
        settings = train_flagship.settings_from_env(TRAIN_ENV)
        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0
        torch.cuda.synchronize(dev)
        mem0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dft.fused_correlate, invz_topk.invz_blockmax = k1_spy, k2_spy
        train_flagship.mine_hard_negatives = mine_spy
        try:
            events = train_flagship.run(TRAIN_STEPS, ckpt, settings, dev)
        finally:
            dft.fused_correlate, invz_topk.invz_blockmax = (k1_launch,
                                                            k2_launch)
            train_flagship.mine_hard_negatives = mine
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = dict(k1=fused.launches, k1_tc=fused.launches_tc,
                        k1_tf32=fused.launches_tf32, k2=invz_topk.launches,
                        k2_fft=invz_topk.launches_fft, k3=idft.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        # The first mining launches against their plain versions, after
        # the counts were read.
        vs_plain = {}
        with torch.inference_mode():
            for name in ("mine_k1", "mine_k2"):
                if name in seen:
                    (err, rel), route, _ = (k1_check if name.endswith("k1")
                                            else k2_check)(seen[name])
                    vs_plain[name] = dict(route=route, max_abs_err=err,
                                          rel_err=rel,
                                          shape=list(seen[name][0].shape))
        del seen

        with open(os.path.join(ckpt, "config.json")) as f:
            cfg = DockConfig.from_json(f.read())
        trainer = Trainer(cfg, dev)
        state = trainer.restore(ckpt)
        mined = load_mined(os.path.join(ckpt, "mined.npz"))
        # Save -> restore, bit for bit.
        trainer.save(os.path.join(tmp, "copy"), state)
        back = trainer.restore(os.path.join(tmp, "copy"))
        roundtrip = (back.step == state.step
                     and back.opt_state["count"] == state.opt_state["count"]
                     and torch.equal(back.rng, state.rng)
                     and all(torch.equal(back.params[k], v)
                             for k, v in state.params.items())
                     and all(torch.equal(back.opt_state[p][k], v)
                             for p in ("mu", "nu")
                             for k, v in state.opt_state[p].items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    steps = [e for e in events if e["event"] == "train_step"]
    mines = [e for e in events if e["event"] == "mine"]
    vals = [e for e in events if e["event"] == "val"]
    complexes = synthetic_band(settings["seed0"], settings["n_train"],
                               widen=True, unbound=settings["unbound"])

    # 8 steps on one fixed batch with the run's mined negatives, from
    # the run's trained params and fresh moments (at the init, the shape
    # prior ranks most batches without a mined pose at zero loss).
    batch = make_training_batch(torch.Generator().manual_seed(0), complexes,
                                cfg, mined=mined, device=dev)
    st, overfit = trainer.init_state()._replace(params=state.params), []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(8):
        st, m = trainer.train_step(st, batch)
        overfit.append(float(m["loss"]))
    overfit_s = time.perf_counter() - t0
    del batch, st

    # One step on the card and on the CPU: the same host-built batch,
    # the run's trained params (every leaf has a gradient), TF32 off.
    one = cfg.replace(batch_complexes=1, num_decoys=8)
    b1 = make_training_batch(torch.Generator().manual_seed(1), complexes, one,
                             device="cpu")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for where in (dev, torch.device("cpu")):
            tr = Trainer(one, where)
            t0 = time.perf_counter()
            loss, acc, grads = tr.value_and_grad(
                {k: v.to(where) for k, v in state.params.items()},
                b1.to(where))
            out[where.type] = (loss.item(), acc.item(),
                               {k: v.cpu() for k, v in grads.items()},
                               time.perf_counter() - t0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (gl, ga, gg, gs), (wl, wa, wg, ws) = out[dev.type], out["cpu"]
    grad_rel = {k: float((gg[k] - w).abs().max() / w.abs().max())
                for k, w in wg.items()}

    return dict(
        config="pretrained/synthetic-v9p/config.json", steps=TRAIN_STEPS,
        settings={k: v for k, v in TRAIN_ENV.items()},
        grid=cfg.grid_size, lig_grid=cfg.lig_grid_size,
        decoys=cfg.num_decoys, batch_complexes=cfg.batch_complexes,
        wall_seconds=wall, launches=launches, kernels_vs_plain=vs_plain,
        losses=[e["loss"] for e in steps],
        accuracies=[e["ranking_accuracy"] for e in steps],
        step_seconds=[e["seconds"] for e in steps],
        step_seconds_median=statistics.median(
            e["seconds"] for e in steps[1:]),
        mining=[dict(step=e["step"], seconds=e["seconds"],
                     rotations=e["rotations"],
                     rotations_per_second=e["rotations"] / e["seconds"],
                     train_top24_hit=e["train_top24_hit"],
                     buffer=e["buffer"]) for e in mines],
        validation=[dict(step=e["step"], seconds=e["seconds"],
                         top1=e["top1"], top10=e["top10"],
                         best_lrmsd=e["best_lrmsd"]) for e in vals],
        peak_bytes=peak, allocated_before_bytes=mem0,
        train_peak_bytes=peak - mem0,
        overfit_losses=overfit, overfit_seconds=overfit_s,
        card_vs_cpu=dict(decoys=one.num_decoys, complexes=1, loss=[gl, wl],
                         accuracy=[ga, wa],
                         loss_rel_diff=abs(gl - wl) / abs(wl),
                         accuracy_abs_diff=abs(ga - wa),
                         grad_rel_err=grad_rel, card_seconds=gs,
                         cpu_seconds=ws, rtol=TRAIN_RTOL,
                         grad_tol=GRAD_TOL),
        checkpoint_roundtrip=roundtrip, restored_step=state.step)


def check_training(record):
    """Phase 9's gates, applied after its line is printed."""
    import math as _m
    r = record
    check(len(r["losses"]) == TRAIN_STEPS
          and all(_m.isfinite(v) for v in r["losses"] + r["accuracies"]),
          f"training: a loss or accuracy is not finite {r['losses']}")
    n = r["launches"]
    check(n["k1"] > 0 and n["k1_tf32"] == n["k1"],
          f"training: K1 not all on the tf32 kernel {n}")
    check(n["k2"] > 0 and n["k2_fft"] == n["k2"] and n["k3"] == 0,
          f"training: K2 not all FFT, or K3 ran {n}")
    p = r["kernels_vs_plain"]
    check(sorted(p) == ["mine_k1", "mine_k2"]
          and p["mine_k1"]["route"] == "tf32"
          and p["mine_k2"]["route"] == "fft"
          and all(e["rel_err"] <= TOL_F32 for e in p.values()),
          f"training: mining launches against plain {p}")
    check(len(r["mining"]) == 2 and len(r["validation"]) == 2,
          f"training: {len(r['mining'])} mining rounds, "
          f"{len(r['validation'])} validations")
    check(0 < r["overfit_losses"][-1] < r["overfit_losses"][0],
          f"training: 8 steps on one batch did not lower the loss "
          f"{r['overfit_losses']}")
    c = r["card_vs_cpu"]
    check(c["loss_rel_diff"] <= TRAIN_RTOL
          and c["accuracy_abs_diff"] <= TRAIN_RTOL
          and max(c["grad_rel_err"].values()) <= GRAD_TOL,
          f"training: card vs CPU {c}")
    check(r["checkpoint_roundtrip"] and r["restored_step"] == TRAIN_STEPS,
          "training: a checkpoint did not restore bit for bit")


# Phase 10: the CLI's commands; the full-depth requests keep the JAX
# bench's 13,000 rotations, the others run 2,048.
CLI_ROTATIONS = 2048
CLI_CMP_ROTATIONS = 256     # the CLI's card-vs-CPU dock
V9P_CHUNK = 16              # the v9p config's rotation_chunk
FULL_SWEEP_CHUNK = 128      # PRESETS["full-sweep"].rotation_chunk


def _write_mmcif(path, s):
    """``s`` as an mmCIF ``_atom_site`` loop (auth_* columns, model 1)."""
    cols = ("group_PDB", "id", "auth_atom_id", "auth_comp_id",
            "auth_asym_id", "auth_seq_id", "Cartn_x", "Cartn_y", "Cartn_z",
            "occupancy", "pdbx_PDB_model_num")
    with open(path, "w") as f:
        f.write("data_ligand\n#\nloop_\n"
                + "".join(f"_atom_site.{c}\n" for c in cols))
        for i, (x, y, z) in enumerate(s.coords):
            f.write(f"ATOM {i + 1} {s.atom_names[i]} {s.res_names[i]} "
                    f"{s.chain_ids[i]} {int(s.res_ids[i])} {x:.3f} {y:.3f} "
                    f"{z:.3f} 1.00 1\n")
        f.write("#\n")


def _write_two_models(path, pdb_path, dx=0.5):
    """A two-MODEL PDB: the file's ATOM records, then them moved by
    ``dx`` Angstrom along x."""
    with open(pdb_path) as f:
        atoms = [l for l in f if l.startswith("ATOM")]
    moved = [l[:30] + f"{float(l[30:38]) + dx:8.3f}" + l[38:] for l in atoms]
    with open(path, "w") as f:
        f.write("MODEL        1\n" + "".join(atoms) + "ENDMDL\n"
                "MODEL        2\n" + "".join(moved) + "ENDMDL\nEND\n")


def cli_commands(dev):
    """Phase 10: the port's CLI in process (``cli.main``) on ``dev``, each
    command with the launch counts set to 0 just before it and read just
    after, one JSON line per command.  Returns the phase's record."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from deeplocalproteindocking_torch import cli
    from deeplocalproteindocking_torch.correlate import (dft, fused, idft,
                                                         invz_topk)
    from deeplocalproteindocking_torch.structure.mmcif import (
        count_models, parse_structure)

    k1_launch, k2_launch = dft.fused_correlate, invz_topk.invz_blockmax
    k3_launch = idft.idft_bc
    seen, stage = {}, [None]

    def k1_spy(*args, **kw):
        seen.setdefault((stage[0], "k1"), args)
        return k1_launch(*args, **kw)

    def k2_spy(*args):
        seen.setdefault((stage[0], "k2"), args)
        return k2_launch(*args)

    def k3_spy(*args):
        seen.setdefault((stage[0], "k3"), args)
        return k3_launch(*args)

    commands = {}

    def h_groups(name):
        """Receptor groups of ``name``'s first K1 launch (1: one H)."""
        args = seen.get((name, "k1"))
        return None if args is None else (
            int(args[2].shape[0]) if args[2].dim() == 5 else 1)

    def run(name, argv):
        """One command: ``(record, captured stdout)``."""
        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0
        stage[0] = name
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        rec = dict(seconds=time.perf_counter() - t0, rc=rc, launches=dict(
            k1=fused.launches, k1_tc=fused.launches_tc,
            k1_tf32=fused.launches_tf32, k2=invz_topk.launches,
            k2_fft=invz_topk.launches_fft, k3=idft.launches,
            k3_fft=idft.launches_fft))
        commands[name] = rec
        return rec, out.getvalue()

    def poses(out):
        with open(os.path.join(out, "poses.json")) as f:
            table = json.load(f)
        check(len(table) > 0 and all(math.isfinite(p["score"])
                                     for p in table),
              f"{out}: no poses or a non-finite score")
        return table

    def on_route(name, k1=None, k2=None, k3=None):
        """Every launch of ``name`` on the stated route (None: none)."""
        n = commands[name]["launches"]
        want = {"k1": (n["k1_tf32"] if k1 == "tf32" else 0),
                "k2": (n["k2_fft"] if k2 == "fft" else 0),
                "k3": (n["k3_fft"] if k3 == "fft" else 0)}
        check(all(n[k] == want[k] for k in want)
              and all((n[k] > 0) == (r is not None)
                      for k, r in (("k1", k1), ("k2", k2), ("k3", k3))),
              f"cli {name}: launches {n}, expected K1 {k1}, K2 {k2}, "
              f"K3 {k3}")

    tmp = tempfile.mkdtemp(prefix="dlpd_cli_")
    data, ligs = os.path.join(tmp, "data"), os.path.join(tmp, "ligands")
    rec_pdb = os.path.join(data, "synth0_r_u.pdb")
    lig_pdb = os.path.join(data, "synth0_l_u.pdb")
    pair = ["--receptor", rec_pdb, "--ligand", lig_pdb]
    v9p = ["--checkpoint", V9P_DIR]
    record = {}
    # The CLI as a user runs it: under torch's TF32 defaults (cuDNN on,
    # matmul off), not the TF32-off of the earlier phases.
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    dft.fused_correlate, invz_topk.invz_blockmax = k1_spy, k2_spy
    idft.idft_bc = k3_spy
    try:
        # 1. Three polymer complexes; one ligand as mmCIF, one ligand as
        # two NMR models.
        run("generate_dataset", ["generate-dataset", "--out", data,
                                 "--num-complexes", "3", "--backbone",
                                 "--unbound-rmsd", "1.2"])
        os.makedirs(ligs)
        for i in (0, 1):
            shutil.copy(os.path.join(data, f"synth{i}_l_u.pdb"), ligs)
        cif = os.path.join(ligs, "synth2_l_u.cif")
        pdb2 = parse_structure(os.path.join(data, "synth2_l_u.pdb"))
        _write_mmcif(cif, pdb2)
        from_cif = parse_structure(cif)
        two = os.path.join(tmp, "two_models.pdb")
        _write_two_models(two, lig_pdb)
        files = dict(files=sorted(os.listdir(data)), mmcif_atoms=len(from_cif),
                     two_model_count=count_models(two))
        emit("cli_generate_dataset", **commands["generate_dataset"], **files)
        check(len(files["files"]) == 6 and files["two_model_count"] == 2
              and list(from_cif.atom_names) == list(pdb2.atom_names)
              and np.allclose(from_cif.coords, pdb2.coords, atol=1e-3),
              f"cli generate-dataset: files or mmCIF round trip {files}")

        # 2. The v9p checkpoint at its own config: 13,000 rotations, grid
        # 64, box 40, float32, chunk 16.  Cold, then warm.
        for tag in ("cold", "warm"):
            name = f"dock_v9p_{tag}"
            out = os.path.join(tmp, name)
            run(name, ["dock", "--out", out] + pair + v9p)
            top = poses(out)[0]
            r = commands[name]
            r.update(rotations=BENCH_ROTATIONS, top1_score=top["score"],
                     rotations_per_second=BENCH_ROTATIONS / r["seconds"])
            emit("cli_" + name, **r)
            on_route(name, k1="tf32", k2="fft")
            want = math.ceil(BENCH_ROTATIONS / V9P_CHUNK)
            check(r["launches"]["k1"] == want == r["launches"]["k2"],
                  f"cli {name}: {r['launches']}, expected {want} of each")
        # Card against CPU at 256 rotations, the card's run profiled.
        trace = os.path.join(tmp, "trace")
        cmp = {}
        for where in ("cuda", "cpu"):
            name = f"dock_v9p_{CLI_CMP_ROTATIONS}_{where}"
            out = os.path.join(tmp, name)
            extra = ["--profile", trace] if where == "cuda" else []
            run(name, ["dock", "--out", out, "--num-rotations",
                       str(CLI_CMP_ROTATIONS), "--device", where] + pair
                + v9p + extra)
            cmp[where] = poses(out)
        g = np.sort([p["score"] for p in cmp["cuda"]])
        w = np.sort([p["score"] for p in cmp["cpu"]])
        same_n = len(g) == len(w)
        traces = sorted(os.listdir(trace)) if os.path.isdir(trace) else []
        record["card_vs_cpu"] = dict(
            rotations=CLI_CMP_ROTATIONS, rtol=1e-3, poses=[len(g), len(w)],
            max_rel_diff=(float(np.max(np.abs(g - w) / np.abs(w)))
                          if same_n else None),
            top1_cuda=[cmp["cuda"][0]["rot_idx"]] + cmp["cuda"][0]["shift"],
            top1_cpu=[cmp["cpu"][0]["rot_idx"]] + cmp["cpu"][0]["shift"],
            cuda_seconds=commands[f"dock_v9p_{CLI_CMP_ROTATIONS}_cuda"][
                "seconds"],
            cpu_seconds=commands[f"dock_v9p_{CLI_CMP_ROTATIONS}_cpu"][
                "seconds"],
            profile_files=traces,
            profile_bytes=sum(os.path.getsize(os.path.join(trace, t))
                              for t in traces))
        emit("cli_dock_card_vs_cpu", **record["card_vs_cpu"])
        c = record["card_vs_cpu"]
        check(same_n and np.allclose(g, w, rtol=1e-3, atol=0)
              and c["top1_cuda"] == c["top1_cpu"],
              f"cli dock: card against CPU {c}")
        check(len(traces) == 1 and traces[0].endswith(".json")
              and c["profile_bytes"] > 0, f"cli --profile: {traces}")

        # 3. --preset full-sweep, no checkpoint: grid 128, 13,000
        # rotations, chunk 128, top-K 64, float32 (the JAX CLI docks
        # without a checkpoint on the shape channels: params None).
        for tag in ("cold", "warm"):
            name = f"dock_full_sweep_{tag}"
            out = os.path.join(tmp, name)
            run(name, ["dock", "--out", out, "--preset", "full-sweep"]
                + pair)
            top = poses(out)[0]
            r = commands[name]
            r.update(rotations=BENCH_ROTATIONS, top1_score=top["score"],
                     rotations_per_second=BENCH_ROTATIONS / r["seconds"])
            emit("cli_" + name, **r)
            on_route(name, k1="tf32", k2="fft")
            want = math.ceil(BENCH_ROTATIONS / FULL_SWEEP_CHUNK)
            check(r["launches"]["k1"] == want == r["launches"]["k2"],
                  f"cli {name}: {r['launches']}, expected {want} of each")

        # 4. Rescore and refine; an NMR ensemble of two ligand models.
        rot = ["--num-rotations", str(CLI_ROTATIONS)]
        out = os.path.join(tmp, "dock_rescore_refine")
        run("dock_rescore_refine", ["dock", "--out", out, "--rescore-top",
                                    "4", "--refine-steps", "5"]
            + pair + v9p + rot)
        commands["dock_rescore_refine"]["poses"] = len(poses(out))
        emit("cli_dock_rescore_refine", **commands["dock_rescore_refine"])
        on_route("dock_rescore_refine", k1="tf32", k2="fft")
        out = os.path.join(tmp, "dock_ensemble")
        run("dock_ensemble", ["dock", "--out", out, "--receptor", rec_pdb,
                              "--ligand", two, "--ensemble", "product",
                              "--max-models", "2"] + v9p + rot)
        table = poses(out)
        commands["dock_ensemble"].update(
            poses=len(table),
            ligand_models=sorted({p["ligand_model"] for p in table}),
            h_groups=h_groups("dock_ensemble"))
        emit("cli_dock_ensemble", **commands["dock_ensemble"])
        on_route("dock_ensemble", k1="tf32", k2="fft")
        check(commands["dock_ensemble"]["ligand_models"] in ([1], [2], [1, 2])
              and commands["dock_ensemble"]["h_groups"] == 2,
              f"cli ensemble: {commands['dock_ensemble']}")

        # 5. Screening on dft_pallas: one receptor, three ligands (one
        # mmCIF), each docked then rescored through the service's cache.
        out = os.path.join(tmp, "screen")
        run("screen", ["screen", "--receptor", rec_pdb, "--ligands", ligs,
                       "--out", out, "--fft-impl", "dft_pallas",
                       "--rescore-top", "4"] + v9p + rot)
        with open(os.path.join(out, "screen.json")) as f:
            scr = json.load(f)
        commands["screen"].update(
            cache=scr["cache"], ranking=[r["ligand"] for r in scr["ranking"]],
            best_scores=[r["best_score"] for r in scr["ranking"]])
        emit("cli_screen", **commands["screen"])
        on_route("screen", k3="fft")
        check(scr["cache"]["misses"] == 1 and scr["cache"]["hits"] == 2 + 3
              and sorted(commands["screen"]["ranking"]) == [
                  "synth0_l_u", "synth1_l_u", "synth2_l_u"]
              and all(math.isfinite(v)
                      for v in commands["screen"]["best_scores"]),
              f"cli screen: {commands['screen']}")

        # 6. Batched evaluation of the generated directory.
        out = os.path.join(tmp, "evaluate")
        _, text = run("evaluate", ["evaluate", "--data-dir", data, "--out",
                                   out, "--batch-size", "3"] + v9p + rot)
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
        commands["evaluate"].update(summary=summary,
                                    h_groups=h_groups("evaluate"))
        emit("cli_evaluate", **commands["evaluate"])
        on_route("evaluate", k1="tf32", k2="fft")
        check(summary["num_complexes"] == 3
              and commands["evaluate"]["h_groups"] == 3,
              f"cli evaluate: {commands['evaluate']}")

        # 7. Train, stop, resume; then dock with the run's state.pt.
        ck = os.path.join(tmp, "run")
        train = ["train", "--synthetic", "2", "--ckpt-dir", ck,
                 "--ckpt-every", "2", "--grid-size", "64", "--mine-every",
                 "2", "--mine-rotations", "64"]
        run("train", train + ["--steps", "4"])
        run("train_resume", train + ["--steps", "6", "--resume"])
        with open(os.path.join(ck, "train.jsonl")) as f:
            events = [json.loads(l) for l in f]
        losses = [e["loss"] for e in events if e["event"] == "train_step"]
        for name in ("train", "train_resume"):
            emit("cli_" + name, **commands[name])
            on_route(name, k1="tf32", k2="fft")
        out = os.path.join(tmp, "dock_trained")
        run("dock_trained", ["dock", "--out", out, "--checkpoint", ck,
                             "--num-rotations", str(CLI_CMP_ROTATIONS)]
            + pair)
        commands["dock_trained"]["poses"] = len(poses(out))
        commands["train_resume"].update(
            losses=losses, steps=[e["step"] for e in events
                                  if e["event"] == "train_step"],
            checkpoints=sorted(d for d in os.listdir(ck)
                               if d.startswith("step_")))
        emit("cli_dock_trained", **commands["dock_trained"])
        check(commands["train_resume"]["steps"] == list(range(6))
              and all(math.isfinite(v) for v in losses)
              and commands["train_resume"]["checkpoints"][-1]
              == "step_00000006", f"cli train: {commands['train_resume']}")
        on_route("dock_trained", k1="tf32", k2="fft")

        # 8. Doctor on the v9p checkpoint.
        _, text = run("doctor", ["doctor"] + v9p)
        rep = json.loads(text.strip().splitlines()[-1])
        commands["doctor"].update(doctor_ok=rep["doctor_ok"],
                                  device0=rep["backend"].get("device0"),
                                  routes=rep["routes"], tf32=rep["tf32"],
                                  native=[rep["pdb_native"]["ok"],
                                          rep["cif_native"]["ok"]],
                                  license=rep.get("license"))
        emit("cli_doctor", **commands["doctor"])
        d = commands["doctor"]
        check(d["rc"] == 0 and d["doctor_ok"]
              and d["device0"] == torch.cuda.get_device_name(0)
              and (d["routes"]["k1"], d["routes"]["k2"]) == ("tf32", "fft")
              and d["routes"]["k3"].startswith("fft"),
              f"cli doctor: {d}")
    finally:
        dft.fused_correlate, invz_topk.invz_blockmax = k1_launch, k2_launch
        idft.idft_bc = k3_launch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        shutil.rmtree(tmp, ignore_errors=True)

    # The first K1 and K2 launch of the full-depth v9p request and the
    # first K3 launch of the screen, against their plain versions.
    firsts = [("dock_v9p_cold", "k1"), ("dock_v9p_cold", "k2"),
              ("screen", "k3")]
    check(all(k in seen for k in firsts), f"cli: launches not seen {seen}")
    if not all(k in seen for k in firsts):    # reached only in a rehearsal
        return dict(record, commands=commands)
    k1_err, k1_route, _ = k1_check(seen[("dock_v9p_cold", "k1")])
    k2_err, k2_route, _ = k2_check(seen[("dock_v9p_cold", "k2")])
    k3_args = seen[("screen", "k3")]
    f0 = idft.launches_fft
    got = idft.idft_bc(*k3_args)
    torch.cuda.synchronize(dev)
    k3_err = rel_err(got, idft.idft_bc_reference(*k3_args))
    record["kernels_vs_plain"] = {
        "dock_v9p_k1": dict(route=k1_route, max_abs_err=k1_err[0],
                            rel_err=k1_err[1]),
        "dock_v9p_k2": dict(route=k2_route, max_abs_err=k2_err[0],
                            rel_err=k2_err[1]),
        "screen_k3": dict(route="fft" if idft.launches_fft > f0 else "none",
                          max_abs_err=k3_err[0], rel_err=k3_err[1])}
    check(all(e["rel_err"] <= TOL_F32
              for e in record["kernels_vs_plain"].values())
          and (k1_route, k2_route) == ("tf32", "fft")
          and record["kernels_vs_plain"]["screen_k3"]["route"] == "fft",
          f"cli: first launches against plain {record['kernels_vs_plain']}")
    record["commands"] = commands
    record["launches"] = {k: sum(c["launches"][k] for c in commands.values())
                          for k in ("k1", "k1_tc", "k1_tf32", "k2", "k2_fft",
                                    "k3", "k3_fft")}
    return record


# Phase 11: grids above 128^3 (the overlap-save block engine) and the
# resample sweep; rotation counts cut from the JAX bench's 13,000.
P11_ROTATIONS = 256         # block requests and card-vs-CPU requests
P11_RESAMPLE_ROTATIONS = 2048
P11_RTOL = 1e-3             # top-K values, float32, card vs CPU / engines
P11_BF16_RTOL = 2e-2        # approx against exact top-K (bf16, as phase 4)
GOLDEN_PATH = os.path.join(ROOT, "tests", "golden_sweep.json")


def large_grids_and_resample(dev, params):
    """Phase 11: the block engine (grid 128 against the kernel path,
    ``measure_256`` at 192 and 256, v9p at 256, card against CPU) and the
    resample sweep (the golden snapshot, v9p and full-sweep requests,
    card against CPU, an ensemble), ``topk_impl="approx"``, one train
    step under each mode card against CPU, and two CLI docks; each
    request with the launch counts set to 0 just before it and read just
    after, one JSON line per step.  Returns the phase's record."""
    import contextlib
    import io
    import itertools
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch
    from deeplocalproteindocking_torch import cli, measure_256, weights
    from deeplocalproteindocking_torch.config import DockConfig, PRESETS
    from deeplocalproteindocking_torch.correlate import fused, idft, invz_topk
    from deeplocalproteindocking_torch.correlate.fft import resolve_engine
    from deeplocalproteindocking_torch.data import synthetic_complex
    from deeplocalproteindocking_torch.data.benchmark import synthetic_band
    from deeplocalproteindocking_torch.pipeline import DockingPipeline, PoseSet
    from deeplocalproteindocking_torch.structure.pdb import write_pdb
    from deeplocalproteindocking_torch.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_torch.sweep.resplat import (
        APPROX_TOPK_WARNING)
    from deeplocalproteindocking_torch.train import Trainer
    from deeplocalproteindocking_torch.train.data_gen import (
        make_training_batch)

    def reset():
        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0

    def counts():
        return dict(k1=fused.launches, k1_tc=fused.launches_tc,
                    k1_tf32=fused.launches_tf32, k2=invz_topk.launches,
                    k2_fft=invz_topk.launches_fft, k3=idft.launches,
                    k3_fft=idft.launches_fft)

    def request(fn, where=dev):
        """``(result, seconds, launches)`` of one request."""
        reset()
        if where.type == "cuda":
            torch.cuda.synchronize(where)
        t0 = time.perf_counter()
        out = fn()
        if where.type == "cuda":
            torch.cuda.synchronize(where)
        return out, time.perf_counter() - t0, counts()

    def max_rel(a, b):
        a, b = np.sort(np.asarray(a)), np.sort(np.asarray(b))
        return float(np.max(np.abs(a - b) / np.abs(b)))

    def top1(p):
        return [int(p.rot_idx[0])] + [int(v) for v in p.shifts[0]]

    def no_kernels(n):
        return n["k1"] == n["k2"] == n["k3"] == 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(V9P_DIR, "config.json")) as f:
        v9p = DockConfig.from_json(f.read())
    cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
    record, phase_launches = {}, []
    cpu = torch.device("cpu")

    # 1. Block against the kernel path at grid 128 (v9p, float32, full
    # rank): the block engine launches no kernel, dft_fused 16 tf32 K1
    # and 16 FFT K2 (256 rotations, chunk 16).
    cfg128 = v9p.replace(grid_size=128, num_rotations=P11_ROTATIONS)
    out = {}
    for impl in ("block", "dft_fused"):
        p = DockingPipeline(cfg128.replace(fft_impl=impl, fft_block=32),
                            params=params, device=dev)
        p.dock_complex(cplx, cluster=False)                   # warm-up
        out[impl] = request(lambda: p.dock_complex(cplx, cluster=False))
    (bp, bs, bn), (fp, fs, fn_) = out["block"], out["dft_fused"]
    phase_launches.append(bn)
    step = dict(grid=128, lig_grid=cfg128.lig_grid_size, fft_block=32,
                rotations=P11_ROTATIONS, reduced="rotations 13,000 -> 256",
                dtype="float32", channels=16, block_seconds=bs,
                dft_fused_seconds=fs, launches_block=bn,
                launches_dft_fused=fn_,
                max_rel_diff=max_rel(bp.scores, fp.scores),
                top1_block=top1(bp), top1_dft_fused=top1(fp))
    emit("p11_block_vs_kernels", **step)
    record["block_vs_kernels"] = step

    # 2. Large grids: measure_256's protocol, then v9p at 256 through the
    # default engine (dft_fused resolves to block above 128).
    reset()
    rows = measure_256.measure(64, (192, 256), dev)
    n = counts()
    phase_launches.append(n)
    for r in rows:
        L = r["grid"]
        r["rotations_per_second"] = r["n_rot"] / r["warm_s"]
        r["chunk_spectra_mb"] = r["chunk"] * L * L * (L // 2 + 1) * 2 * 8 \
            / 2 ** 20
    step = dict(rows=rows, launches=n, channels=2,
                reduced="rotations 13,000 -> 64 (measure_256's default)")
    emit("p11_measure_256", **step)
    record["measure_256"] = step
    c256 = v9p.replace(grid_size=256, num_rotations=P11_ROTATIONS,
                       fft_block=64)
    engine = resolve_engine(c256.fft_impl, 256)
    p = DockingPipeline(c256, params=params, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cold = request(lambda: p.dock_complex(cplx))
    warm = request(lambda: p.dock_complex(cplx))
    phase_launches += [cold[2], warm[2]]
    step = dict(grid=256, config_fft_impl=c256.fft_impl, engine=engine,
                fft_block=64, lig_grid=c256.lig_grid_size, channels=16,
                dtype="float32", rotations=P11_ROTATIONS,
                reduced="rotations 13,000 -> 256", chunk=c256.rotation_chunk,
                cold_seconds=cold[1], warm_seconds=warm[1],
                rotations_per_second=P11_ROTATIONS / warm[1],
                ms_per_rotation=warm[1] / P11_ROTATIONS * 1e3,
                peak_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                chunk_spectra_mb=c256.rotation_chunk * 256 * 256 * 129 * 16
                * 8 / 2 ** 20,
                launches=[cold[2], warm[2]], top_score=float(warm[0].scores[0]),
                poses=len(warm[0]))
    emit("p11_v9p_grid256", **step)
    record["v9p_grid256"] = step
    del p

    # 3. Card against CPU under block: dock -> rescore -> refine.
    cfg64 = v9p.replace(fft_impl="block", num_rotations=P11_ROTATIONS)
    out = {}
    for where in (dev, cpu):
        p = DockingPipeline(cfg64, params=params, device=where)

        def path():
            d = p.dock_complex(cplx, cluster=False)
            r = p.rescore(cplx.receptor, cplx.ligand, d, top=4, nrot=16)
            f = p.refine(cplx.receptor, cplx.ligand,
                         PoseSet(*(x[:4] for x in r[:5])), steps=5)
            return d, r, f
        out[where.type] = request(path, where)
    (gd, gr, gf), gs, gn = out[dev.type]
    (wd, wr, wf), ws, _ = out["cpu"]
    phase_launches.append(gn)
    step = dict(grid=64, fft_block=32, rotations=P11_ROTATIONS,
                reduced="rotations 13,000 -> 256", dtype="float32",
                cuda_seconds=gs, cpu_seconds=ws, launches=gn,
                dock_max_rel_diff=max_rel(gd.scores, wd.scores),
                rescore_max_rel_diff=max_rel(gr.scores, wr.scores),
                refine_max_rel_diff=max_rel(gf.scores, wf.scores),
                top1_cuda=top1(gd), top1_cpu=top1(wd),
                rescored_top1_same=bool(
                    np.allclose(gr.rotations[0], wr.rotations[0], atol=1e-5)
                    and list(gr.shifts[0]) == list(wr.shifts[0])))
    emit("p11_block_card_vs_cpu", **step)
    record["block_card_vs_cpu"] = step

    # 4. Resample: the golden snapshot, two requests, card against CPU,
    # an ensemble.
    gcfg = DockConfig(grid_size=32, resolution=1.5, num_rotations=12,
                      rotation_chunk=4, top_k=8, rep_features=(8,),
                      sweep_mode="resample")
    gp = DockingPipeline(gcfg, device=dev)
    got, _, n = request(lambda: gp.dock_complex(
        synthetic_complex(seed=42, n_res_rec=10, n_res_lig=5),
        rotations=super_fibonacci_rotations(12, dev), cluster=False))
    phase_launches.append(n)
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    scores = [round(float(s), 3) for s in got.scores]
    golden = dict(
        rot_idx_equal=[int(v) for v in got.rot_idx] == want["rot_idx"],
        shifts_equal=[[int(v) for v in s] for s in got.shifts]
        == want["shifts"],
        scores_within=bool(np.allclose(scores, want["scores"], rtol=1e-3,
                                       atol=2e-3)),
        max_abs_score_diff=float(np.max(np.abs(np.subtract(
            scores, want["scores"])))), launches=n)
    requests = {}
    for name, cfg, prm in (
            ("v9p", v9p.replace(sweep_mode="resample",
                                num_rotations=P11_RESAMPLE_ROTATIONS),
             params),
            ("full_sweep", PRESETS["full-sweep"].replace(
                sweep_mode="resample", num_rotations=P11_RESAMPLE_ROTATIONS),
             None)):
        p = DockingPipeline(cfg, params=prm, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # A cold request of 256 rotations, then the timed warm one.
        cold = request(lambda: p.dock_complex(
            cplx, rotations=p.rotation_set()[:P11_ROTATIONS]))
        warm = request(lambda: p.dock_complex(cplx))
        phase_launches += [cold[2], warm[2]]
        requests[name] = dict(
            grid=cfg.grid_size, chunk=cfg.rotation_chunk,
            channels=16 if prm is not None else 2,
            rotations=P11_RESAMPLE_ROTATIONS,
            reduced="rotations 13,000 -> 2,048",
            cold_rotations=P11_ROTATIONS, cold_seconds=cold[1],
            warm_seconds=warm[1],
            rotations_per_second=P11_RESAMPLE_ROTATIONS / warm[1],
            peak_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
            launches=[cold[2], warm[2]], top_score=float(warm[0].scores[0]))
        del p
    rcfg = v9p.replace(sweep_mode="resample", num_rotations=P11_ROTATIONS)
    out = {}
    for where in (dev, cpu):
        p = DockingPipeline(rcfg, params=params, device=where)
        out[where.type] = request(
            lambda: p.dock_complex(cplx, cluster=False), where)
    (gd, gs, gn), (wd, ws, _) = out[dev.type], out["cpu"]
    phase_launches.append(gn)
    vs_cpu = dict(grid=64, rotations=P11_ROTATIONS, cuda_seconds=gs,
                  cpu_seconds=ws, launches=gn,
                  max_rel_diff=max_rel(gd.scores, wd.scores),
                  top1_cuda=top1(gd), top1_cpu=top1(wd))
    ub = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30,
                           unbound_rmsd=1.2)
    recs, ligs = [cplx.receptor, ub.receptor], [cplx.ligand, ub.ligand]
    p = DockingPipeline(rcfg, params=params, device=dev)
    (merged, pairs), es, en = request(
        lambda: p.dock_ensemble(recs, ligs, cluster=False))
    phase_launches.append(en)
    singles, tags = [], []
    for ri, li in itertools.product(range(2), range(2)):
        s = p.dock(recs[ri], ligs[li], cluster=False)
        singles.append(s.scores)
        tags += [(ri, li)] * len(s)
    single = np.concatenate(singles)
    ensemble = dict(pairs=4, rotations=P11_ROTATIONS, seconds=es,
                    launches=en, poses=len(merged),
                    max_rel_diff_vs_single_docks=max_rel(merged.scores,
                                                         single),
                    top1_pair=[int(v) for v in pairs[0]],
                    top1_pair_single=list(tags[int(np.argmax(single))]))
    step = dict(golden=golden, requests=requests, card_vs_cpu=vs_cpu,
                ensemble=ensemble)
    emit("p11_resample", **step)
    record["resample"] = step

    # 5. topk_impl="approx" on the bench config (grid 128, bf16, rank 3):
    # K1, then the score-volume top-K, no K2.
    bench = DockConfig(
        grid_size=128, resolution=1.25, rep_features=(32, 14),
        shape_prior=True, compute_dtype="bfloat16", dft_dtype="bfloat16",
        coupling_rank=3, top_k=64, rotation_chunk=128,
        num_rotations=P11_RESAMPLE_ROTATIONS, fft_impl="dft_fused")
    out = {}
    for impl in ("exact", "approx"):
        p = DockingPipeline(bench.replace(topk_impl=impl), params=params,
                            device=dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p.dock_complex(cplx, cluster=False)               # warm-up
            out[impl] = request(lambda: p.dock_complex(cplx, cluster=False))
        out[impl] += (APPROX_TOPK_WARNING in [str(w.message)
                                              for w in caught],)
    (ep, es_, en_, _), (ap, as_, an, warned) = out["exact"], out["approx"]
    step = dict(grid=128, dtype="bfloat16", rotations=P11_RESAMPLE_ROTATIONS,
                reduced="rotations 13,000 -> 2,048", exact_seconds=es_,
                approx_seconds=as_, launches_exact=en_, launches_approx=an,
                warned=warned, max_rel_diff=max_rel(ap.scores, ep.scores),
                top1_exact=top1(ep), top1_approx=top1(ap))
    emit("p11_topk_approx", **step)
    record["topk_approx"] = step

    # 6. One train step (v9p config, grid 64, 1 complex x 8 decoys, the
    # checkpoint's trained params) on the card and on the CPU under each
    # mode.
    complexes = synthetic_band(200, 1, widen=True, unbound=1.2)
    trained = weights.load_npz(os.path.join(V9P_DIR, "best_params.npz"))
    steps = {}
    for name, mode in (("resample", dict(sweep_mode="resample")),
                       ("block", dict(fft_impl="block"))):
        one = v9p.replace(batch_complexes=1, num_decoys=8, **mode)
        b1 = make_training_batch(torch.Generator().manual_seed(1), complexes,
                                 one, device="cpu")
        res = {}
        for where in (dev, cpu):
            tr = Trainer(one, where)
            (loss, acc, grads), secs, n = request(
                lambda: tr.value_and_grad(
                    {k: v.to(where) for k, v in trained.items()},
                    b1.to(where)), where)
            res[where.type] = (loss.item(), acc.item(),
                               {k: v.cpu() for k, v in grads.items()}, secs,
                               n)
        (gl, ga, gg, gs, gn), (wl, wa, wg, ws, _) = res[dev.type], res["cpu"]
        phase_launches.append(gn)
        steps[name] = dict(
            loss=[gl, wl], accuracy=[ga, wa],
            loss_rel_diff=abs(gl - wl) / abs(wl),
            accuracy_abs_diff=abs(ga - wa),
            grad_rel_err={k: float((gg[k] - w).abs().max() / w.abs().max())
                          for k, w in wg.items()},
            card_seconds=gs, cpu_seconds=ws, launches=gn)
    step = dict(config="pretrained/synthetic-v9p/config.json", grid=64,
                complexes=1, decoys=8, rtol=TRAIN_RTOL, grad_tol=GRAD_TOL,
                **steps)
    emit("p11_train_step", **step)
    record["train_step"] = step

    # 7. The CLI in process: a v9p dock at grid 192 (the engine resolves
    # to block, the geometry warning prints) and one in resample mode.
    tmp = tempfile.mkdtemp(prefix="dlpd_p11_")
    try:
        rec_pdb, lig_pdb = (os.path.join(tmp, n) for n in ("r.pdb", "l.pdb"))
        write_pdb(rec_pdb, cplx.receptor)
        write_pdb(lig_pdb, cplx.ligand)
        base = ["dock", "--receptor", rec_pdb, "--ligand", lig_pdb,
                "--checkpoint", V9P_DIR, "--num-rotations",
                str(P11_ROTATIONS)]
        clis = {}
        for name, extra in (("grid192", ["--grid-size", "192"]),
                            ("resample", ["--sweep-mode", "resample"])):
            out_dir = os.path.join(tmp, name)
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                rc, secs, n = request(lambda: cli.main(
                    base + extra + ["--out", out_dir]))
            phase_launches.append(n)
            with open(os.path.join(out_dir, "poses.json")) as f:
                table = json.load(f)
            clis[name] = dict(
                rc=rc, seconds=secs, launches=n, poses=len(table),
                scores_finite=all(math.isfinite(q["score"]) for q in table),
                geometry_warning="differs from the checkpoint" in
                err.getvalue(), top_score=table[0]["score"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("p11_cli", rotations=P11_ROTATIONS,
         reduced="rotations 13,000 -> 256", **clis)
    record["cli"] = clis
    record["launches"] = {k: sum(n[k] for n in phase_launches)
                          for k in phase_launches[0]}
    return record


def check_large_grids(record):
    """Phase 11's gates, applied after its lines are printed."""
    r = record
    b = r["block_vs_kernels"]
    check(b["max_rel_diff"] <= P11_RTOL
          and b["top1_block"] == b["top1_dft_fused"],
          f"block against dft_fused at grid 128: {b}")
    n = b["launches_dft_fused"]
    check(n["k1"] == n["k1_tf32"] == 16 and n["k2"] == n["k2_fft"] == 16
          and n["k3"] == 0, f"dft_fused at grid 128: launches {n}")
    check(r["launches"]["k1"] == r["launches"]["k2"]
          == r["launches"]["k3"] == 0,
          f"phase 11: a block or resample request launched a kernel "
          f"{r['launches']}")
    for row in r["measure_256"]["rows"]:
        check(math.isfinite(row["top_score"]) and row["peak_mb"] > 0,
              f"measure_256: {row}")
    g = r["v9p_grid256"]
    check(g["engine"] == "block" and g["poses"] > 0
          and math.isfinite(g["top_score"]), f"v9p at grid 256: {g}")
    c = r["block_card_vs_cpu"]
    check(c["dock_max_rel_diff"] <= P11_RTOL
          and c["rescore_max_rel_diff"] <= P11_RTOL
          and c["refine_max_rel_diff"] <= P11_RTOL
          and c["top1_cuda"] == c["top1_cpu"] and c["rescored_top1_same"],
          f"block card vs CPU: {c}")
    s = r["resample"]
    check(s["golden"]["rot_idx_equal"] and s["golden"]["shifts_equal"]
          and s["golden"]["scores_within"],
          f"resample: the golden snapshot differs {s['golden']}")
    check(s["card_vs_cpu"]["max_rel_diff"] <= P11_RTOL
          and s["card_vs_cpu"]["top1_cuda"] == s["card_vs_cpu"]["top1_cpu"],
          f"resample card vs CPU: {s['card_vs_cpu']}")
    e = s["ensemble"]
    check(e["max_rel_diff_vs_single_docks"] <= BATCH_RTOL
          and e["top1_pair"] == e["top1_pair_single"],
          f"resample ensemble against four single docks: {e}")
    for name, q in s["requests"].items():
        check(math.isfinite(q["top_score"]), f"resample {name}: {q}")
    a = r["topk_approx"]
    check(a["warned"] and a["max_rel_diff"] <= P11_BF16_RTOL
          and a["top1_exact"] == a["top1_approx"],
          f"topk_impl='approx': {a}")
    check(a["launches_approx"]["k1"] > 0 and a["launches_approx"]["k2"] == 0
          and a["launches_exact"]["k2_fft"] > 0,
          f"approx runs K1 without K2: {a['launches_approx']}")
    for name in ("resample", "block"):
        t = r["train_step"][name]
        check(t["loss_rel_diff"] <= TRAIN_RTOL
              and t["accuracy_abs_diff"] <= TRAIN_RTOL
              and max(t["grad_rel_err"].values()) <= GRAD_TOL,
              f"train step under {name}, card vs CPU: {t}")
    for name, q in r["cli"].items():
        check(q["rc"] in (0, None) and q["poses"] > 0 and q["scores_finite"],
              f"cli dock {name}: {q}")
    check(r["cli"]["grid192"]["geometry_warning"],
          "cli dock at grid 192: no geometry warning")


# Phase 12: the multi-GPU layer.  Ranks are processes spawned here, one
# per card, at least two; ranks that share a card talk over gloo (NCCL
# refuses two ranks on one card), ranks with a card each over NCCL.
P12_ROTATIONS = 2048         # the sharded docks, as phase 3's requests
P12_BATCH_ROTATIONS = 256    # dock_batch over (rot, batch)
P12_RTOL = 1e-3              # top-K values against the single-card dock
P12_BLOCK_L, P12_BLOCK = 128, 32
P12_TRAIN_SEED = 2           # the train batch's generator seed
P12_TIMEOUT_S = 600          # a rank that outlives this is killed


def _p12_configs():
    """The sharded docks' configs: the bf16 bench config (phase 3's) and
    the v9p checkpoint's own ``config.json`` (float32), each at
    ``P12_ROTATIONS``."""
    from deeplocalproteindocking_torch.config import DockConfig
    with open(os.path.join(V9P_DIR, "config.json")) as f:
        v9p = DockConfig.from_json(f.read())
    bench = DockConfig(
        grid_size=128, resolution=1.25, rep_features=(32, 14),
        shape_prior=True, compute_dtype="bfloat16", dft_dtype="bfloat16",
        coupling_rank=3, top_k=64, rotation_chunk=128,
        num_rotations=P12_ROTATIONS, fft_impl="dft_fused",
        sweep_mode="resplat")
    return {"bench_bf16": bench,
            "v9p_config": v9p.replace(num_rotations=P12_ROTATIONS)}


def _p12_full_depth():
    """The 13,000-rotation CLI docks of ``--multi-gpu``: ``(name, argv
    after the ligand pair)``."""
    return [("benchmark_v5e8", ["--preset", "benchmark-v5e8"]),
            ("v9p", ["--checkpoint", V9P_DIR])]


def _cli_dock_split(argv):
    """One ``cli.main(argv)`` with its stages timed on the host's clock,
    each from a synchronisation of this process's card to the next:
    ``mesh`` (``cli._mesh``: joining the group, building the
    ``DeviceMesh``), ``pipeline`` (``cli._build_pipeline``: the weights
    and the model), ``dock`` (``DockingPipeline.dock``) and ``sweep``
    (the sweep inside it, sharded or not), ``write``
    (``cli._write_poses``, rank 0 only) and ``cli`` (the whole call).
    ``{stage: seconds}``."""
    import contextlib
    import io

    import torch
    from deeplocalproteindocking_torch import cli, pipeline
    split = {}

    def stage(name, fn):
        def timed_fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                split[name] = (split.get(name, 0.0)
                               + time.perf_counter() - t0)
        return timed_fn

    stages = [(cli, "_mesh", "mesh"), (cli, "_build_pipeline", "pipeline"),
              (cli, "_write_poses", "write"),
              (pipeline.DockingPipeline, "dock", "dock")] + [
        (pipeline, f, "sweep") for f in (
            "sharded_dock_sweep_resplat", "dock_sweep_resplat",
            "sharded_dock_sweep", "dock_sweep")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for obj, attr, name in stages:
        setattr(obj, attr, stage(name, getattr(obj, attr)))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            stage("cli", cli.main)(argv)
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return split


def _p12_rank(rank, world, tmp, full_depth):
    """One rank of phase 12: every check of the phase on this rank's
    card; the record is saved to ``tmp/rank<r>.pt`` (a traceback to
    ``tmp/rank<r>.err``)."""
    import contextlib
    import hashlib
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from deeplocalproteindocking_torch import _build, cli, weights
    from deeplocalproteindocking_torch.correlate import (dft, fused, idft,
                                                         invz_topk)
    from deeplocalproteindocking_torch.correlate.blockfft import (
        block_correlate_scores, sharded_block_correlate)
    from deeplocalproteindocking_torch.data import synthetic_complex
    from deeplocalproteindocking_torch.data.benchmark import synthetic_band
    from deeplocalproteindocking_torch.evaluation import batch_inputs
    from deeplocalproteindocking_torch.parallel import mesh as pmesh
    from deeplocalproteindocking_torch.parallel.batch_eval import dock_batch
    from deeplocalproteindocking_torch.parallel.collectives import (
        all_gather_rows)
    from deeplocalproteindocking_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    from deeplocalproteindocking_torch.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_torch.sweep.resplat import (
        dock_sweep_resplat)
    from deeplocalproteindocking_torch.train import Trainer
    from deeplocalproteindocking_torch.train.data_gen import (
        make_training_batch)

    log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
    try:
        with contextlib.redirect_stdout(log):
            t_start = time.perf_counter()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            dev = pmesh.init_distributed(
                "cuda", rank=rank, world_size=world,
                init_method="file://" + os.path.join(tmp, "store"))
            _build.library()
            mesh = pmesh.make_mesh(rot=world, device_type="cuda")
            params = weights.load_npz(os.path.join(V9P_DIR,
                                                   "best_params.npz"))
            cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
            rec = dict(rank=rank, device=str(dev),
                       card=torch.cuda.get_device_name(dev),
                       backend=dist.get_backend())

            def reset():
                fused.launches = fused.launches_tc = fused.launches_tf32 = 0
                invz_topk.launches = invz_topk.launches_fft = 0
                idft.launches = idft.launches_fft = 0

            def counts():
                return dict(k1=fused.launches, k1_tc=fused.launches_tc,
                            k1_tf32=fused.launches_tf32,
                            k2=invz_topk.launches,
                            k2_fft=invz_topk.launches_fft, k3=idft.launches,
                            k3_fft=idft.launches_fft)

            def timed(fn):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize(dev)
                dist.barrier()
                return out, time.perf_counter() - t0

            # 1. The sharded docks of both configs, counts set to 0 just
            # before and read just after; spies keep each config's first
            # K1 and K2 launch.
            k1_launch, k2_launch = dft.fused_correlate, invz_topk.invz_blockmax
            seen, stage = {}, [None]

            def k1_spy(*args, **kw):
                seen.setdefault((stage[0], "k1"), args)
                return k1_launch(*args, **kw)

            def k2_spy(*args):
                seen.setdefault((stage[0], "k2"), args)
                return k2_launch(*args)

            docks = {}
            dft.fused_correlate, invz_topk.invz_blockmax = k1_spy, k2_spy
            try:
                for name, cfg in _p12_configs().items():
                    pipe = DockingPipeline(cfg, params=params, device=dev,
                                           mesh=mesh)
                    stage[0] = name
                    reset()
                    poses, secs = timed(
                        lambda: pipe.dock_complex(cplx, cluster=False))
                    docks[name] = dict(
                        seconds=secs, launches=counts(),
                        scores=poses.scores.tolist(),
                        top1=[int(poses.rot_idx[0])]
                        + [int(v) for v in poses.shifts[0]])
            finally:
                dft.fused_correlate, invz_topk.invz_blockmax = (k1_launch,
                                                                k2_launch)
            vs_plain = {}
            with torch.inference_mode():
                for (name, k), args in sorted(seen.items()):
                    (err, rel), route, _ = (k1_check if k == "k1"
                                            else k2_check)(args)
                    vs_plain[f"{name}_{k}"] = dict(
                        route=route, shape=list(args[0].shape),
                        max_abs_err=err, rel_err=rel)
            del seen
            rec.update(docks=docks, kernels_vs_plain=vs_plain)

            # 2. dock_batch of `world` complexes over (1, world) and
            # (world, 1), each row against its own sweep on this card.
            bench = _p12_configs()["bench_bf16"].replace(
                num_rotations=P12_BATCH_ROTATIONS)
            pipe = DockingPipeline(bench, params=params, device=dev)
            group = [synthetic_complex(seed=s, n_res_rec=60, n_res_lig=30)
                     for s in range(world)]
            rots = super_fibonacci_rotations(P12_BATCH_ROTATIONS, dev)
            args, kw = batch_inputs(pipe, group, rots)
            masks = kw["score_mask"]
            singles = [dock_sweep_resplat(
                args[0][b], args[1][b], args[2][b], args[3][b], rots,
                args[5], **dict(kw, score_mask=None if masks is None
                                else masks[b]))
                for b in range(world)]
            batched = {}
            for shape in ((1, world), (world, 1)):
                res, secs = timed(lambda: dock_batch(
                    *args, **kw, mesh=pmesh.make_mesh(*shape, "cuda")))
                rel = [float(np.max(np.abs(
                    np.sort(res.scores[b].cpu().numpy())
                    - np.sort(s.scores.cpu().numpy()))
                    / np.abs(s.scores.cpu().numpy()).max()))
                    for b, s in enumerate(singles)]
                batched[f"rot{shape[0]}_batch{shape[1]}"] = dict(
                    seconds=secs, max_rel_diff=max(rel),
                    top1_same=all(
                        int(res.rot_idx[b, 0]) == int(s.rot_idx[0])
                        and res.shifts[b, 0].tolist() == s.shifts[0].tolist()
                        for b, s in enumerate(singles)))
            rec["dock_batch"] = batched
            del args, singles

            # 3. The block engine's translation slabs, gathered, against
            # the whole grid on this card.
            g = torch.Generator().manual_seed(5)
            rep_rec = torch.randn((P12_BLOCK_L,) * 3 + (4,), generator=g)
            rep_lig = torch.randn((40,) * 3 + (4,), generator=g)
            A = torch.randn((4, 4), generator=g)
            rep_rec, rep_lig, A = (t.to(dev) for t in (rep_rec, rep_lig, A))
            with torch.inference_mode():
                slab, secs = timed(lambda: sharded_block_correlate(
                    mesh, rep_rec, rep_lig, A, block=P12_BLOCK))
                got = all_gather_rows(slab, mesh.get_group("rot"))
                want = block_correlate_scores(rep_rec, rep_lig, A,
                                              block=P12_BLOCK)
            rec["block"] = dict(
                L=P12_BLOCK_L, block=P12_BLOCK, slab=list(slab.shape),
                seconds=secs, max_abs_err=float((got - want).abs().max()),
                max_abs=float(want.abs().max()))
            del rep_rec, rep_lig, slab, got, want

            # 4. The data-parallel train step at the v9p config's width
            # (2 complexes x 24 decoys, rot 2 x batch world/2) against
            # the single-rank step on this card; then three steps, the
            # params hashed on every rank.
            cfg = _p12_configs()["v9p_config"]
            trainer = Trainer(cfg, dev)
            state = trainer.init_state()._replace(
                params={k: v.to(dev) for k, v in params.items()})
            step = make_parallel_train_step(
                trainer, pmesh.make_mesh(2, world // 2, "cuda"))
            batch = make_training_batch(
                torch.Generator().manual_seed(P12_TRAIN_SEED),
                synthetic_band(200, 4, widen=True, unbound=1.2), cfg,
                device=dev)
            (pl, pa, pg), secs = timed(
                lambda: step.value_and_grad(state.params, batch))
            sl, sa, sg = trainer.value_and_grad(state.params, batch)
            grad_rel = {k: float((pg[k] - w).abs().max()
                                 / max(float(w.abs().max()), 1e-30))
                        for k, w in sg.items()}
            losses = []
            for _ in range(3):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            h = hashlib.sha256()
            for k in sorted(state.params):
                h.update(state.params[k].cpu().numpy().tobytes())
            rec["train"] = dict(
                mesh=[2, world // 2], complexes=int(batch.rec_coords.shape[0]),
                decoys=int(batch.decoy_rot.shape[1]),
                loss=[float(pl), float(sl)], accuracy=[float(pa), float(sa)],
                loss_rel_diff=abs(float(pl) - float(sl))
                / max(abs(float(sl)), 1e-30),
                grad_rel_err=grad_rel, seconds=secs, losses_3_steps=losses,
                params_sha256=h.hexdigest())
            del trainer, step, batch, state

            # 5. The CLI on the mesh: dock --mesh-rot <world>, and with
            # ``full_depth`` the 13,000-rotation docks cold then warm.
            with open(os.path.join(tmp, "cli_pair.json")) as f:
                pair = json.load(f)
            reset()
            out = os.path.join(tmp, f"cli_mesh{world}")
            _, secs = timed(lambda: cli.main(
                ["dock", "--out", out, "--num-rotations", str(P12_ROTATIONS),
                 "--mesh-rot", str(world), "--checkpoint", V9P_DIR] + pair))
            rec["cli"] = dict(seconds=secs, launches=counts(), out=out)
            if full_depth:
                torch.backends.cudnn.allow_tf32 = True   # the CLI's default
                rec["full_depth"] = {}
                for name, extra in _p12_full_depth():
                    for tag in ("cold", "warm"):
                        reset()
                        out = os.path.join(tmp, f"full_{name}_{tag}")
                        _, secs = timed(lambda: cli.main(
                            ["dock", "--out", out, "--mesh-rot", str(world)]
                            + pair + extra))
                        rec["full_depth"][f"{name}_{tag}"] = dict(
                            seconds=secs, launches=counts(), out=out)
                    rec["full_depth"][f"{name}_split"] = _cli_dock_split(
                        ["dock", "--out", os.path.join(tmp, "full_split"),
                         "--mesh-rot", str(world)] + pair + extra)
            rec["rank_seconds"] = time.perf_counter() - t_start
        torch.save(rec, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        log.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def multi_gpu(dev, full_depth=False):
    """Phase 12: ``max(2, cards)`` ranks spawned from here, rank r on
    ``cuda:(r % cards)``, NCCL when every rank has its own card and gloo
    when ranks share one.  In each rank: the rotation-sharded docks of
    the bf16 bench config and the v9p config (launch counts set to 0
    just before and read just after; each config's first K1 and K2
    launch against plain), ``dock_batch`` over ``(1, ranks)`` and
    ``(ranks, 1)``, ``sharded_block_correlate`` at L = 128, the
    data-parallel train step and ``cli dock --mesh-rot <ranks>``; here,
    the single-card docks and CLI run they are held against.  With
    ``full_depth`` (``--multi-gpu``) also the 13,000-rotation CLI docks
    on the mesh and on one card.  Returns the phase's record."""
    import contextlib
    import io
    import multiprocessing as mp
    import shutil
    import tempfile

    import numpy as np
    import torch
    from deeplocalproteindocking_torch import cli, weights
    from deeplocalproteindocking_torch.correlate import fused, invz_topk
    from deeplocalproteindocking_torch.data import synthetic_complex
    from deeplocalproteindocking_torch.parallel.mesh import backend_for
    from deeplocalproteindocking_torch.pipeline import DockingPipeline

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    world = max(2, cards)
    backend = backend_for("cuda", world)
    tmp = tempfile.mkdtemp(prefix="dlpd_mgpu_")
    record = dict(ranks=world, cards=cards, backend=backend,
                  layout=[f"rank {r}: cuda:{r % cards}" for r in range(world)])
    try:
        # The single-card references on this card, TF32 off.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = weights.load_npz(os.path.join(V9P_DIR, "best_params.npz"))
        cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
        single = {}
        for name, cfg in _p12_configs().items():
            p = DockingPipeline(cfg, params=params, device=dev)
            poses = p.dock_complex(cplx, cluster=False)
            single[name] = dict(
                scores=poses.scores.tolist(),
                top1=[int(poses.rot_idx[0])] + [int(v)
                                                for v in poses.shifts[0]])
        del p, poses
        data = os.path.join(tmp, "data")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["generate-dataset", "--out", data, "--num-complexes",
                      "1", "--backbone", "--unbound-rmsd", "1.2"])
        pair = ["--receptor", os.path.join(data, "synth0_r_u.pdb"),
                "--ligand", os.path.join(data, "synth0_l_u.pdb")]
        with open(os.path.join(tmp, "cli_pair.json"), "w") as f:
            json.dump(pair, f)

        def cli_run(argv):
            fused.launches = fused.launches_tc = fused.launches_tf32 = 0
            invz_topk.launches = invz_topk.launches_fft = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv)
            torch.cuda.synchronize(dev)
            return dict(seconds=time.perf_counter() - t0, launches=dict(
                k1=fused.launches, k1_tf32=fused.launches_tf32,
                k2=invz_topk.launches, k2_fft=invz_topk.launches_fft))

        cli_single = os.path.join(tmp, "cli_mesh1")
        record["cli_single"] = cli_run(
            ["dock", "--out", cli_single, "--num-rotations",
             str(P12_ROTATIONS), "--mesh-rot", "1", "--checkpoint", V9P_DIR]
            + pair)
        if full_depth:
            torch.backends.cudnn.allow_tf32 = True     # the CLI's default
            record["full_depth_single"] = {}
            for name, extra in _p12_full_depth():
                for tag in ("cold", "warm"):
                    out = os.path.join(tmp, f"single_{name}_{tag}")
                    record["full_depth_single"][f"{name}_{tag}"] = dict(
                        cli_run(["dock", "--out", out, "--mesh-rot", "1"]
                                + pair + extra), out=out)
                record["full_depth_single"][f"{name}_split"] = (
                    _cli_dock_split(["dock", "--out",
                                     os.path.join(tmp, "single_split"),
                                     "--mesh-rot", "1"] + pair + extra))
            torch.backends.cudnn.allow_tf32 = False
        torch.cuda.empty_cache()

        # The ranks.
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_p12_rank,
                             args=(r, world, tmp, full_depth))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + P12_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        record["ranks_seconds"] = time.perf_counter() - t0
        for r in range(world):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    fail(f"phase 12: rank {r} failed:\n{f.read()}")
        check(not hung and all(p.exitcode == 0 for p in procs),
              f"phase 12: ranks {hung} hung, exit codes "
              f"{[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]

        def poses(out):
            with open(os.path.join(out, "poses.json")) as f:
                return json.load(f)

        def compare(got, want):
            """Top-K values (sorted) relative to the single card's, and
            whether the top-1 pose is the same."""
            g, w = np.sort(got["scores"]), np.sort(want["scores"])
            return dict(
                max_rel_diff=(float(np.max(np.abs(g - w) / np.abs(w)))
                              if len(g) == len(w) else None),
                top1_same=got["top1"] == want["top1"])

        def table(out):
            t = poses(out)
            return dict(scores=[p["score"] for p in t],
                        top1=[t[0]["rot_idx"]] + t[0]["shift"])

        record["docks"] = {
            name: dict(
                rotations=P12_ROTATIONS, rtol=P12_RTOL,
                seconds=[r["docks"][name]["seconds"] for r in ranks],
                launches_per_rank=[r["docks"][name]["launches"]
                                   for r in ranks],
                same_on_every_rank=all(
                    r["docks"][name]["scores"]
                    == ranks[0]["docks"][name]["scores"] for r in ranks),
                **compare(ranks[0]["docks"][name], single[name]))
            for name in single}
        record["kernels_vs_plain"] = [r["kernels_vs_plain"] for r in ranks]
        record["dock_batch"] = ranks[0]["dock_batch"]
        record["block"] = [r["block"] for r in ranks]
        record["train"] = [r["train"] for r in ranks]
        record["cli"] = dict(
            rotations=P12_ROTATIONS, single=record.pop("cli_single"),
            mesh_seconds=[r["cli"]["seconds"] for r in ranks],
            launches_per_rank=[r["cli"]["launches"] for r in ranks],
            **compare(table(ranks[0]["cli"]["out"]), table(cli_single)))
        record["rank_seconds"] = [r["rank_seconds"] for r in ranks]
        record["rank_devices"] = [f"{r['device']} ({r['card']}, "
                                  f"{r['backend']})" for r in ranks]
        if full_depth:
            fd = {}
            for name, _ in _p12_full_depth():
                s = record["full_depth_single"]
                fd[name] = dict(
                    rotations=BENCH_ROTATIONS,
                    single_seconds=[s[f"{name}_{t}"]["seconds"]
                                    for t in ("cold", "warm")],
                    single_launches=s[f"{name}_warm"]["launches"],
                    mesh_seconds=[[r["full_depth"][f"{name}_{t}"]["seconds"]
                                   for t in ("cold", "warm")]
                                  for r in ranks],
                    launches_per_rank=[
                        r["full_depth"][f"{name}_warm"]["launches"]
                        for r in ranks],
                    **compare(table(ranks[0]["full_depth"][
                        f"{name}_warm"]["out"]),
                        table(s[f"{name}_warm"]["out"])))
                fd[name]["speedup_warm"] = (fd[name]["single_seconds"][1]
                                            / max(t[1] for t in
                                                  fd[name]["mesh_seconds"]))
                fd[name]["split_single"] = s[f"{name}_split"]
                fd[name]["split_mesh"] = [r["full_depth"][f"{name}_split"]
                                          for r in ranks]
            record["full_depth"] = fd
            del record["full_depth_single"]
        record["seconds"] = time.perf_counter() - t_phase
        return record
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_multi_gpu(record):
    """Phase 12's gates, applied after its line is printed."""
    for name, d in record["docks"].items():
        check(d["same_on_every_rank"] and d["max_rel_diff"] is not None
              and d["max_rel_diff"] <= P12_RTOL and d["top1_same"],
              f"phase 12: sharded {name} dock against one card {d}")
        route = "k1_tc" if name == "bench_bf16" else "k1_tf32"
        for n in d["launches_per_rank"]:
            check(n["k1"] > 0 and n[route] == n["k1"] and n["k2"] > 0
                  and n["k2_fft"] == n["k2"] and n["k3"] == 0,
                  f"phase 12: {name} launches on a rank {n}")
    for per_rank in record["kernels_vs_plain"]:
        check(sorted(per_rank) == ["bench_bf16_k1", "bench_bf16_k2",
                                   "v9p_config_k1", "v9p_config_k2"]
              and per_rank["bench_bf16_k1"]["route"] == "tc"
              and per_rank["v9p_config_k1"]["route"] == "tf32"
              and all(e["route"] == "fft" for k, e in per_rank.items()
                      if k.endswith("k2"))
              and all(e["rel_err"] <= (TOL_BF16 if k == "bench_bf16_k1"
                                       else TOL_F32)
                      for k, e in per_rank.items()),
              f"phase 12: a rank's first launches against plain {per_rank}")
    for name, b in record["dock_batch"].items():
        check(b["max_rel_diff"] <= P12_RTOL and b["top1_same"],
              f"phase 12: dock_batch {name} against single sweeps {b}")
    for b in record["block"]:
        check(b["max_abs_err"] <= TOL_F32 * b["max_abs"],
              f"phase 12: sharded_block_correlate {b}")
    for t in record["train"]:
        check(t["loss_rel_diff"] <= TRAIN_RTOL
              and abs(t["accuracy"][0] - t["accuracy"][1]) <= TRAIN_RTOL
              and max(t["grad_rel_err"].values()) <= GRAD_TOL
              and all(math.isfinite(v) for v in t["losses_3_steps"]),
              f"phase 12: parallel train step against one rank {t}")
    check(len({t["params_sha256"] for t in record["train"]}) == 1,
          "phase 12: params differ across ranks after three steps")
    c = record["cli"]
    check(c["max_rel_diff"] is not None and c["max_rel_diff"] <= P12_RTOL
          and c["top1_same"]
          and all(n["k1"] > 0 and n["k2"] > 0
                  for n in c["launches_per_rank"]),
          f"phase 12: cli dock --mesh-rot against --mesh-rot 1 {c}")
    for name, d in record.get("full_depth", {}).items():
        check(d["max_rel_diff"] is not None
              and d["max_rel_diff"] <= P12_RTOL and d["top1_same"],
              f"phase 12: full-depth {name} on the mesh against one card {d}")


def mesh_run(dev, card):
    """``--multi-gpu``: phase 12 with the 13,000-rotation CLI docks on the
    mesh, then the commands a user runs, each a fresh ``torchrun`` (or
    one process for one card): the two CLI docks on every card and on
    one, and ``measure_scaling`` at 1, 2, ... ranks up to every card.
    One JSON line each."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from deeplocalproteindocking_torch import cli

    rec = multi_gpu(dev, full_depth=True)
    emit("multi_gpu", card=card, **rec)
    check_multi_gpu(rec)
    cards = torch.cuda.device_count()
    env = dict(os.environ, PYTHONPATH=ROOT)
    tmp = tempfile.mkdtemp(prefix="dlpd_mesh_run_")
    try:
        data = os.path.join(tmp, "data")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["generate-dataset", "--out", data, "--num-complexes",
                      "1", "--backbone", "--unbound-rmsd", "1.2"])
        pair = ["--receptor", os.path.join(data, "synth0_r_u.pdb"),
                "--ligand", os.path.join(data, "synth0_l_u.pdb")]

        def launch(cmd, timeout=900):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=timeout)
            check(r.returncode == 0, f"{' '.join(cmd)} failed:\n"
                                     f"{r.stderr[-3000:]}")
            return time.perf_counter() - t0, r.stdout

        for name, extra in _p12_full_depth():
            out = {}
            for world in (1, cards):
                out[world] = os.path.join(tmp, f"{name}_{world}")
                head = ([sys.executable, "-m"] if world == 1 else
                        ["torchrun", "--standalone", "--nproc-per-node",
                         str(world), "-m"])
                secs, _ = launch(head + [
                    "deeplocalproteindocking_torch.cli", "dock", "--out",
                    out[world], "--mesh-rot", str(world)] + pair + extra)
                out[world] = (out[world], secs)
            tables = {}
            for world, (d, _) in out.items():
                with open(os.path.join(d, "poses.json")) as f:
                    tables[world] = json.load(f)
            g = np.sort([p["score"] for p in tables[cards]])
            w = np.sort([p["score"] for p in tables[1]])
            line = dict(command=name, ranks=cards,
                        rotations=BENCH_ROTATIONS,
                        wall_seconds={str(k): v[1] for k, v in out.items()},
                        poses=[len(g), len(w)],
                        max_rel_diff=(float(np.max(np.abs(g - w) / np.abs(w)))
                                      if len(g) == len(w) else None),
                        top1_same=(tables[cards][0]["rot_idx"],
                                   tables[cards][0]["shift"])
                        == (tables[1][0]["rot_idx"], tables[1][0]["shift"]))
            emit("torchrun_cli_dock", card=card, **line)
            check(line["max_rel_diff"] is not None
                  and line["max_rel_diff"] <= P12_RTOL and line["top1_same"],
                  f"torchrun cli dock {name}: {line}")
        world = 1
        while world <= cards:
            head = ["torchrun", "--standalone", "--nproc-per-node",
                    str(world), "-m"]
            secs, stdout = launch(head + [
                "deeplocalproteindocking_torch.measure_scaling",
                str(BENCH_ROTATIONS)], timeout=1200)
            for ln in stdout.strip().splitlines():
                if ln.startswith("{"):
                    emit("measure_scaling", card=card, command_seconds=secs,
                         **json.loads(ln))
            world *= 2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 13: the JAX package's Orbax checkpoints, restored without JAX.
# Every family's latest best (or latest step where it has no best/), its
# own config.json; the CPU half of each card-vs-CPU dock sets the count
# (the grid-64 families take ~9 s per 64 rotations on the CPU).
CKPT_FAMILIES = ("synthetic-v1", "synthetic-v2", "synthetic-v3",
                 "synthetic-v4", "synthetic-v5u", "synthetic-v6u",
                 "synthetic-v7p", "synthetic-v9p")
CKPT_ROTATIONS = 32         # cut from 256 for the CPU half
CKPT_KERNEL_ROTATIONS = 256  # v1 under dft_fused, v2 under dft_pallas
# The resumed step's Adam update, card vs CPU, x each leaf's largest
# update.  Looser than GRAD_TOL: where a moment nu is near 0,
# mu / sqrt(nu) magnifies the gradients' last-bit differences (6.6e-4
# at v9p's step 3000 on an H100, against 1e-6 for the gradients).
UPDATE_TOL = 1e-2
# Kernels each engine must launch on a dock (route counters that must
# equal them); the dft engine runs none.
ENGINE_KERNELS = {"dft_fused": (("k1", "k1_tf32"), ("k2", "k2_fft")),
                  "dft_pallas": (("k3", "k3_fft"),),
                  "dft": ()}


def checkpoints(dev):
    """Phase 13: restore the shipped Orbax checkpoints through the port's
    own reader, with JAX, flax, optax, orbax, tensorstore and zstandard
    blocked from import (none may have been imported before), TF32 off.
    v9p's ``best/`` held equal to its export ``best_params.npz``; each
    family's latest checkpoint docked on its own config on the card and
    on the CPU, with the launch counts set to 0 just before each card
    dock and read just after; v1 again under ``dft_fused`` (tf32 K1,
    FFT K2 at L = 32) and v2 under ``dft_pallas`` (FFT K3 at L = 48);
    v9p's ``step_00003000`` resumed as a whole training state and
    stepped once on the card and on the CPU; ``coupling_spectrum`` on
    v5u's ``best/``.  Returns the phase's record."""
    import importlib.util

    import numpy as np
    import torch
    from deeplocalproteindocking_torch import coupling_spectrum, weights
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.correlate import fused, idft, invz_topk
    from deeplocalproteindocking_torch.data import synthetic_complex
    from deeplocalproteindocking_torch.data.benchmark import synthetic_band
    from deeplocalproteindocking_torch.pipeline import (DockingPipeline,
                                                        min_licensed_rank)
    from deeplocalproteindocking_torch.train import Trainer, checkpoint
    from deeplocalproteindocking_torch.train.data_gen import (
        make_training_batch)

    pre = os.path.join(ROOT, "pretrained")
    # The phase runs with these imports blocked: a reader that reached
    # for any of them would raise.
    foreign = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
               "zstandard")
    record = dict(importable={m: importlib.util.find_spec(m) is not None
                              for m in foreign},
                  loaded_before=[m for m in foreign if m in sys.modules])
    blocked = [m for m in foreign if m not in sys.modules]
    for m in blocked:
        sys.modules[m] = None
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # v9p's best/ against its export.
        t0 = time.perf_counter()
        best = checkpoint.load_params(os.path.join(V9P_DIR, "best"))
        decode = time.perf_counter() - t0
        npz = weights.load_npz(os.path.join(V9P_DIR, "best_params.npz"))
        record["v9p_best_vs_npz"] = dict(
            decode_seconds=decode, tensors=len(npz),
            equal=(set(best) == set(npz)
                   and all(torch.equal(best[k], npz[k]) for k in npz)))

        cplx = synthetic_complex(seed=0)

        def dock(name, ckpt, cfg, params):
            """``cfg``'s dock of ``params`` on the card (counted) and on
            the CPU; the record."""
            pipe = DockingPipeline(cfg, params=params, device=dev)
            fused.launches = fused.launches_tc = fused.launches_tf32 = 0
            invz_topk.launches = invz_topk.launches_fft = 0
            idft.launches = idft.launches_fft = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pipe.dock_complex(cplx, cluster=False)
            torch.cuda.synchronize()
            rec = dict(checkpoint=ckpt, engine=cfg.fft_impl,
                       grid=cfg.grid_size, dtype=cfg.dft_dtype,
                       rotations=cfg.num_rotations,
                       card_seconds=time.perf_counter() - t0,
                       launches=dict(
                           k1=fused.launches, k1_tc=fused.launches_tc,
                           k1_tf32=fused.launches_tf32,
                           k2=invz_topk.launches,
                           k2_fft=invz_topk.launches_fft,
                           k3=idft.launches, k3_fft=idft.launches_fft))
            t0 = time.perf_counter()
            want = DockingPipeline(cfg, params=params,
                                   device="cpu").dock_complex(cplx,
                                                              cluster=False)
            a, b = np.sort(got.scores), np.sort(want.scores)
            rec.update(
                cpu_seconds=time.perf_counter() - t0, poses=len(got),
                finite=bool(np.isfinite(got.scores).all()),
                max_rel_diff=float(np.max(np.abs(a - b) / np.abs(b))),
                values_close=len(a) == len(b) > 0
                and bool(np.allclose(a, b, rtol=1e-3, atol=0)),
                top1_same=(int(got.rot_idx[0]) == int(want.rot_idx[0])
                           and list(got.shifts[0]) == list(want.shifts[0])))
            emit("checkpoint_dock", name=name, **rec)
            return rec

        docks, loaded = {}, {}
        for fam in CKPT_FAMILIES:
            ckpt = os.path.join(pre, fam)
            if os.path.isdir(os.path.join(ckpt, "best")):
                ckpt = os.path.join(ckpt, "best")
            with open(os.path.join(pre, fam, "config.json")) as f:
                cfg = DockConfig.from_json(f.read())
            t0 = time.perf_counter()
            params = checkpoint.load_params(ckpt)
            decode = time.perf_counter() - t0
            loaded[fam] = (cfg, params)
            rel = os.path.relpath(ckpt, ROOT)
            docks[fam] = dock(fam, rel, cfg.replace(
                num_rotations=CKPT_ROTATIONS), params)
            docks[fam].update(decode_seconds=decode,
                              step=checkpoint.latest_step(ckpt))
        for name, fam, engine in (("v1_dft_fused", "synthetic-v1",
                                   "dft_fused"),
                                  ("v2_dft_pallas", "synthetic-v2",
                                   "dft_pallas")):
            cfg, params = loaded[fam]
            docks[name] = dock(name, f"pretrained/{fam}", cfg.replace(
                fft_impl=engine, num_rotations=CKPT_KERNEL_ROTATIONS),
                params)
        record["docks"] = docks

        # v9p's step 3000 as a whole training state: one step on the card
        # and on the CPU from the restored params, moments and count; the
        # updates read the moments and are held within UPDATE_TOL.
        with open(os.path.join(V9P_DIR, "config.json")) as f:
            v9p_cfg = DockConfig.from_json(f.read())
        one = v9p_cfg.replace(batch_complexes=1, num_decoys=8)
        t0 = time.perf_counter()
        state = checkpoint.load_train_state(V9P_DIR, 3000)
        decode = time.perf_counter() - t0
        complexes = synthetic_band(200, 2, widen=True, unbound=1.2)
        b1 = make_training_batch(torch.Generator().manual_seed(1), complexes,
                                 one, device="cpu")
        out = {}
        for where in (dev, torch.device("cpu")):
            tr = Trainer(one, where)
            st = state.to(where)
            t0 = time.perf_counter()
            loss, acc, grads = tr.value_and_grad(st.params, b1.to(where))
            new = tr.apply_gradients(st, grads)
            out[where.type] = (loss.item(), acc.item(),
                               {k: v.cpu() for k, v in grads.items()},
                               {k: (new.params[k] - st.params[k]).cpu()
                                for k in st.params},
                               new, time.perf_counter() - t0)
        (gl, ga, gg, gu, gnew, gs), (wl, wa, wg, wu, wnew, ws) = (
            out[dev.type], out["cpu"])
        record["resume_step"] = dict(
            checkpoint="pretrained/synthetic-v9p/step_00003000",
            decode_seconds=decode, restored_step=state.step,
            restored_count=state.opt_state["count"],
            steps_after=[gnew.step, wnew.step],
            counts_after=[gnew.opt_state["count"], wnew.opt_state["count"]],
            loss=[gl, wl], accuracy=[ga, wa],
            loss_rel_diff=abs(gl - wl) / abs(wl),
            accuracy_abs_diff=abs(ga - wa),
            grad_rel_err={k: float((gg[k] - w).abs().max() / w.abs().max())
                          for k, w in wg.items()},
            update_rel_err={k: float((gu[k] - w).abs().max()
                                     / w.abs().max())
                            for k, w in wu.items()},
            moments_sound=all(
                bool(torch.isfinite(m).all()) and bool(m.any())
                for part in ("mu", "nu")
                for m in state.opt_state[part].values())
            and all(bool((v >= 0).all())
                    for v in state.opt_state["nu"].values()),
            card_seconds=gs, cpu_seconds=ws, rtol=TRAIN_RTOL,
            grad_tol=GRAD_TOL, update_tol=UPDATE_TOL)

        # The coupling spectrum of v5u's best/, the tool's default.
        path = os.path.join(pre, "synthetic-v5u", "best")
        t0 = time.perf_counter()
        lines = coupling_spectrum.spectrum_lines(path)
        A = checkpoint.load_params(path)["coupling"].numpy()
        record["coupling_spectrum"] = dict(
            checkpoint="pretrained/synthetic-v5u/best",
            seconds=time.perf_counter() - t0, lines=lines,
            licensed_rank=min_licensed_rank(A, shape_prior=True))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        for m in blocked:
            del sys.modules[m]
    record["blocked"] = blocked
    record["decode_seconds"] = {
        "synthetic-v9p/step_00003000":
            record["resume_step"]["decode_seconds"],
        **{os.path.relpath(d["checkpoint"], "pretrained"):
           d["decode_seconds"] for d in docks.values()
           if "decode_seconds" in d}}
    return record


def check_checkpoints(record):
    """Phase 13's gates, applied after its line is printed."""
    r = record
    check(not r["loaded_before"],
          f"checkpoints: {r['loaded_before']} were imported before phase 13")
    check(r["v9p_best_vs_npz"]["equal"],
          "checkpoints: v9p's best/ differs from best_params.npz")
    for name, d in r["docks"].items():
        check(d["finite"] and d["values_close"] and d["top1_same"],
              f"checkpoints: {name} card vs CPU {d}")
        n = d["launches"]
        want = ENGINE_KERNELS[d["engine"]]
        for total, route in want:
            check(n[total] > 0 and n[route] == n[total],
                  f"checkpoints: {name} on {d['engine']} launched "
                  f"{n[total]} {total} ({n[route]} on {route}) {n}")
        launched = {k for k in ("k1", "k2", "k3") if n[k]}
        check(launched == {t for t, _ in want},
              f"checkpoints: {name} on {d['engine']} launched {n}")
    check(r["docks"]["v1_dft_fused"]["grid"] == 32
          and r["docks"]["v2_dft_pallas"]["grid"] == 48,
          "checkpoints: v1 / v2 not at grids 32 / 48")
    s = r["resume_step"]
    check(s["restored_step"] == s["restored_count"] == 3000
          and s["steps_after"] == [3001, 3001]
          and s["counts_after"] == [3001, 3001],
          f"checkpoints: the resumed step {s}")
    check(s["loss_rel_diff"] <= TRAIN_RTOL
          and s["accuracy_abs_diff"] <= TRAIN_RTOL
          and max(s["grad_rel_err"].values()) <= GRAD_TOL
          and max(s["update_rel_err"].values()) <= UPDATE_TOL,
          f"checkpoints: the resumed step, card vs CPU {s}")
    check(s["moments_sound"],
          f"checkpoints: v9p step 3000's Adam moments are not finite and "
          f"nonzero with nu >= 0 {s}")
    c = r["coupling_spectrum"]
    check(len(c["lines"]) == 18 and c["lines"][-1].endswith(
        f": {c['licensed_rank']}"),
          f"checkpoints: coupling_spectrum {c}")


def splat_timed(dev, n_res, b, L, bucket, seed):
    """``separable_splat``'s kernel on ``b`` rotations of a ``n_res``
    polymer ligand (padded to ``bucket`` atoms) at grid ``L``, timed
    beside its plain version and the bmm it replaces, with its bound (its
    FMAs, 2 n_real L^3 a rotation, at the float32 peak, or the output's
    bytes, whichever is longer), held against plain voxel by voxel
    (1e-5 of the voxel, plus the smallest normal float)."""
    import torch
    from deeplocalproteindocking_torch.data import (structure_to_device,
                                                    synthetic_complex)
    from deeplocalproteindocking_torch.grids import voxelize
    from deeplocalproteindocking_torch.structure.so3 import (
        super_fibonacci_rotations)
    cplx = synthetic_complex(seed=seed, n_res_rec=300, n_res_lig=n_res,
                             backbone=True)
    c, types, mask = (v.to(dev) for v in structure_to_device(
        cplx.ligand.centered(), bucket=bucket))
    coords = torch.einsum("bij,nj->bni", super_fibonacci_rotations(b, dev),
                          c).contiguous()
    T, res = 11, 1.25
    kw = dict(grid_size=L, resolution=res, sigma=1.0, num_types=T)
    reps = 5 if b >= 128 else 20
    origin = torch.full((3,), -0.5 * L * res, device=dev)
    tsafe = types.clamp(0, T - 1).long()
    w = mask * (types >= 0)

    def plain():
        return voxelize._contract(coords, tsafe, w, L, T, res, 1.0, origin)

    with torch.inference_mode():
        l0 = voxelize.launches
        got = voxelize.separable_splat(coords, types, mask, **kw)
        torch.cuda.synchronize()
        launched = voxelize.launches - l0
        want = plain()
        err = (got - want).abs()
        within = bool((err <= 1e-5 * want.abs() + 2.0 ** -126).all())
        bit_equal = bool(torch.equal(got, want))
        del got, want, err
        ms = cuda_time_ms(lambda: voxelize.separable_splat(
            coords, types, mask, **kw), reps=reps)
        plain_ms = cuda_time_ms(plain, reps=max(2, reps // 4))
        # The bmm alone, on the plain version's own U and W.
        g = (coords - origin) / res - 0.5
        d = (g[..., None] - torch.arange(L, dtype=torch.float32,
                                         device=dev)) * res
        prof = torch.exp(-(d * d) / 2.0)
        W = ((prof[..., 0, :] * w[:, None])[..., None]
             * torch.nn.functional.one_hot(tsafe, T).float()[:, None, :])
        U = prof[..., 1, :, None] * prof[..., 2, None, :]
        Ut = U.reshape(b, -1, L * L).transpose(1, 2)
        Wr = W.reshape(b, -1, L * T)
        library_ms = cuda_time_ms(lambda: torch.bmm(Ut, Wr),
                                  reps=max(2, reps // 4))
        del g, d, prof, W, U, Ut, Wr
    torch.cuda.empty_cache()
    n_real = int((mask * (types >= 0)).sum())
    return dict(rotations=b, L=L, atoms=int(c.shape[0]), real_atoms=n_real,
                tile=list(voxelize.splat_tile(L, T)), launches=launched,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                within_tolerance=within, bit_equal=bit_equal,
                bound=bound(b * L ** 3 * T * 4, 2 * n_real * L ** 3 * b,
                            "float32"))


def main():
    import numpy as np
    import torch
    mesh_only = sys.argv[1:] == ["--multi-gpu"]
    if sys.argv[1:] and not mesh_only:
        fail(f"usage: python3 chip_smoke.py [--multi-gpu], got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, ROOT)
    from deeplocalproteindocking_torch import _build, weights
    from deeplocalproteindocking_torch.config import PRESETS, DockConfig
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
    if mesh_only:
        mesh_run(dev, card)
        print(json.dumps({"ok": True, "mode": "multi-gpu", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

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

    def k1_random_inputs(b, box, C=3, seed=0, dtype_name="bfloat16", Lk=L):
        """K1's arguments from random volumes and receptor grid (grid
        Lk)."""
        g = torch.Generator().manual_seed(seed)
        corr = get_correlator(Lk, box, dtype_name, dev)
        with torch.inference_mode():
            Hr = receptor_transform(torch.randn(Lk, Lk, Lk, C,
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
        return k3_check([torch.randn((b, Lk, Lk, Lk), generator=g,
                                     device=dev) for _ in range(2)]
                        + [corr.UxRe32, corr.UxIm32] * 2)

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
        # Boxes above 64 run on the tensor cores in tiles of A (an odd box:
        # the tc kernel's plain loads of A instead of cp.async).
        for box in (64, 71, 72, 96, 128):
            key = f"k1_bf16_box{box}_random"
            errs[key], routes[key], _ = k1_check(k1_random_inputs(2, box))
        for box in (72, 96, 128):
            key = f"k1_f32_box{box}_random"
            errs[key], routes[key], _ = k1_check(
                k1_random_inputs(2, box, dtype_name="float32"))
        # L not a multiple of 16: both tensor-core kernels pad it to 128.
        for key, box, name in (("k1_bf16_L120", Ls, "bfloat16"),
                               ("k1_f32_L120", 72, "float32")):
            errs[key], routes[key], _ = k1_check(
                k1_random_inputs(2, box, dtype_name=name, Lk=120))
        errs["k1_f32_G4"], routes["k1_f32_G4"], _ = k1_check(
            grouped(*k1_inputs(8, "float32")))
        for name, tag in (("float32", "f32"), ("bfloat16", "bf16")):
            key = f"k1_{tag}_box96_G4"
            errs[key], routes[key], _ = k1_check(
                grouped(get_correlator(L, 96, name, dev),
                        k1_random_inputs(8, 96, dtype_name=name)))
        errs["k2_fft"], route, bk = k2_check(
            (D[0], D[1], corr32.MzRe, corr32.MzIm, bias))
        check(route == "fft", "K2 at L=128 did not launch its FFT kernel")
        k2_routes = {}
        for key, Lk in (("k2_fft_L32", 32), ("k2_fft_L64", 64),
                        ("k2_fft_L96", 96)):
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
        for key, Lk in K3_RANDOM_CHECKS.items():
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
         k2_fft_L96_rel_err=errs["k2_fft_L96"][1],
         k2_fft_L32_rel_err=errs["k2_fft_L32"][1], k2_routes=k2_routes,
         drill_topk_rel_err=drill_err[1],
         drill_index_rel_err=drill_idx_err[1],
         k3_max_abs_err=errs["k3"][0], k3_rel_err=errs["k3"][1],
         k3_rel_errs={k: errs[k][1] for k in K3_RANDOM_CHECKS},
         k3_routes=k3_routes,
         tolerance={"float32": TOL_F32, "bfloat16": TOL_BF16},
         masked_fraction=1.0 - mask.float().mean().item())
    want_routes = {}
    for key in routes:
        f32 = key == "k1_float32" or key.startswith("k1_f32_")
        check(errs[key][1] <= (TOL_F32 if f32 else TOL_BF16),
              f"K1 {key} {errs}")
        want_routes[key] = "tf32" if f32 else "tc"
    check(len(routes) == 16 and routes == want_routes,
          f"K1 routes {routes}, expected {want_routes}")
    for key in ("k2_fft", "k2_fft_L32", "k2_fft_L64", "k2_fft_L96"):
        check(errs[key][1] <= TOL_F32, f"K2 {key} {errs}")
    check(k2_routes == {"k2_fft_L32": "fft", "k2_fft_L64": "fft",
                        "k2_fft_L96": "fft"}, f"K2 routes {k2_routes}")
    for key in ("k3", *K3_RANDOM_CHECKS):
        check(errs[key][1] <= TOL_F32, f"K3 {key} {errs}")
    check(k3_routes == {k: k.split("_")[1] for k in K3_RANDOM_CHECKS},
          f"K3 routes {k3_routes}")
    check(drill_err[1] <= 1e-5 and drill_idx_err[1] <= 1e-5,
          f"drill_topk vs exact_block_topk: {drill_err} {drill_idx_err}")

    def timed(launch, plain, args):
        """A kernel's wrapper ``launch`` and its plain version on
        ``args``, each timed with its launches queued (``cuda_time_ms``),
        then the output held against plain.  Returns (ms, plain ms, (max
        abs err, rel err), plain's output)."""
        ms = cuda_time_ms(lambda: launch(*args), queued=True)
        plain_ms = cuda_time_ms(lambda: plain(*args), queued=True)
        want = plain(*args)
        return ms, plain_ms, rel_err(launch(*args), want), want

    def k2_timed(args):
        """K2 on ``args`` (bias ``[G, X, Y, Z]``) as ``timed``, with its
        bound (D read, the bias read, bmax written; the FFT's work).
        Returns a record."""
        ms, plain_ms, err, _ = timed(invz_topk.invz_blockmax,
                                     invz_topk.invz_blockmax_reference, args)
        Dre, bk = args[0], args[4]
        bb, Lk = Dre.shape[0], args[2].shape[1]
        return dict(route=invz_topk.k2_route(Lk), shape=list(Dre.shape),
                    groups=bk.shape[0], ms=ms, plain_ms=plain_ms,
                    max_abs_err=err[0], rel_err=err[1], bound=bound(
                        (2 * Dre.numel() + bk.numel() + bb * Lk ** 3 // 32)
                        * 4, k2_fft_flops(Lk) * bb * Lk * Lk, "float32"))

    def k3_timed(args):
        """K3 on ``args`` as ``timed``, beside ``torch.fft.ifft2``, the
        one PyTorch call that computes its function (never used by the
        port, only its yardstick), with its bound: E read, S written and
        the twiddles; one FFT along kx and one along ky per line.
        Returns a record."""
        ms, plain_ms, err, want = timed(idft.idft_bc,
                                        idft.idft_bc_reference, args)

        def library():
            return torch.fft.ifft2(torch.complex(args[0], args[1]),
                                   dim=(1, 2)).real

        nvol, Lk = args[0].numel(), args[0].shape[1]
        return dict(route=idft.k3_route(Lk), shape=list(args[0].shape),
                    ms=ms, plain_ms=plain_ms, max_abs_err=err[0],
                    rel_err=err[1],
                    library_ms=cuda_time_ms(library, queued=True),
                    library_rel_err=rel_err(library(), want)[1],
                    bound=bound((3 * nvol + 4 * Lk * Lk) * 4,
                                2 * (nvol // Lk) * fft_flops(Lk),
                                "float32"))

    # Times at the main path's full chunk: b=128 rotations, bf16.
    with torch.inference_mode():
        corr16, args16 = k1_inputs(128, "bfloat16")
        D16 = fused.fused_correlate(*args16)
        k1_ms = cuda_time_ms(lambda: fused.fused_correlate(
            *args16, layouts=corr16.k1_layouts))
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
                lambda: fused.fused_correlate(*a,
                                              layouts=corr16.k1_layouts)))
        k1_g4_ms = sum(k1_turns["G4"]) / 2
        del args16_g4
        k2_at = {128: k2_timed(
            (D16[0], D16[1], corr16.MzRe, corr16.MzIm, bias[None]))}
        # The 16-head rescore's K2 launch: 48 rows, 16 bias groups.
        g16 = torch.Generator(device=dev).manual_seed(16)
        bias16 = torch.where(torch.rand((16, L, L, L), generator=g16,
                                        device=dev) < 0.6, 0.0, float("-inf"))
        k2_rescore = k2_timed(
            (D16[0][:48], D16[1][:48], corr16.MzRe, corr16.MzIm, bias16))
        del D16, args16, bias16
        # K3 on the dft_pallas path's chunk.
        k3_at = {128: k3_timed(k3_inputs(128))}
        # K2 at L = 32 and 96 and K3 at L = 16 (one pass), 32, 48, 80, 96
        # and 112 (the last z run half full at 48, 80, 112), b = 128, on
        # random inputs: every other L that each kernel takes.
        for Lk in (32, 96, 16, 48, 80, 112):
            gk = torch.Generator(device=dev).manual_seed(Lk)
            ck = get_correlator(Lk, 16, "float32", dev)
            if Lk % 32 == 0:
                dk = [torch.randn((128, Lk // 2 + 1, Lk, Lk), generator=gk,
                                  device=dev) for _ in range(2)]
                bk = torch.where(torch.rand((1, Lk, Lk, Lk), generator=gk,
                                            device=dev) < 0.6, 0.0,
                                 float("-inf"))
                k2_at[Lk] = k2_timed((*dk, ck.MzRe, ck.MzIm, bk))
                del dk, bk
            ek = [torch.randn((128, Lk, Lk, Lk), generator=gk, device=dev)
                  for _ in range(2)]
            k3_at[Lk] = k3_timed(
                (*ek, ck.UxRe32, ck.UxIm32, ck.UxRe32, ck.UxIm32))
            del ek
            torch.cuda.empty_cache()
        bounds["k2"], bounds["k3"] = k2_at[128]["bound"], k3_at[128]["bound"]

        def k1_routes(corr, args, reps=5, route="tf32"):
            """K1's tensor-core ``route`` (with ``corr``'s kept twiddle
            layouts, as the main path launches it) on ``args``, timed
            twice, then its output held against plain.  Returns (turns,
            {route: mean ms}, plain ms, {route: (max abs err, rel
            err)})."""
            Lk = args[8].shape[1]
            dims = tuple(args[0].shape) + (Lk,) * 4
            D = [torch.empty((args[0].shape[0], args[0].shape[1], Lk, Lk),
                             device=dev) for _ in range(2)]
            ops = args[:4] + corr.k1_layouts
            tensor_cores = fused._launch_tc if route == "tc" else (
                fused._launch_tf32)
            launch = {route: lambda: tensor_cores(ops, dims, *D)}
            turns = {route: [cuda_time_ms(launch[route], reps)
                             for _ in range(2)]}
            plain_ms = cuda_time_ms(
                lambda: fused.fused_correlate_reference(*args), reps)
            want = fused.fused_correlate_reference(*args)
            route_errs = {}
            for route, fn in launch.items():
                fn()
                torch.cuda.synchronize()
                e = [rel_err(g, w) for g, w in zip(D, want)]
                route_errs[route] = (max(a for a, _ in e),
                                     max(r for _, r in e))
            return (turns, {r: sum(v) / 2 for r, v in turns.items()},
                    plain_ms, route_errs)

        # Float32 K1 at the bench box, b = 128, and at the v9p
        # checkpoint's config (grid 64, box 40, C = 16, 16 rows a launch).
        # The bound is the tf32 route's: float32 work at the 3xTF32 rate.
        corr32, args32 = k1_inputs(128, "float32")
        (k1_f32_turns, k1_f32_ms, k1_f32_plain_ms,
         k1_f32_errs) = k1_routes(corr32, args32)
        bounds["k1_float32"] = bound(
            sum(t.numel() * t.element_size() for t in args32)
            + 2 * 128 * (L // 2 + 1) * L * L * 4, k1_flops, "3xtf32")
        del args32
        av9p = k1_random_inputs(16, 40, C=16, dtype_name="float32", Lk=64)
        k1_v9p = dict(zip(("turns", "ms", "plain_ms", "errs"),
                          k1_routes(
                              get_correlator(64, 40, "float32", dev), av9p,
                              reps=20)),
                      shape=list(av9p[0].shape), L=64)
        del av9p

        def k1_bound_at(args, peak):
            """K1's bound on ``args``: its inputs and D moved once, its
            FFTs (forward y over the box's rows) at ``peak``."""
            b_, K_, C_, X_, _ = args[0].shape
            Lk = args[8].shape[1]
            flops = (C_ * (X_ + Lk) * fft_flops(Lk) + 8 * C_ * Lk * Lk
                     + 2 * Lk * fft_flops(Lk)) * K_ * b_
            return bound(sum(t.numel() * t.element_size() for t in args)
                         + 2 * b_ * K_ * Lk * Lk * 4, flops, peak)

        # Boxes above 64, b = 128, L = 128: each tensor-core route (tiles
        # of A) at boxes 72, 96 and 128.
        k1_big = {}
        for name, route, peak in (("bfloat16", "tc", "bfloat16"),
                                  ("float32", "tf32", "3xtf32")):
            for box in (72, 96, 128):
                ab = k1_random_inputs(128, box, dtype_name=name)
                turns_b, ms_b, plain_b, errs_b = k1_routes(
                    get_correlator(L, box, name, dev), ab, reps=3,
                    route=route)
                k1_big[f"{route}_box{box}"] = dict(
                    shape=list(ab[0].shape), L=L, turns=turns_b, ms=ms_b,
                    plain_ms=plain_b,
                    max_abs_err={r: e[0] for r, e in errs_b.items()},
                    rel_err={r: e[1] for r, e in errs_b.items()},
                    bound=k1_bound_at(ab, peak))
                del ab
                torch.cuda.empty_cache()
        # L = 120, padded to 128 in the tensor-core kernels, b = 128: the
        # grid-120 request's shape (bf16, the bench complex's box) on tc,
        # and float32 at box 72 on tf32.
        k1_l120 = {}
        for name, box, route, peak in (
                ("bfloat16", Ls, "tc", "bfloat16"),
                ("float32", 72, "tf32", "3xtf32")):
            a120 = k1_random_inputs(128, box, dtype_name=name, Lk=120)
            turns_b, ms_b, plain_b, errs_b = k1_routes(
                get_correlator(120, box, name, dev), a120, reps=3,
                route=route)
            k1_l120[route] = dict(
                shape=list(a120[0].shape), L=120, turns=turns_b,
                ms=ms_b[route], plain_ms=plain_b,
                max_abs_err=errs_b[route][0], rel_err=errs_b[route][1],
                bound=k1_bound_at(a120, peak))
            del a120
            torch.cuda.empty_cache()
    emit("kernel_times", batch=128, dtype="bfloat16", Ls=Ls, k1_ms=k1_ms,
         k1_plain_ms=k1_plain_ms,
         k1_groups=dict(G=4, turns=k1_turns, ms=k1_g4_ms, route=k1g_route,
                        max_abs_err=k1g_err[0], rel_err=k1g_err[1]),
         k2_dtype="float32", k2_at={str(k): v for k, v in k2_at.items()},
         k2_rescore=k2_rescore, k1_above_box64=k1_big, k1_L120=k1_l120,
         k3_at={str(k): v for k, v in k3_at.items()},
         k1_float32=dict(turns=k1_f32_turns, ms=k1_f32_ms,
                         plain_ms=k1_f32_plain_ms,
                         rel_err={r: e[1] for r, e in k1_f32_errs.items()},
                         max_abs_err={r: e[0]
                                      for r, e in k1_f32_errs.items()}),
         k1_float32_v9p_config=dict(
             {k: v for k, v in k1_v9p.items() if k != "errs"},
             rel_err={r: e[1] for r, e in k1_v9p["errs"].items()}),
         k3_dtype="float32",
         k3_library="torch.fft.ifft2(torch.complex(Ere, Eim), "
                    "dim=(1, 2)).real",
         bounds=bounds, peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                               "flops_per_s": PEAK_FLOPS},
         timer="cuda events, mean of 5 after 1 warm-up (3 for K1 above "
               "box 64 and at L = 120, 20 for K1 at the v9p config; K2, "
               "K3, their plain versions and ifft2 queued behind a device "
               "sleep)",
         card=card)
    check(k1g_route == "tc" and k1g_err[1] <= TOL_BF16,
          f"K1 with 4 receptor groups at b=128: {k1g_route} {k1g_err}")
    for shape, route_errs in (("b=128", k1_f32_errs),
                              ("the v9p config", k1_v9p["errs"])):
        for route, e in route_errs.items():
            check(e[1] <= TOL_F32, f"K1 {route} in float32 at {shape}: {e}")
    for key, rec in k1_big.items():
        tol = TOL_BF16 if key.startswith("tc") else TOL_F32
        for route, e in rec["rel_err"].items():
            check(e <= tol, f"K1 {route} at b=128, {key}: {e}")
    for Lk, rec in k2_at.items():
        check(rec["route"] == "fft" and rec["rel_err"] <= TOL_F32,
              f"K2 at L={Lk}, b=128: {rec}")
    check(k2_rescore["rel_err"] <= TOL_F32,
          f"K2 at b=48, G=16: {k2_rescore}")
    for Lk, rec in k3_at.items():
        check(rec["route"] == "fft" and rec["rel_err"] <= TOL_F32
              and rec["library_rel_err"] <= TOL_F32,
              f"K3 at L={Lk}, b=128: {rec}")
        check(rec["ms"] < rec["library_ms"],
              f"K3 at L={Lk} is not faster than ifft2: {rec}")
    for route, rec in k1_l120.items():
        check(rec["rel_err"] <= (TOL_BF16 if route == "tc" else TOL_F32),
              f"K1 {route} at L=120, b=128: {rec}")

    # The splat kernel at the sweeps' chunks: the serve config's (128
    # rotations of the 250-residue ligand, box 72) and the v9p checkpoint
    # config's (16 rotations of a 35-residue ligand, box 40).
    splat_at = {name: splat_timed(dev, *shape)
                for name, shape in (("serve", (250, 128, 72, 128, 0)),
                                    ("v9p", (35, 16, 40, 64, 4)))}
    emit("splat_times", splat_at=splat_at,
         library="torch.bmm(U^T, W): voxelize._contract's product alone, "
                 "U and W made before the timing",
         timer="cuda events, mean of 5 after 1 warm-up (the v9p shape 20)",
         card=card)
    for name, rec in splat_at.items():
        check(rec["within_tolerance"],
              f"splat kernel at the {name} chunk against plain: {rec}")

    # ---- phase 3: the slice serves three dock requests ----
    emit("serve_config", rotations_per_request=N_ROT_SERVE,
         cut_from=BENCH_ROTATIONS, grid=L, lig_grid=Ls, top_k=top_k,
         chunk=serve_cfg.rotation_chunk, dtype="bfloat16", coupling_rank=3,
         model="pretrained/synthetic-v9p/best_params.npz")
    fused.launches = fused.launches_tc = fused.launches_tf32 = 0
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
                     "fused_correlate_tf32": fused.launches_tf32,
                     "invz_blockmax_fft": invz_topk.launches_fft}

    def grid_request(name, cfg):
        """One request of ``cfg`` on the bench complex (unclustered), on
        the card with K1's, K2's and K3's launch counts set to 0 just
        before it and read just after, then once more warm (timed, not
        counted), its first K2 and K3 launches held against the plain
        versions, then again on the CPU (top-K values within rtol 1e-3,
        the same top-1).  Emits and returns the record."""
        k2_launch, k3_launch = invz_topk.invz_blockmax, idft.idft_bc
        first = {}

        def k2_spy(*args):
            first.setdefault("k2", args)
            return k2_launch(*args)

        def k3_spy(*args):
            first.setdefault("k3", args)
            return k3_launch(*args)

        p = DockingPipeline(cfg, params=params, device=dev)
        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        idft.launches = idft.launches_fft = 0
        invz_topk.invz_blockmax, idft.idft_bc = k2_spy, k3_spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = p.dock_complex(cplx, cluster=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            invz_topk.invz_blockmax, idft.idft_bc = k2_launch, k3_launch
        rec = dict(grid=cfg.grid_size, engine=cfg.fft_impl,
                   dtype=cfg.dft_dtype, rotations=cfg.num_rotations,
                   chunk=cfg.rotation_chunk, wall_seconds=wall,
                   poses=len(got), top1_score=float(got.scores[0]),
                   k1_launches=fused.launches,
                   k1_tc_launches=fused.launches_tc,
                   k1_tf32_launches=fused.launches_tf32,
                   k2_launches=invz_topk.launches,
                   k2_fft_launches=invz_topk.launches_fft,
                   k3_launches=idft.launches,
                   k3_fft_launches=idft.launches_fft)
        # The same request again, warm (the first one pays the set-up of
        # its grid: cuFFT plans, cuDNN's choice of conv algorithms); these
        # launches are not counted.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.dock_complex(cplx, cluster=False)
        torch.cuda.synchronize()
        rec["warm_seconds"] = time.perf_counter() - t0
        with torch.inference_mode():
            for kernel, checker in (("k2", k2_check), ("k3", k3_check)):
                if kernel in first:
                    err, route = checker(first[kernel])[:2]
                    rec[f"{kernel}_first_launch"] = dict(
                        route=route, max_abs_err=err[0], rel_err=err[1])
        t0 = time.perf_counter()
        want = DockingPipeline(cfg, params=params, device="cpu").dock_complex(
            cplx, cluster=False)
        rec.update(
            cpu_seconds=time.perf_counter() - t0,
            max_rel_diff=float(np.max(np.abs(np.sort(got.scores)
                                             - np.sort(want.scores))
                                      / np.abs(np.sort(want.scores)))),
            values_close=bool(np.allclose(np.sort(got.scores),
                                          np.sort(want.scores), rtol=1e-3,
                                          atol=0)),
            top1_same=(int(got.rot_idx[0]) == int(want.rot_idx[0])
                       and list(got.shifts[0]) == list(want.shifts[0])))
        emit(name, **rec)
        check(len(got) > 0 and bool(np.isfinite(got.scores).all()),
              f"{name}: no or non-finite poses {rec}")
        check(rec["values_close"] and rec["top1_same"],
              f"{name}: the card and the CPU differ {rec}")
        for kernel in first:
            check(rec[f"{kernel}_first_launch"]["rel_err"] <= TOL_F32,
                  f"{name}: first {kernel} launch against plain {rec}")
        return rec

    # Float32 requests at grid 96 (the rep-score and train presets' grid
    # and dtype) and at grid 32 (the smallest grid the fused top-K tail
    # takes), every K2 launch on its FFT kernel; each also on the CPU.
    small_cfg = serve_cfg.replace(num_rotations=N_ROT_SMALL_GRID,
                                  rotation_chunk=SMALL_GRID_CHUNK,
                                  compute_dtype="float32",
                                  dft_dtype="float32")
    k2_grid_requests = {}
    for Lk in (96, 32):
        rec = grid_request(f"dock_request_grid{Lk}",
                           small_cfg.replace(grid_size=Lk))
        check(rec["k2_launches"] > 0
              and rec["k2_fft_launches"] == rec["k2_launches"]
              and rec["k2_first_launch"]["route"] == "fft",
              f"grid-{Lk} request: a K2 launch missed the FFT kernel {rec}")
        k2_grid_requests[Lk] = rec

    # One request at grid 120, not a multiple of 16, where K1 pads L to
    # 128 on the tensor cores (and the top-K runs without K2:
    # 120 % 32 != 0).
    pipe120 = DockingPipeline(serve_cfg.replace(grid_size=120,
                                                num_rotations=256),
                              params=params, device=dev)
    fused.launches = fused.launches_tc = fused.launches_tf32 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses120 = pipe120.dock_complex(cplx)
    torch.cuda.synchronize()
    grid120 = dict(grid=120, rotations=256,
                   wall_seconds=time.perf_counter() - t0,
                   poses=len(poses120),
                   top1_score=float(poses120.scores[0]),
                   k1_launches=fused.launches,
                   k1_tc_launches=fused.launches_tc,
                   k1_tf32_launches=fused.launches_tf32)
    emit("dock_request_grid120", **grid120)
    check(len(poses120) > 0 and bool(np.isfinite(poses120.scores).all()),
          f"grid-120 request: no or non-finite poses {grid120}")
    check(grid120["k1_launches"] > 0
          and grid120["k1_tc_launches"] == grid120["k1_launches"],
          f"grid-120 request: a K1 launch missed the tc kernel {grid120}")
    del pipe120, poses120
    # The same grid in float32 (64 rotations; tf32 K1 padded to 128),
    # on the card and on the CPU.
    grid120_f32 = grid_request("dock_request_grid120_float32",
                               small_cfg.replace(grid_size=120))
    check(grid120_f32["k1_launches"] > 0
          and grid120_f32["k1_tf32_launches"] == grid120_f32["k1_launches"],
          f"float32 grid-120 request: a K1 launch missed the tf32 kernel "
          f"{grid120_f32}")

    # One float32 request at grid 128 with a ligand box of 96, where K1
    # runs its tf32 kernel in 2 x 2 tiles of A; phase 4 runs the same
    # request on the CPU.
    cfg_box96 = serve_cfg.replace(compute_dtype="float32", dft_dtype="float32",
                                  lig_grid_size=96, num_rotations=N_ROT_BOX96,
                                  rotation_chunk=16)
    pipe_box96 = DockingPipeline(cfg_box96, params=params, device=dev)
    fused.launches = fused.launches_tc = fused.launches_tf32 = 0
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
                 k1_tc_launches=fused.launches_tc,
                 k1_tf32_launches=fused.launches_tf32)
    emit("dock_request_box96", **box96)
    check(len(poses_box96) > 0 and bool(np.isfinite(poses_box96.scores).all()),
          f"box-96 request: no or non-finite poses {box96}")
    check(box96["k1_launches"] > 0
          and box96["k1_tf32_launches"] == box96["k1_launches"],
          f"box-96 request: a K1 launch missed the tf32 kernel {box96}")

    # Two float32 requests of 2,048 rotations, where every K1 launch runs
    # the tf32 kernel: the bench config in float32, and the v9p
    # checkpoint's own config.json as it stands (grid 64, box 40, chunk
    # 16, full-rank coupling, as the JAX CLI docks with it).
    with open(os.path.join(V9P_DIR, "config.json")) as f:
        v9p_cfg = DockConfig.from_json(f.read())
    f32_requests = {}
    for name, cfg in (("bench_float32", serve_cfg.replace(
            compute_dtype="float32", dft_dtype="float32")),
                      ("v9p_config", v9p_cfg.replace(
                          num_rotations=N_ROT_SERVE))):
        p = DockingPipeline(cfg, params=params, device=dev)
        fused.launches = fused.launches_tc = fused.launches_tf32 = 0
        invz_topk.launches = invz_topk.launches_fft = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = p.dock_complex(cplx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(config=name, grid=cfg.grid_size,
                   lig_grid=cfg.lig_grid_size or Ls, dtype=cfg.dft_dtype,
                   coupling_rank=cfg.coupling_rank,
                   chunk=cfg.rotation_chunk, rotations=cfg.num_rotations,
                   rotations_cut_from=BENCH_ROTATIONS,
                   k1_launches_at_cut_from=math.ceil(
                       BENCH_ROTATIONS / cfg.rotation_chunk),
                   wall_seconds=wall,
                   rotations_per_second=cfg.num_rotations / wall,
                   poses=len(poses), top1_score=float(poses.scores[0]),
                   k1_launches=fused.launches,
                   k1_tf32_launches=fused.launches_tf32,
                   k1_tc_launches=fused.launches_tc,
                   k2_launches=invz_topk.launches,
                   k2_fft_launches=invz_topk.launches_fft)
        emit("dock_request_float32", **rec)
        f32_requests[name] = rec
        check(len(poses) > 0 and bool(np.isfinite(poses.scores).all()),
              f"{name} request: no or non-finite poses {rec}")
        check(rec["k1_launches"] > 0
              and rec["k1_tf32_launches"] == rec["k1_launches"],
              f"{name} request: a K1 launch missed the tf32 kernel {rec}")
        check(rec["k2_launches"] > 0
              and rec["k2_fft_launches"] == rec["k2_launches"],
              f"{name} request: a K2 launch missed the FFT kernel {rec}")
    del p, poses

    # Two requests uncut at 13,000 rotations on a ligand whose own box
    # is above 64: the full-sweep preset's settings in float32 (tf32 K1)
    # and the serve config in bf16 (tc K1), each after a warm-up request
    # of 256 rotations; every K1 launch on the tensor cores.
    from deeplocalproteindocking_torch.correlate import dft as dft_module
    from deeplocalproteindocking_torch.grids import voxelize
    from deeplocalproteindocking_torch.sweep import resplat
    big = synthetic_complex(**BIG_COMPLEX)
    sweep = PRESETS["full-sweep"]
    full_depth = {}
    k1_launch, seen_k1 = dft_module.fused_correlate, {}

    def k1_spy(*args, **kw):
        """Records each K1 launch's box and keeps the first's arguments."""
        seen_k1.setdefault("boxes", set()).add(tuple(args[0].shape[-2:]))
        seen_k1.setdefault("first", args)
        return k1_launch(*args, **kw)

    sweep_splat = resplat.separable_splat

    def splat_spy(*args, **kw):
        """Counts the sweep's splats."""
        seen_k1["sweep_splats"] = seen_k1.get("sweep_splats", 0) + 1
        return sweep_splat(*args, **kw)

    for name, cfg, route in (
            ("full_sweep_float32", serve_cfg.replace(
                grid_size=sweep.grid_size, num_rotations=sweep.num_rotations,
                rotation_chunk=sweep.rotation_chunk, top_k=sweep.top_k,
                compute_dtype="float32", dft_dtype="float32"), "tf32"),
            ("serve_bf16", serve_cfg.replace(
                num_rotations=BENCH_ROTATIONS), "tc")):
        p = DockingPipeline(cfg, params=params, device=dev)
        box = auto_ligand_grid(big.ligand.centered().typed().coords,
                               cfg.resolution, cfg.sigma,
                               p._receptive_field(), cfg.grid_size)
        check(box > 64, f"{name}: the ligand's box is {box}, not above 64")
        DockingPipeline(cfg.replace(num_rotations=256), params=params,
                        device=dev).dock_complex(big)
        seen_k1.clear()
        dft_module.fused_correlate = k1_spy
        resplat.separable_splat = splat_spy
        try:
            fused.launches = fused.launches_tc = fused.launches_tf32 = 0
            invz_topk.launches = invz_topk.launches_fft = 0
            voxelize.launches = voxelize.plain_calls = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            poses = p.dock_complex(big)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = (fused.launches, fused.launches_tc, fused.launches_tf32,
                 invz_topk.launches, invz_topk.launches_fft)
        finally:
            dft_module.fused_correlate = k1_launch
            resplat.separable_splat = sweep_splat
        with torch.inference_mode():
            first_err, first_route, _ = k1_check(seen_k1["first"])
        rec = dict(config=name, grid=cfg.grid_size, lig_grid=box,
                   k1_boxes=sorted(seen_k1["boxes"]),
                   ligand_residues=BIG_COMPLEX["n_res_lig"],
                   dtype=cfg.dft_dtype, chunk=cfg.rotation_chunk,
                   rotations=cfg.num_rotations, wall_seconds=wall,
                   rotations_per_second=cfg.num_rotations / wall,
                   poses=len(poses), top1_score=float(poses.scores[0]),
                   k1_launches=n[0], k1_tc_launches=n[1],
                   k1_tf32_launches=n[2],
                   k2_launches=n[3], k2_fft_launches=n[4],
                   sweep_splats=seen_k1.get("sweep_splats", 0),
                   splat_launches=voxelize.launches,
                   splat_plain_calls=voxelize.plain_calls,
                   k1_first_launch=dict(route=first_route,
                                        max_abs_err=first_err[0],
                                        rel_err=first_err[1]))
        emit("dock_request_full_depth", **rec)
        full_depth[name] = rec
        n_route = rec[f"k1_{route}_launches"]
        check(len(poses) > 0 and bool(np.isfinite(poses.scores).all()),
              f"{name}: no or non-finite poses {rec}")
        check(n_route == rec["k1_launches"] == math.ceil(
            cfg.num_rotations / cfg.rotation_chunk),
              f"{name}: a K1 launch missed the {route} kernel {rec}")
        check(rec["k2_fft_launches"] == rec["k2_launches"] > 0,
              f"{name}: a K2 launch missed the FFT kernel {rec}")
        check(rec["sweep_splats"] == rec["k1_launches"]
              and rec["splat_launches"] >= rec["sweep_splats"]
              and rec["splat_plain_calls"] == 0,
              f"{name}: a splat missed its kernel {rec}")
        check(rec["k1_boxes"] == [(box, box)],
              f"{name}: K1 saw boxes {rec['k1_boxes']}, not ({box}, {box})")
        check(first_err[1] <= (TOL_F32 if route == "tf32" else TOL_BF16),
              f"{name}: first K1 launch against plain {first_err}")
        del p, poses, seen_k1["first"]
        torch.cuda.empty_cache()

    # ---- phase 4: card against CPU at grid 64, float32 and bf16 ----
    cmp_cfg = serve_cfg.replace(grid_size=64, compute_dtype="float32",
                                dft_dtype="float32", num_rotations=256)
    for dtype, rtol in (("float32", 1e-3), ("bfloat16", TOL_BF16)):
        cfg = cmp_cfg.replace(compute_dtype=dtype, dft_dtype=dtype)
        results = {}
        for where in ("cuda", "cpu"):
            p = DockingPipeline(cfg, params=params, device=where)
            n0, tc0 = fused.launches, fused.launches_tc
            tf0 = fused.launches_tf32
            k2_0, fft0 = invz_topk.launches, invz_topk.launches_fft
            t0 = time.perf_counter()
            results[where] = p.dock_complex(cplx, cluster=False)
            results[where + "_s"] = time.perf_counter() - t0
            results[where + "_k1"] = (fused.launches - n0,
                                      fused.launches_tc - tc0,
                                      fused.launches_tf32 - tf0)
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
             k1_tf32_launches=results["cuda_k1"][2],
             k2_launches=results["cuda_k2"][0],
             k2_fft_launches=results["cuda_k2"][1], top1_same=top1_ok,
             top1_cuda=[int(g.rot_idx[0])] + [int(v) for v in g.shifts[0]],
             top1_cpu=[int(w.rot_idx[0])] + [int(v) for v in w.shifts[0]])
        check(vals_ok, f"{dtype}: top-K values differ between card and CPU")
        n_k1, n_tc, n_tf32 = results["cuda_k1"]
        check(n_k1 > 0 and (n_tc, n_tf32) == ((n_k1, 0) if dtype == "bfloat16"
                                              else (0, n_k1)),
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

    # Float32 dft_pallas docks at grids 96, 80, 112 and 32 (a half-full
    # last z run at 80 and 112), every K3 launch on its FFT kernel; each
    # also on the CPU.
    k3_fft_docks = {}
    for Lk in (96, 80, 112, 32):
        rec = grid_request(f"screen_dock_grid{Lk}", small_cfg.replace(
            fft_impl="dft_pallas", grid_size=Lk))
        check(rec["k3_launches"] > 0
              and rec["k3_fft_launches"] == rec["k3_launches"]
              and rec["k3_first_launch"]["route"] == "fft",
              f"grid-{Lk} dft_pallas dock: a K3 launch missed the FFT "
              f"kernel {rec}")
        k3_fft_docks[Lk] = rec

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
    fused.launches = fused.launches_tc = fused.launches_tf32 = 0
    invz_topk.launches = invz_topk.launches_fft = 0
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

    # ---- phase 9: training at the v9p config's full width ----
    train = training(dev)
    emit("training", card=card, **train)
    check_training(train)
    train_launches = train["launches"]
    train_plain = train["kernels_vs_plain"]

    # ---- phase 10: the CLI, full-depth requests included ----
    clir = cli_commands(dev)
    emit("cli", card=card, launches=clir["launches"],
         kernels_vs_plain=clir["kernels_vs_plain"],
         seconds={k: c["seconds"] for k, c in clir["commands"].items()})

    # ---- phase 11: grids above 128^3 and the resample sweep ----
    t11 = time.perf_counter()
    p11 = large_grids_and_resample(dev, params)
    emit("large_grids_and_resample", card=card,
         seconds=time.perf_counter() - t11, launches=p11["launches"])
    check_large_grids(p11)
    p11_block = p11["block_vs_kernels"]["launches_dft_fused"]
    p11_approx = p11["topk_approx"]["launches_approx"]

    # ---- phase 12: the multi-GPU layer ----
    p12 = multi_gpu(dev)
    emit("multi_gpu", card=card, **p12)
    check_multi_gpu(p12)

    # ---- phase 13: the JAX package's Orbax checkpoints ----
    t13 = time.perf_counter()
    p13 = checkpoints(dev)
    emit("checkpoints", card=card, seconds=time.perf_counter() - t13,
         reduced=dict(rotations=f"{CKPT_ROTATIONS} per family dock "
                                f"(cut from 256 for the CPU half)"),
         **p13)
    check_checkpoints(p13)

    def p12_count(config, name):
        """Phase 12's launches of counter ``name`` in the sharded dock of
        ``config``, one count per rank."""
        return [n[name] for n in p12["docks"][config]["launches_per_rank"]]

    def p12_err(key):
        return [r[key]["max_abs_err"] for r in p12["kernels_vs_plain"]]

    def p11_count(name, **extra):
        """Phase 11's launches of counter ``name``: 0 on every block and
        resample request; ``extra`` the kernel-path requests beside."""
        return dict(block_and_resample=p11["launches"][name], **extra)

    def cli_count(name):
        """Phase 10's launches of counter ``name``, by command."""
        return {k: c["launches"][name] for k, c in clir["commands"].items()
                if c["launches"][name]}

    def band_count(name):
        return sum(n[name] for n in band_launches.values())

    def band_errs(prefix):
        """Phase 7's max abs errors against plain, by row and launch."""
        return {row: {n: e["max_abs_err"] for n, e in errs.items()
                      if n.startswith(prefix)}
                for row, errs in band["kernels_vs_plain"].items()}

    src = "deeplocalproteindocking_torch/csrc/"
    tpu = "deeplocalproteindocking_tpu/correlate/"

    def box_summary(rec):
        """A K1 route's numbers at one box above 64 (b = 128, L = 128)."""
        return dict(shape=rec["shape"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                    bound_ms=rec["bound"]["bound_ms"],
                    bound_by=rec["bound"]["bound_by"])
    print(json.dumps({"kernels": [
        {"name": "fused_correlate", "route": "cuda",
         "source": src + "fused_correlate_tc.cu",
         "sources": {"tc": src + "fused_correlate_tc.cu",
                     "tf32": src + "fused_correlate_tf32.cu"},
         "replaces": tpu + "pallas_fused.py:57",
         "launches": main_launches["fused_correlate"],
         "launches_by_route": {
             "tc": main_launches["fused_correlate_tc"],
             "tf32": main_launches["fused_correlate_tf32"]},
         "launches_band100": {"tc": band_count("k1_tc"),
                              "tf32": band_count("k1_tf32")},
         "max_abs_err": errs["k1_bfloat16"][0],
         "max_abs_err_float32": errs["k1_float32"][0],
         "max_abs_err_band100": band_errs("k1"),
         "launches_batched": {"tc": batched_launches["k1_tc"],
                              "all": batched_launches["k1"],
                              "h_groups": phase8["batched"]["k1_groups"]},
         "max_abs_err_groups": {
             "tc_G4_b128": k1g_err[0], "tf32_float32_G4_b8":
             errs["k1_f32_G4"][0],
             "batched_first_launch": phase8["batched"]["k1_first"][
                 "max_abs_err"]},
         "launches_train": {"tc": train_launches["k1_tc"],
                            "tf32": train_launches["k1_tf32"],
                            "all": train_launches["k1"]},
         "launches_cli": {"tc": cli_count("k1_tc"),
                          "tf32": cli_count("k1_tf32")},
         "launches_phase11": p11_count(
             "k1", dft_fused_grid128_tf32=p11_block["k1_tf32"],
             topk_approx_tc=p11_approx["k1_tc"]),
         "launches_phase12_per_rank": {
             "tc": p12_count("bench_bf16", "k1_tc"),
             "tf32": p12_count("v9p_config", "k1_tf32")},
         "max_abs_err_phase12_per_rank": p12_err("bench_bf16_k1"),
         "ms_groups": k1_g4_ms, "ms_groups_turns": k1_turns,
         "bound_ms_groups": bounds["k1_G4"]["bound_ms"],
         "tolerance": f"bf16 {TOL_BF16}, float32 {TOL_F32} x max|plain|",
         "launches_full_depth_box_above_64":
             full_depth["serve_bf16"]["k1_tc_launches"],
         "max_abs_err_full_depth_first_launch":
             full_depth["serve_bf16"]["k1_first_launch"]["max_abs_err"],
         "max_abs_err_above_box64": {
             k: errs[f"k1_bf16_box{k[3:]}_random"][0]
             for k in ("box72", "box96", "box128")},
         "above_box64": {k[3:]: box_summary(v) for k, v in k1_big.items()
                         if k.startswith("tc_")},
         "launches_grid120_request": grid120["k1_tc_launches"],
         "max_abs_err_L120_b2": errs["k1_bf16_L120"][0],
         "at_L120": box_summary(k1_l120["tc"]),
         "max_abs_err_L120_b128": k1_l120["tc"]["max_abs_err"],
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": bounds["k1"]["bound_ms"],
         "bound_by": bounds["k1"]["bound_by"], "library_ms": None},
        {"name": "fused_correlate_tf32", "route": "cuda",
         "source": src + "fused_correlate_tf32.cu",
         "replaces": tpu + "pallas_fused.py:57",
         "launches": sum(r["k1_tf32_launches"]
                         for r in f32_requests.values()),
         "launches_path": "two float32 dock requests of 2,048 rotations "
                          "(phase 3): the bench config and the v9p "
                          "checkpoint's config",
         "launches_by_request": {name: r["k1_tf32_launches"]
                                 for name, r in f32_requests.items()},
         "launches_band100": band_count("k1_tf32"),
         "launches_dock_batch_float32":
             phase8["card_vs_cpu"]["dft_fused"]["launches"]["k1_tf32"],
         "launches_train": train_launches["k1_tf32"],
         "max_abs_err_train_first_mining_launch":
             train_plain["mine_k1"]["max_abs_err"],
         "launches_cli": cli_count("k1_tf32"),
         "launches_phase11": p11_count(
             "k1_tf32", dft_fused_grid128=p11_block["k1_tf32"]),
         "launches_phase12_per_rank": p12_count("v9p_config", "k1_tf32"),
         "max_abs_err_phase12_per_rank": p12_err("v9p_config_k1"),
         "max_abs_err_cli_full_depth_v9p_first_launch":
             clir["kernels_vs_plain"]["dock_v9p_k1"]["max_abs_err"],
         "max_abs_err": k1_f32_errs["tf32"][0],
         "max_abs_err_b8": errs["k1_float32"][0],
         "max_abs_err_G4_b8": errs["k1_f32_G4"][0],
         "max_abs_err_band100": band_errs("k1")["shape_local"],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k1_f32_ms["tf32"], "ms_turns": k1_f32_turns,
         "plain_ms": k1_f32_plain_ms,
         "v9p_config": {"shape": k1_v9p["shape"], "ms": k1_v9p["ms"],
                        "plain_ms": k1_v9p["plain_ms"]},
         "launches_box96_request": box96["k1_tf32_launches"],
         "launches_full_depth_box_above_64":
             full_depth["full_sweep_float32"]["k1_tf32_launches"],
         "max_abs_err_full_depth_first_launch":
             full_depth["full_sweep_float32"]["k1_first_launch"][
                 "max_abs_err"],
         "max_abs_err_above_box64": {
             k: errs[f"k1_f32_box{k[3:]}_random"][0]
             for k in ("box72", "box96", "box128")},
         "above_box64": {k[5:]: box_summary(v) for k, v in k1_big.items()
                         if k.startswith("tf32_")},
         "launches_grid120_float32_request":
             grid120_f32["k1_tf32_launches"],
         "max_abs_err_L120_b2": errs["k1_f32_L120"][0],
         "at_L120": box_summary(k1_l120["tf32"]),
         "max_abs_err_L120_b128": k1_l120["tf32"]["max_abs_err"],
         "bound_ms": bounds["k1_float32"]["bound_ms"],
         "bound_by": bounds["k1_float32"]["bound_by"], "library_ms": None},
        {"name": "invz_blockmax_fft", "route": "cuda",
         "source": src + "invz_blockmax_fft.cu",
         "replaces": tpu + "pallas_invz_topk.py:54",
         "launches": main_launches["invz_blockmax_fft"],
         "launches_band100": band_count("k2_fft"),
         "launches_batched": batched_launches["k2_fft"],
         "launches_train": train_launches["k2_fft"],
         "max_abs_err_train_first_mining_launch":
             train_plain["mine_k2"]["max_abs_err"],
         "launches_cli": cli_count("k2_fft"),
         "launches_phase11": p11_count(
             "k2_fft", dft_fused_grid128=p11_block["k2_fft"],
             topk_approx=p11_approx["k2_fft"]),
         "launches_phase12_per_rank": {
             c: p12_count(c, "k2_fft") for c in p12["docks"]},
         "max_abs_err_phase12_per_rank": {
             c: p12_err(f"{c}_k2") for c in p12["docks"]},
         "max_abs_err_cli_full_depth_v9p_first_launch":
             clir["kernels_vs_plain"]["dock_v9p_k2"]["max_abs_err"],
         **{f"launches_grid{Lk}_request": rec["k2_fft_launches"]
            for Lk, rec in k2_grid_requests.items()},
         **{f"max_abs_err_grid{Lk}_first_launch":
            rec["k2_first_launch"]["max_abs_err"]
            for Lk, rec in k2_grid_requests.items()},
         "max_abs_err": errs["k2_fft"][0],
         **{f"max_abs_err_L{Lk}": errs[f"k2_fft_L{Lk}"][0]
            for Lk in (32, 64, 96)},
         "max_abs_err_b128": k2_at[128]["max_abs_err"],
         "max_abs_err_band100": band_errs("k2"),
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k2_at[128]["ms"], "plain_ms": k2_at[128]["plain_ms"],
         **{f"at_L{Lk}": {k: (v["bound_ms"] if k == "bound" else v)
                          for k, v in k2_at[Lk].items()
                          if k in ("ms", "plain_ms", "max_abs_err",
                                   "bound")}
            for Lk in (32, 96)},
         "rescore_b48_G16": {k: (v["bound_ms"] if k == "bound" else v)
                             for k, v in k2_rescore.items()
                             if k in ("ms", "plain_ms", "max_abs_err",
                                      "bound")},
         "bound_ms": bounds["k2"]["bound_ms"],
         "bound_by": bounds["k2"]["bound_by"], "library_ms": None},
        {"name": "idft_fft", "route": "cuda",
         "source": src + "idft_fft.cu",
         "replaces": tpu + "pallas_idft.py:34",
         "launches": screen_fft_launches,
         "launches_path": "the screening service at grid 128 (phase 5)",
         "launches_band100": band_count("k3_fft"),
         "launches_cli": cli_count("k3_fft"),
         "launches_phase11": p11_count("k3_fft"),
         "max_abs_err_cli_screen_first_launch":
             clir["kernels_vs_plain"]["screen_k3"]["max_abs_err"],
         "launches_docks": {f"grid{Lk}": rec["k3_fft_launches"]
                            for Lk, rec in k3_fft_docks.items()},
         "max_abs_err_docks_first_launch": {
             f"grid{Lk}": rec["k3_first_launch"]["max_abs_err"]
             for Lk, rec in k3_fft_docks.items()},
         "max_abs_err": errs["k3"][0],
         "max_abs_err_b8": {k.split("_")[-1]: errs[k][0]
                            for k in K3_RANDOM_CHECKS},
         "max_abs_err_b128": k3_at[128]["max_abs_err"],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k3_at[128]["ms"], "plain_ms": k3_at[128]["plain_ms"],
         **{f"at_L{Lk}": {k: (v["bound_ms"] if k == "bound" else v)
                          for k, v in k3_at[Lk].items()
                          if k in ("ms", "plain_ms", "library_ms",
                                   "max_abs_err", "bound")}
            for Lk in (16, 32, 48, 80, 96, 112)},
         "bound_ms": bounds["k3"]["bound_ms"],
         "bound_by": bounds["k3"]["bound_by"],
         "library_ms": k3_at[128]["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
