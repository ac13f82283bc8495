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
   and at box 64, and the SIMT kernel in float32 and in bf16 at box 72;
   K2 with a real translation mask, drill-down top-K, K3 on the summed
   spectrum of the ``dft`` engine's forward half), plus the time of
   each kernel and its plain version at the full batch of 128 (K1 also
   on its SIMT kernel in bf16; K2 on its FFT kernel at L = 128 on the
   bench complex's D and at L = 64, and on its dense kernel at L = 96;
   both K2 kernels, timed in turns, held against plain at b = 128 and at
   the rescore's b = 48 with 16 bias groups; the library call
   ``torch.fft.ifft2`` that computes K3's function), with each kernel's
   bound at those shapes: the bytes its function must move or the
   operations of that function done as FFTs, whichever takes longer;
3. the slice: the v9p hybrid model (exported weights, rank-3 coupling
   folded into the last conv, bf16, grid 128, top-K 64, chunk 128)
   serves three ``DockingPipeline.dock`` requests, proving through the
   launch counters that K1 (every launch on the tensor-core kernel) and
   K2 (every launch on the FFT kernel) ran in each; then one request at
   grid 96 runs K2's dense kernel;
4. card against CPU: one request at grid 64, 256 rotations, once on CUDA
   tensors (kernels) and once on CPU tensors (plain versions), in
   float32 (top-K values within rtol 1e-3 and the same top-1 pose) and
   in bf16 (top-K values within rtol 2e-2);
5. the screening slice: one ``DockingService`` on the same model with
   ``fft_impl="dft_pallas"`` docks the receptor of seed 0 against the
   ligands of seeds 0-2 (``dock`` then ``rescore(top=16, nrot=48)``
   each; the first also ``refine(steps=30)`` through the cached
   engine), proving that K3 ran in every stage; then one ``rescore`` on
   the main-path ``dft_fused`` engine, whose K2 must see 16 bias groups;
6. card against CPU for that path: dock -> rescore -> refine at
   float32, grid 64, 256 rotations, ``dft_pallas``.

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
BENCH_ROTATIONS = 13000
SEEDS = (0, 1, 2)
TOL_F32 = 1e-4              # max |kernel - plain| <= TOL * max |plain|
TOL_BF16 = 2e-2
# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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

    def k1_random_inputs(b, box, C=3, seed=0):
        """K1's bf16 arguments from random volumes and receptor grid."""
        g = torch.Generator().manual_seed(seed)
        corr = get_correlator(L, box, "bfloat16", dev)
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

    def k1_check(args):
        """((max abs err, rel err), route, D) of one K1 launch, held
        against the plain version."""
        X, Y = args[0].shape[-2:]
        route = fused.k1_route(args[0].dtype, X, Y, L, L, L, L)
        tc0 = fused.launches_tc
        got = fused.fused_correlate(*args)
        torch.cuda.synchronize()
        check(fused.launches_tc - tc0 == int(route == "tc"),
              f"K1 at box {X} did not launch its {route} kernel")
        want = fused.fused_correlate_reference(*args)
        e = [rel_err(g, w) for g, w in zip(got, want)]
        return (max(a for a, _ in e), max(r for _, r in e)), route, got

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
        f0 = invz_topk.launches_fft
        got = invz_topk.invz_blockmax(*Dk, corr.MzRe, corr.MzIm, bk)
        torch.cuda.synchronize()
        route = "fft" if invz_topk.launches_fft > f0 else "dense"
        want = invz_topk.invz_blockmax_reference(*Dk, corr.MzRe, corr.MzIm,
                                                 bk)
        check(bool((got[:, 3, 0, 5] == float("-inf")).all()),
              f"K2 at L={Lk}: a fully masked run is not -inf")
        return rel_err(got, want), route

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
        f0 = invz_topk.launches_fft
        bk = invz_topk.invz_blockmax(D[0], D[1], corr32.MzRe, corr32.MzIm,
                                     bias)
        torch.cuda.synchronize()
        check(invz_topk.launches_fft == f0 + 1,
              "K2 at L=128 did not launch its FFT kernel")
        br = invz_topk.invz_blockmax_reference(D[0], D[1], corr32.MzRe,
                                               corr32.MzIm, bias)
        errs["k2_fft"] = rel_err(bk, br)
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
        k3_got = idft.idft_bc(*k3_args)
        torch.cuda.synchronize()
        errs["k3"] = rel_err(k3_got, idft.idft_bc_reference(*k3_args))
        del k3_args, k3_got
    emit("kernels_vs_plain", batch=8, L=L, Ls=Ls, C=3, K=L // 2 + 1,
         k1_float32_max_abs_err=errs["k1_float32"][0],
         k1_float32_rel_err=errs["k1_float32"][1],
         k1_bf16_max_abs_err=errs["k1_bfloat16"][0],
         k1_bf16_rel_err=errs["k1_bfloat16"][1],
         k1_more={k: dict(rel_err=v[1], max_abs_err=v[0], batch=2)
                  for k, v in errs.items() if k.startswith("k1_bf16_")},
         k1_routes=routes,
         k2_fft_max_abs_err=errs["k2_fft"][0],
         k2_fft_rel_err=errs["k2_fft"][1],
         k2_fft_L64_rel_err=errs["k2_fft_L64"][1],
         k2_dense_L96_rel_err=errs["k2_dense_L96"][1], k2_routes=k2_routes,
         drill_topk_rel_err=drill_err[1],
         drill_index_rel_err=drill_idx_err[1],
         k3_max_abs_err=errs["k3"][0], k3_rel_err=errs["k3"][1],
         tolerance={"float32": TOL_F32, "bfloat16": TOL_BF16},
         masked_fraction=1.0 - mask.float().mean().item())
    check(errs["k1_float32"][1] <= TOL_F32, f"K1 float32 {errs}")
    for key in ("k1_bfloat16", "k1_bf16_box40", "k1_bf16_box64_random",
                "k1_bf16_box72_random"):
        check(errs[key][1] <= TOL_BF16, f"K1 {key} {errs}")
    check(routes == {"k1_float32": "simt", "k1_bfloat16": "tc",
                     "k1_bf16_box40": "tc", "k1_bf16_box64_random": "tc",
                     "k1_bf16_box72_random": "simt"}, f"K1 routes {routes}")
    for key in ("k2_fft", "k2_fft_L64", "k2_dense_L96"):
        check(errs[key][1] <= TOL_F32, f"K2 {key} {errs}")
    check(k2_routes == {"k2_fft_L64": "fft", "k2_dense_L96": "dense"},
          f"K2 routes {k2_routes}")
    check(errs["k3"][1] <= TOL_F32, f"K3 {errs}")
    check(drill_err[1] <= 1e-5 and drill_idx_err[1] <= 1e-5,
          f"drill_topk vs exact_block_topk: {drill_err} {drill_idx_err}")

    def k2_both_routes(args):
        """Both K2 kernels on ``args`` (bias ``[G, X, Y, Z]``), timed in
        turns (dense, FFT, FFT, dense) on the same inputs, then each
        output held against the plain version.  Returns (turns, plain ms,
        {route: (max abs err, rel err)}, bound)."""
        launch = {"dense": invz_topk._launch_dense,
                  "fft": invz_topk._launch_fft}
        turns = {"dense": [], "fft": []}
        for route in ("dense", "fft", "fft", "dense"):
            turns[route].append(cuda_time_ms(lambda: launch[route](*args)))
        plain_ms = cuda_time_ms(
            lambda: invz_topk.invz_blockmax_reference(*args))
        want = invz_topk.invz_blockmax_reference(*args)
        route_errs = {r: rel_err(launch[r](*args), want) for r in launch}
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
        bounds = {"k1": bound(
            sum(t.numel() * t.element_size() for t in args16)
            + 2 * D16[0].numel() * 4,
            (C * (X + L) * fft_flops(L) + 8 * C * L * L
             + 2 * L * fft_flops(L)) * K * b, "bfloat16")}
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
        k3_args = k3_inputs(128)
        k3_ms = cuda_time_ms(lambda: idft.idft_bc(*k3_args))
        k3_plain_ms = cuda_time_ms(lambda: idft.idft_bc_reference(*k3_args))

        # The one PyTorch call that computes K3's function; never used by
        # the port, only its yardstick.
        def k3_library():
            return torch.fft.ifft2(torch.complex(k3_args[0], k3_args[1]),
                                   dim=(1, 2)).real

        k3_library_ms = cuda_time_ms(k3_library)
        k3_library_err = rel_err(k3_library(), idft.idft_bc(*k3_args))
        # K3's function as FFTs: one along kx and one along ky per line.
        nvol = k3_args[0].numel()
        bounds["k3"] = bound((3 * nvol + 4 * L * L) * 4,
                             2 * (nvol // L) * fft_flops(L), "float32")
        del k3_args
    emit("kernel_times", batch=128, dtype="bfloat16", Ls=Ls, k1_ms=k1_ms,
         k1_simt_ms=k1_simt_ms, k1_plain_ms=k1_plain_ms,
         k2_fft_ms=k2_fft_ms, k2_dense_ms=k2_dense_ms, k2_turns=k2_turns,
         k2_plain_ms=k2_plain_ms, k2_dtype="float32",
         k2_rel_err={r: e[1] for r, e in k2_errs.items()},
         k2_rescore=dict(batch=48, groups=16, turns=k2g_turns,
                         plain_ms=k2g_plain_ms, bound=k2g_bound,
                         rel_err={r: e[1] for r, e in k2g_errs.items()}),
         k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, k3_library_ms=k3_library_ms,
         k3_library_rel_err=k3_library_err[1], k3_dtype="float32",
         k3_library="torch.fft.ifft2(torch.complex(Ere, Eim), "
                    "dim=(1, 2)).real",
         bounds=bounds, peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                               "flops_per_s": PEAK_FLOPS},
         timer="cuda events, mean of 5 after 1 warm-up", card=card)
    check(k3_library_err[1] <= TOL_F32,
          f"torch.fft.ifft2 is not K3's function: {k3_library_err}")
    for shape, route_errs in (("b=128", k2_errs), ("b=48, G=16", k2g_errs)):
        for route, e in route_errs.items():
            check(e[1] <= TOL_F32, f"K2 {route} at {shape}: {e}")

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

    idft.launches = 0
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
    emit("screen_service", dock_stats=dock_stats, stats=svc.stats,
         k3_launches=screen_launches)
    check(dock_stats == {"hits": 2, "misses": 1} and svc.misses == 1
          and svc.stats["entries"] == 1,
          f"service cache: docks {dock_stats}, all {svc.stats}")

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
    for where in ("cuda", "cpu"):
        p = DockingPipeline(cmp6_cfg, params=params, device=where)
        t0 = time.perf_counter()
        d = p.dock(receptor, cplx.ligand, cluster=False)
        r = p.rescore(receptor, cplx.ligand, d, top=4, nrot=16)
        f = p.refine(receptor, cplx.ligand, PoseSet(*(x[:4] for x in r[:5])),
                     steps=5)
        out6[where] = (d, r, f, time.perf_counter() - t0)
    (gd, gr, gf, gs), (wd, wr, wf, ws) = out6["cuda"], out6["cpu"]

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
         rescored_top1_cpu=[int(v) for v in wr.shifts[0]])
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
         "max_abs_err": errs["k1_bfloat16"][0],
         "max_abs_err_float32": errs["k1_float32"][0],
         "tolerance": f"bf16 {TOL_BF16}, float32 {TOL_F32} x max|plain|",
         "ms": k1_ms, "simt_ms": k1_simt_ms, "plain_ms": k1_plain_ms,
         "bound_ms": bounds["k1"]["bound_ms"],
         "bound_by": bounds["k1"]["bound_by"], "library_ms": None},
        {"name": "invz_blockmax_fft", "route": "cuda",
         "source": src + "invz_blockmax_fft.cu",
         "replaces": tpu + "pallas_invz_topk.py:54",
         "launches": main_launches["invz_blockmax_fft"],
         "max_abs_err": errs["k2_fft"][0],
         "max_abs_err_L64": errs["k2_fft_L64"][0],
         "max_abs_err_b128": k2_errs["fft"][0],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k2_fft_ms, "plain_ms": k2_plain_ms,
         "bound_ms": bounds["k2"]["bound_ms"],
         "bound_by": bounds["k2"]["bound_by"], "library_ms": None},
        {"name": "invz_blockmax", "route": "cuda",
         "source": src + "invz_blockmax.cu",
         "replaces": tpu + "pallas_invz_topk.py:54",
         "launches": dense_path["k2_launches"],
         "launches_path": "one dock request at grid 96 (K2's dense route)",
         "max_abs_err": errs["k2_dense_L96"][0],
         "max_abs_err_b128": k2_errs["dense"][0],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k2_dense_ms, "plain_ms": k2_plain_ms,
         "bound_ms": bounds["k2"]["bound_ms"],
         "bound_by": bounds["k2"]["bound_by"], "library_ms": None},
        {"name": "idft_bc", "route": "cuda",
         "source": src + "idft_bc.cu",
         "replaces": tpu + "pallas_idft.py:34",
         "launches": screen_launches,
         "max_abs_err": errs["k3"][0],
         "tolerance": f"float32 {TOL_F32} x max|plain|",
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": bounds["k3"]["bound_ms"],
         "bound_by": bounds["k3"]["bound_by"],
         "library_ms": k3_library_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
