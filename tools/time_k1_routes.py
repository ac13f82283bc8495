#!/usr/bin/env python3
"""K1's routes timed on one card, for the package under a given root.

    python3 tools/time_k1_routes.py [ROOT] [small|tiles]   # from the repo root

``ROOT`` (default: the repository) is the directory that holds the
``deeplocalproteindocking_torch`` package to time: point it at an
unpacked older commit (``git archive``) to compare two versions, and run
them in turns (older, newer, newer, older) in one call on one card.
Inputs are random (K1's time does not depend on the values), made on
the card from a seed: b rotations, receptor spectra and ligand spectra
of C channels, the correlator's twiddles.  Each route is launched as the
main path launches it (the correlator's kept twiddle layouts).

``small``: boxes up to 64, the shapes every shipped config runs: the
bench shape (b = 128, L = 128, box 32, C = 3) in bf16 (tc) and float32
(tf32), the v9p config's (b = 16, L = 64, box 40, C = 16) in float32,
and the full-sweep config's chunk (b = 128, L = 128, box 40 and 48,
C = 16) in float32, each full-sweep box first held against the plain
version at b = 2; each timed three times.  ``tiles`` adds boxes 71 (an odd box: the tc
kernel loads A with plain loads), 72, 96 and 128 at b = 128, L = 128,
C = 3 on both tensor-core routes, each first held against the plain
version at b = 2 (max |kernel - plain| / max |plain|), then timed twice;
a box the package routes elsewhere (a tree from before those boxes ran
on the tensor cores) is reported with its route and not timed.
Both modes then time grids that are not a multiple of 16 (b = 128):
L = 120 (the grid-120 request's bf16 box 32 and a float32 box 72) and
L = 98 (2 mod 4: D's rows 8-byte aligned only; box 40 in both dtypes),
each launched through ``fused_correlate`` as the package routes it (the
tensor cores padded to 128 / 112 on a tree that pads, the SIMT kernel
on an older one), held against the plain version at b = 2 and timed
twice.
Times are CUDA events over 3 launches after one warm-up (20 at the v9p
shape).  Prints one JSON line with the card's name.
"""
import json
import os
import sys
import time

import torch


def ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches after one."""
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


def rel(got, want):
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    mode = sys.argv[2] if len(sys.argv) > 2 else "small"
    if mode not in ("small", "tiles"):
        sys.exit(f"usage: time_k1_routes.py [ROOT] [small|tiles], got {mode}")
    if not torch.cuda.is_available():
        sys.exit("time_k1_routes.py: no CUDA card")
    sys.path.insert(0, root)
    from deeplocalproteindocking_torch import _build
    from deeplocalproteindocking_torch.correlate import fused
    from deeplocalproteindocking_torch.correlate.dft import get_correlator

    dev = torch.device("cuda")

    def inputs(b, L, box, C, dtype_name, seed=0):
        """(correlator, K1's arguments) from random spectra."""
        g = torch.Generator(device=dev).manual_seed(seed)
        corr = get_correlator(L, box, dtype_name, dev)
        K = L // 2 + 1
        A = [torch.randn((b, K, C, box, box), generator=g, device=dev)
             .to(corr.dtype) for _ in range(2)]
        H = [torch.randn((K, C, L, L), generator=g, device=dev)
             .to(corr.dtype) for _ in range(2)]
        return corr, tuple(A + H) + (
            corr.WyRe, corr.WyIm, corr.WxRe, corr.WxIm, corr.UxRe,
            corr.UxIm, corr.UyRe, corr.UyIm)

    def launcher(corr, args):
        """The tensor-core launch of ``args`` with ``corr``'s layouts."""
        b, K, C, X, Y = args[0].shape
        L = args[8].shape[1]
        dims = (b, K, C, X, Y, L, L, L, L)
        D = [torch.empty((b, K, L, L), device=dev) for _ in range(2)]
        launch = (fused._launch_tc if args[0].dtype == torch.bfloat16
                  else fused._launch_tf32)
        return lambda: launch(args[:4] + tuple(corr.k1_layouts), dims, *D)

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    out = dict(root=root, mode=mode, build_seconds=time.perf_counter() - t0,
               device=torch.cuda.get_device_name(0))
    with torch.inference_mode():
        small = {}
        for key, (b, L, box, C, name, reps) in {
                "tc_bench": (128, 128, 32, 3, "bfloat16", 3),
                "tf32_bench": (128, 128, 32, 3, "float32", 3),
                "tf32_v9p": (16, 64, 40, 16, "float32", 20),
                "tf32_fullsweep_box40": (128, 128, 40, 16, "float32", 3),
                "tf32_fullsweep_box48": (128, 128, 48, 16, "float32", 3),
        }.items():
            if "fullsweep" in key:
                corr, args = inputs(2, L, box, C, name, seed=box)
                small[key + "_rel_err"] = rel(
                    fused.fused_correlate(*args),
                    fused.fused_correlate_reference(*args))
            corr, args = inputs(b, L, box, C, name)
            fn = launcher(corr, args)
            small[key] = [ms(fn, reps) for _ in range(3)]
            del args, fn
            torch.cuda.empty_cache()
        out["small"] = small
        if mode == "tiles":
            tiles = {}
            for name, route in (("bfloat16", "tc"), ("float32", "tf32")):
                for box in (71, 72, 96, 128) if route == "tc" else (72, 96,
                                                                     128):
                    taken = fused.k1_route(getattr(torch, name), box, box,
                                           128, 128, 128, 128)
                    if taken != route:      # an older tree: not on this route
                        tiles[f"{route}_box{box}"] = dict(route=taken)
                        continue
                    corr, args = inputs(2, 128, box, 3, name, seed=box)
                    err = rel(fused.fused_correlate(*args),
                              fused.fused_correlate_reference(*args))
                    corr, args = inputs(128, 128, box, 3, name)
                    fn = launcher(corr, args)
                    tiles[f"{route}_box{box}"] = dict(
                        rel_err=err, ms=[ms(fn, 3) for _ in range(2)])
                    del args, fn
                    torch.cuda.empty_cache()
            out["tiles"] = tiles
        padded = {}
        for L, box, name in ((120, 32, "bfloat16"), (120, 72, "float32"),
                             (98, 40, "bfloat16"), (98, 40, "float32")):
            corr, args = inputs(2, L, box, 3, name, seed=L + box)
            err = rel(fused.fused_correlate(*args),
                      fused.fused_correlate_reference(*args))
            corr, args = inputs(128, L, box, 3, name)
            tc0, tf0 = fused.launches_tc, fused.launches_tf32
            fused.fused_correlate(*args, layouts=corr.k1_layouts)
            route = ("tc" if fused.launches_tc > tc0 else "tf32"
                     if fused.launches_tf32 > tf0 else "simt")
            padded[f"L{L}_{name}_box{box}"] = dict(
                route=route, rel_err=err, ms=[ms(
                    lambda: fused.fused_correlate(
                        *args, layouts=corr.k1_layouts), 3)
                    for _ in range(2)])
            del args
            torch.cuda.empty_cache()
        out["padded"] = padded
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
