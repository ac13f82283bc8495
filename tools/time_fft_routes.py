#!/usr/bin/env python3
"""K2's and K3's kernels timed on one card at L = 16, 32, 48, 64, 80, 96,
112 and 128, for the package under a given root.

    python3 tools/time_fft_routes.py [ROOT]      # from the repo root

``ROOT`` (default: the repository) is the directory that holds the
``deeplocalproteindocking_torch`` package to time: point it at an
unpacked older commit (``git archive``) to compare two versions, and run
them in turns (older, newer, newer, older) in one call on one card.
Inputs are random and made on the card from a seed, at the main path's
chunk of b = 128 rotations: K2's ``D [b, L/2+1, L, L]`` with a bias that
masks about 40% of the cells (K2 only at L % 32 == 0, the grids its
fused top-K tail takes), K3's ``E [b, L, L, L]``.  At each L each
kernel is launched as its wrapper routes it (``k2_route``, ``k3_route``;
the route is reported: an older package may route an L to a kernel
that a newer one retired), held against its plain version (max |kernel
- plain| / max |plain|) and timed, and beside it ``torch.fft.ifft2``,
the one PyTorch call that computes K3's function.
Times are CUDA events over 20 launches after one warm-up, queued behind
a device sleep while the host launches them, so that the host's launch
overhead (tens of microseconds a call, the size of K2 at L = 32 and K3
at L = 16 and 32) is not counted.  The ptxas
report of the build (registers, spills, shared memory of every K2 and
K3 kernel) comes with them.  Prints one JSON line with the card's name
and power limit.
"""
import json
import os
import re
import subprocess
import sys

import torch


QUEUE_CYCLES = 20_000_000      # about 10 ms at 1.98 GHz


def ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` launches after one, the
    launches queued behind a sleep of ``QUEUE_CYCLES`` on the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), "finite entries differ"
    return ((got[fin] - want[fin]).abs().max()
            / want[fin].abs().max()).item()


def ptxas_report(log_path, pattern="invz_blockmax|idft"):
    """{kernel<L>: {registers, spill_stores, spill_loads, smem}} from the
    build's ``-Xptxas -v`` log, for the kernels whose name starts with
    ``pattern``."""
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                k = re.search(rf"\d(({pattern})\w*?_kernel)(?:ILi(\d+)E)?",
                              m.group(1))
                name = k and k.group(1) + (f"<{k.group(3)}>" if k.group(3)
                                           else "")
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out.setdefault(name, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out.setdefault(name, {}).update(
                    registers=int(m.group(1)),
                    smem=int(smem.group(1)) if smem else 0)
    return out


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    if not torch.cuda.is_available():
        sys.exit("time_fft_routes.py: no CUDA card")
    sys.path.insert(0, os.path.abspath(root))
    from deeplocalproteindocking_torch import _build
    from deeplocalproteindocking_torch.correlate import idft, invz_topk
    from deeplocalproteindocking_torch.correlate.dft import get_correlator

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, b = torch.device("cuda"), 128
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.library()
    rows = {}
    with torch.inference_mode():
        for L in (16, 32, 48, 64, 80, 96, 112, 128):
            g = torch.Generator(device=dev).manual_seed(L)
            corr = get_correlator(L, 16, "float32", dev)
            row = {}
            if L % 32 == 0:
                D = [torch.randn((b, L // 2 + 1, L, L), generator=g,
                                 device=dev) for _ in range(2)]
                bias = torch.where(torch.rand((1, L, L, L), generator=g,
                                              device=dev) < 0.6, 0.0,
                                   float("-inf"))
                k2 = (D[0], D[1], corr.MzRe, corr.MzIm, bias)
                row.update(
                    k2_route=invz_topk.k2_route(L),
                    k2_rel_err=rel(invz_topk.invz_blockmax(*k2),
                                   invz_topk.invz_blockmax_reference(*k2)),
                    k2_ms=ms(lambda: invz_topk.invz_blockmax(*k2)))
                del D, bias, k2
            E = [torch.randn((b, L, L, L), generator=g, device=dev)
                 for _ in range(2)]
            k3 = (*E, corr.UxRe32, corr.UxIm32, corr.UxRe32, corr.UxIm32)
            want = idft.idft_bc_reference(*k3)
            row.update(k3_route=idft.k3_route(L),
                       k3_rel_err=rel(idft.idft_bc(*k3), want),
                       k3_ms=ms(lambda: idft.idft_bc(*k3)))
            del want
            row["ifft2_ms"] = ms(lambda: torch.fft.ifft2(
                torch.complex(E[0], E[1]), dim=(1, 2)).real)
            rows[str(L)] = row
            del E, k3
            torch.cuda.empty_cache()
    print(json.dumps({
        "root": os.path.abspath(root), "card": card, "batch": b,
        "timer": "cuda events, mean of 20 after 1 warm-up, queued behind "
                 "a device sleep", "L": rows,
        "ptxas": ptxas_report(_build.library_path() + ".log")}), flush=True)


if __name__ == "__main__":
    main()
