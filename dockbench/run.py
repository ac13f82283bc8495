"""Run one cell of the benchmark once.

    python3 dockbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration, traffic, limits, probes and
metric readers are files under ``dockbench/``.  The run sets up the
program (``deeplocalproteindocking_torch``) as a user would and warms up
every shape, measures for ``--seconds``, reads the device's peak memory,
frees the program, and holds a sample of what the window produced to
the plain reference (``dockbench/reference``).  The last line of
standard output is the result; the compared numbers and their limits
are the last lines of standard error.  Exits non-zero without a result
when there is no card (or fewer than the cell asks for), when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

# Every build and kernel cache of the program at a fixed path inside the
# checkout (build/ is not committed).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ.setdefault("USE_FLAX", "0")

DRIVERS = {"dock": ("lib.dock", "Dock"), "train": ("lib.train", "Train")}


def driver_class(kind: str):
    import importlib
    mod, cls = DRIVERS[kind]
    return getattr(importlib.import_module(mod), cls)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float = T0, comm=None, mesh=None):
    """``(result, checks)`` of one run of ``cell`` (``lib.bench.cell_spec``)
    on ``device``; on a mesh (``comm``, ``mesh``: ``lib.ranks``) every
    rank runs it and rank 0 alone returns them.  ``(None, None)`` when
    some rank's process holds JAX or the JAX package after the window."""
    import torch
    from lib import bench, ranks
    comm = comm or ranks.Solo
    drv = driver_class(cell["traffic"]["kind"])(cell, device, mesh)
    t_prog = time.perf_counter() - t0
    drv.warm_up(seed)
    setup_s = time.perf_counter() - t0
    if comm.rank == 0:
        print(f"setup: program set up at {t_prog:.2f} s, warmed up at "
              f"{setup_s:.2f} s", file=sys.stderr)
    units, served, window_s, failed, tr = drv.window(seed, seconds, traced,
                                                     comm.go)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    peak = comm.gather(torch.cuda.max_memory_allocated(dev) if cuda else 0)
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": comm.world, "memory_peak_bytes": int(max(peak))}
    metrics, breakdown = {}, None
    if traced:
        if comm.rank == 0:
            print(tr.lean_cost(), file=sys.stderr)
        tr.ranks = comm.gather(tr.device_window())
        info.update(busy_s=sum(b for b, _ in tr.ranks) / comm.world,
                    window_s=tr.device_window()[1])
        for m in cell["per_layer"]:
            v = bench.read_metric(m["name"], tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = tr.breakdown()
    else:
        e2e = drv.end_to_end(units, window_s)
        e2e["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": bench.end_to_end_value(
                m["name"], e2e), "unit": m["unit"]}
    del tr
    drv.free()
    # Every rank's own modules once the window has closed: a rank other
    # than 0 loads the program in a process of its own.
    found = sorted(set().union(*comm.gather(bench.forbidden_modules())))
    if comm.rank != 0:
        return None
    if found:
        print(f"dockbench: a rank loaded {found}; the port must run "
              f"without them", file=sys.stderr)
        return None, None
    numbers = drv.check(seed, units, served)
    ok, checks = bench.judge(numbers, cell["limits"]["limits"])
    result = {"correct": bool(ok and failed == 0 and units),
              "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    from lib import bench
    try:
        cell = bench.cell_spec(a.workload)
        if not torch.cuda.is_available():
            raise bench.CellError("no CUDA card is visible")
        if torch.cuda.device_count() < cell["chips"]:
            raise bench.CellError(
                f"{a.workload} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} visible")
        tf32 = cell["config"]["tf32"]
        if (torch.backends.cuda.matmul.allow_tf32 != tf32["matmul"]
                or torch.backends.cudnn.allow_tf32 != tf32["cudnn"]):
            raise bench.CellError(
                f"torch's TF32 flags are not the configuration's {tf32}")
        import deeplocalproteindocking_torch  # noqa: F401
    except (bench.CellError, ImportError, OSError, KeyError) as e:
        print(f"dockbench: {e}", file=sys.stderr)
        return 2
    from lib import ranks
    seed = a.seed % 2 ** 63
    if ranks.world_size(cell) > 1:
        result, checks = ranks.run_ranks(cell, seed, a.seconds,
                                         bool(a.trace), "cuda", T0)
    else:
        torch.cuda.set_device(0)
        result, checks = run_cell(cell, seed, a.seconds, bool(a.trace))
    found = bench.forbidden_modules()
    if found:
        print(f"dockbench: loaded {found}; the port must run without "
              f"them", file=sys.stderr)
    if found or result is None:
        return 3
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
