"""Read a cell's compared numbers over many seeds in one process, with
the control and, for a training cell, under each planted fault: the
readings each limit in ``limits/<cell>.json`` is set from.

    python3 dockbench/tools/readings.py --workload <cell> \
        --seeds 1,2,3 --seconds <s> [--control] [--faults half,...]

Set-up once, then per seed: the seed's warm-up, a window of
``--seconds`` and the comparison, with the control (the reference
rounded to the configuration's ``control`` dtype) read on the same
requests or steps; per fault and seed (training cells): the fault
planted, the checked steps again and the comparison.  One JSON line per
reading on standard output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import run  # noqa: E402  (sets the cache directories)
from lib import bench  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    import faults
    cell = bench.cell_spec(a.workload)
    kind = cell["traffic"]["kind"]
    control = cell["config"]["control"] if a.control else None
    t0 = time.perf_counter()
    drv = run.driver_class(kind)(cell, a.device)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for s in (int(x) for x in a.seeds.split(",")):
        t = time.perf_counter()
        drv.warm_up(s)
        units, served, window_s, failed, _ = drv.window(s, a.seconds)
        numbers = drv.check(s, units, served, control=control)
        print(json.dumps({"seed": s, "fault": None, "units": len(units),
                          "unit_s": [u["seconds"] for u in units],
                          "pool": [u.get("pool_index") for u in units],
                          "failed": failed, "window_s": window_s,
                          "seconds": time.perf_counter() - t, **numbers}),
              flush=True)
    for name in filter(None, a.faults.split(",")):
        for s in [int(x) for x in a.seeds.split(",")][:3]:
            undo = faults.plant(kind, name)
            try:
                drv.warm_up(s)
                units, served, _, failed, _ = drv.window(s, a.seconds)
                numbers = drv.check(s, units, served)
            finally:
                undo()
            print(json.dumps({"seed": s, "fault": name, "failed": failed,
                              **numbers}), flush=True)


if __name__ == "__main__":
    main()
