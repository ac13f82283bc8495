"""What every cell shares: finding a cell's files by name, the pools, the
metric readers, the limits and the result line."""
from __future__ import annotations

import glob
import importlib.util
import json
import math
import os
import sys

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "deeplocalproteindocking_tpu")


class CellError(Exception):
    """A cell that cannot run here; the message says why."""


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str, benchmark: dict = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and limits files read, and its metrics by kind."""
    bm = benchmark or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bm["configs"]}
    cfg_entry = configs[w["config"]]
    return dict(
        name=name, chips=w["chips"],
        config=load_json(ROOT, cfg_entry["file"]),
        traffic=load_json(BENCH, "traffic", w["traffic"] + ".json"),
        limits=load_json(BENCH, "limits", name + ".json"),
        end_to_end=[m for m in bm["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bm["per_layer"]
                   if name in m.get("workloads", [name])])


def weights_arrays(config: dict) -> dict:
    with np.load(os.path.join(BENCH, "data", config["weights"])) as z:
        return {k: z[k] for k in z.files}


def load_pool(name: str) -> list:
    """The committed pool ``data/<name>.npz`` as a list of dicts of
    numpy arrays: ``rec_xyz``, ``rec_types``, ``rec_res``, ``lig_*``
    and ``seed``."""
    with np.load(os.path.join(BENCH, "data", name + ".npz")) as z:
        d = {k: z[k] for k in z.files}
    out = []
    for i, seed in enumerate(d["seeds"]):
        c = {"seed": int(seed)}
        for key in ("rec", "lig"):
            a, b = d[f"{key}_off"][i], d[f"{key}_off"][i + 1]
            c[f"{key}_xyz"] = d[f"{key}_xyz"][a:b]
            c[f"{key}_types"] = d[f"{key}_types"][a:b].astype(np.int32)
            c[f"{key}_res"] = d[f"{key}_res"][a:b].astype(np.int32)
        out.append(c)
    return out


def order(seed: int, n: int, count: int) -> list:
    """``count`` pool indices: successive seeded permutations of the
    pool, so every seed draws the same complexes equally often."""
    rng = np.random.default_rng(seed)
    idx = []
    while len(idx) < count:
        idx.extend(rng.permutation(n).tolist())
    return idx[:count]


def read_metric(name: str, trace):
    """The value of per-layer metric ``name`` from its reader file
    ``metrics/<name>.py`` (``read(trace)``), or None when the reader
    finds nothing to read.  A file ``metrics/<name>.json`` holding
    ``{"reader": "<other>"}`` reads ``name`` with ``<other>``'s reader:
    one quantity under the name of each end-to-end metric it moves."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    if not os.path.exists(path):
        return read_metric(load_json(BENCH, "metrics", name + ".json")
                           ["reader"], trace)
    spec = importlib.util.spec_from_file_location(
        "dockbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def metric_files() -> list:
    return sorted(os.path.basename(p).rsplit(".", 1)[0]
                  for ext in ("py", "json")
                  for p in glob.glob(os.path.join(BENCH, "metrics",
                                                  "*." + ext)))


def end_to_end_value(name: str, values: dict) -> float:
    """An end-to-end metric's value from the driver's ``values``: the
    quantity before the first dot of its name, so that ``rot_per_s`` and
    ``rot_per_s.ckpt`` are one quantity under the bounds of two cells."""
    return values[name.split(".")[0]]


def judge(numbers: dict, limits: dict) -> tuple:
    """``(ok, checks)``: each compared number beside its limit."""
    checks, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k)
        good = v is not None and not math.isnan(v) and v <= lim
        ok = ok and good
        checks[k] = {"value": v, "limit": lim}
    return ok, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, the checks last."""
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
