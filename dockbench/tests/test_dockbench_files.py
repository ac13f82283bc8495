"""The benchmark's files: names, what imports what, the counts."""
from __future__ import annotations

import ast
import glob
import importlib
import json
import os
import re

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "deeplocalproteindocking_tpu"}


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def imported_tops(path):
    """Top-level names of every module a Python file imports."""
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def py_files(*sub):
    return sorted(glob.glob(os.path.join(BENCH, *sub, "**", "*.py"),
                            recursive=True))


def test_nothing_imports_jax_or_the_jax_package():
    for path in py_files():
        assert not imported_tops(path) & FORBIDDEN, path
    for path in glob.glob(os.path.join(BENCH, "probes", "*.json")):
        target = json.load(open(path))["target"]
        assert target.split(".")[0] not in FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in py_files("reference"):
        tops = imported_tops(path)
        assert "deeplocalproteindocking_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "types",
                        "typing", "numpy", "torch", "reference"}, path


def test_harness_reads_neither_the_old_bench_nor_its_results():
    for path in py_files():
        if os.sep + "tests" + os.sep in path:
            continue
        text = open(path).read()
        assert "bench.py" not in text.replace("dockbench", ""), path
        assert "BENCH_r0" not in text and "MULTICHIP_r0" not in text, path


def test_names_and_units_use_the_allowed_characters():
    bm = benchmark()
    names = [c["name"] for c in bm["configs"]]
    names += [w["name"] for w in bm["workloads"]]
    names += [w["traffic"] for w in bm["workloads"]]
    names += [w["config"] for w in bm["workloads"]]
    names += [m["name"] for m in bm["end_to_end"] + bm["per_layer"]]
    names += [k for c in bm["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for path in glob.glob(os.path.join(BENCH, "**", "*"), recursive=True):
        rel = os.path.relpath(path, ROOT)
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_every_cell_finds_its_files_by_name():
    from lib import bench
    bm = benchmark()
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    readers = set(bench.metric_files())
    for w in bm["workloads"]:
        cell = bench.cell_spec(w["name"], bm)
        assert cell["traffic"]["kind"] in ("dock", "train")
        assert os.path.exists(os.path.join(
            BENCH, "data", cell["traffic"]["pool"] + ".npz"))
        assert os.path.exists(os.path.join(
            BENCH, "data", cell["config"]["weights"]))
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["name"] in readers
            assert m["moves"] in names and m["moves"] in e2e
    assert sum(w["chips"] == 4 for w in bm["workloads"]) <= max(
        1, len(bm["workloads"]) // 4)


def test_probe_targets_resolve():
    for path in sorted(glob.glob(os.path.join(BENCH, "probes", "*.json"))):
        mod, attr = json.load(open(path))["target"].split(":")
        obj = importlib.import_module(mod)
        for part in attr.split("."):
            obj = getattr(obj, part)
        assert callable(obj), path


def test_configs_state_tf32_and_their_control():
    for path in glob.glob(os.path.join(BENCH, "configs", "*.json")):
        c = json.load(open(path))
        assert c["tf32"] == {"matmul": False, "cudnn": True,
                             "why": c["tf32"]["why"]}
        assert c["control"] in ("bfloat16", "float8_e4m3fn")


def _reader(name):
    from lib import bench
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    del bench
    return mod


@pytest.mark.parametrize("dtype,bound_ms,gbytes", [
    ("bfloat16", 0.360, 1.21)])
def test_k1_bound_reproduces_perf_md(dtype, bound_ms, gbytes):
    """PERF.md's K1 bound at b = 128, L = 128, box 32, C = 3, bf16."""
    b, K, C, X, L = 128, 65, 3, 32, 128
    sh = ([((b, K, C, X, X), dtype)] * 2 + [((K, C, L, L), dtype)] * 2
          + [((X, L), dtype)] * 4 + [((L, L), dtype)] * 4)
    k1 = _reader("k1_roofline.dock")
    assert round(k1.launch_bound_s(sh) * 1e3, 3) == bound_ms
    nbytes = sum(2 * k1._numel(s) for s, _ in sh) + 2 * b * K * L * L * 4
    assert round(nbytes / 1e9, 2) == gbytes


def test_k2_bound_reproduces_perf_md():
    """PERF.md's K2 bound at b = 128, L = 128: 0.338 ms, 1.13 GB."""
    k2 = _reader("k2_roofline.dock")
    sh = ([((128, 65, 128, 128), "float32")] * 2
          + [((65, 128), "float32")] * 2 + [((128, 128, 128), "float32")])
    assert round(k2.launch_bound_s(sh) * 1e3, 3) == 0.338
    assert round((2 * 128 * 65 * 128 * 128 + 128 ** 3 + 128 * 128 ** 3 // 32)
                 * 4 / 1e9, 2) == 1.13


def test_model_flop_counts():
    """The issue's per-rotation count at the serve config: CNN 9.0 and
    the correlation 0.47 GFLOP at box 72."""
    m = _reader("dock_mfu")
    cfg = json.load(open(os.path.join(
        BENCH, "configs", "v9p-r3-g128-bf16.json")))["dock_config"]
    assert round(m.conv_flops(cfg, 72 ** 3, 3) / 1e9, 1) == 9.0
    per_rot = (m.request_flops(cfg, 1, 72) - m.conv_flops(cfg, 128 ** 3))
    assert round((per_rot - m.conv_flops(cfg, 72 ** 3, 3)) / 1e9, 2) == 0.47
