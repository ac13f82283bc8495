"""Tiny cells end to end on the CPU (the kernels' plain versions): a sound
run is correct and its line parses; every planted fault and the control
come out not correct; the card's run is a ``gpu`` test."""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from conftest import BENCH, tiny

DOCK, CKPT = "dock-large-g128-bf16", "dock-ckpt-g64-fp32"
TRAIN = "train-g64-fp32"


def run_tiny(name, traced=False, seconds=1.0):
    import run
    from lib import bench
    result, checks = run.run_cell(tiny(name), 987654321123, seconds,
                                  traced, device="cpu",
                                  t0=time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        bench.emit(result, checks)
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("name", [DOCK, TRAIN])
def test_tiny_cell_is_correct_and_its_line_parses(name):
    line, err = run_tiny(name)
    assert line["correct"] is True, line
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"
    for k, c in line["checks"].items():
        assert f"check {k} = " in err
        assert c["value"] <= c["limit"]


def test_tiny_traced_run_reports_per_layer_metrics():
    line, _ = run_tiny(DOCK, traced=True)
    assert line["correct"] is True
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert {"prepare_ms.dock", "cluster_ms.dock"} <= set(line["metrics"])
    assert "breakdown" in line


@pytest.mark.parametrize("kind,cell,fault", [
    ("dock", DOCK, "half"), ("dock", DOCK, "unchanged"),
    ("dock", DOCK, "altered"), ("dock", CKPT, "half"),
    ("dock", CKPT, "unchanged"), ("dock", CKPT, "altered"),
    ("train", TRAIN, "half"), ("train", TRAIN, "unchanged"),
    ("train", TRAIN, "altered")])
def test_planted_fault_is_not_correct(kind, cell, fault):
    sys.path.insert(0, os.path.join(BENCH, "tools"))
    import faults
    undo = faults.plant(kind, fault)
    try:
        line, _ = run_tiny(cell)
    finally:
        undo()
    assert line["correct"] is False, line["checks"]


MESH_RUN = """
import functools, json, sys, time
sys.path[:0] = [{bench!r}, {bench!r} + "/tests", {bench!r} + "/tools"]
from conftest import tiny
from lib import ranks
import faults


def jax_on_rank_1():
    # a module named jax in rank 1's process only
    import os, types
    if os.environ["LOCAL_RANK"] == "1":
        sys.modules["jax"] = types.ModuleType("jax")


if __name__ == "__main__":
    fault = sys.argv[1] if len(sys.argv) > 1 else None
    init = functools.partial(faults.plant, "dock", fault) if fault else None
    if fault == "jax_on_rank_1":
        init = jax_on_rank_1
    result, checks = ranks.run_ranks(tiny(sys.argv[2]), 24680, 1.0, False,
                                     "cpu", time.perf_counter(), init)
    print(json.dumps(result))
"""


@pytest.mark.parametrize("fault,want", [("", True), ("exchange", False),
                                        ("jax_on_rank_1", None)])
def test_tiny_mesh_cell(tmp_path, fault, want):
    """The four-card cell on four CPU ranks (gloo), started as the
    harness starts them: correct; with the exchange between ranks left
    out on every rank, not correct; with JAX loaded on rank 1 alone, no
    result."""
    script = tmp_path / "mesh_run.py"
    script.write_text(MESH_RUN.format(bench=BENCH))
    p = subprocess.run([sys.executable, str(script), fault, DOCK + "-rot4"],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.splitlines()[-1])
    if want is None:
        assert result is None and "a rank loaded ['jax']" in p.stderr
        return
    assert result["correct"] is want
    assert result["device"]["count"] == 4


def control_readings(cell):
    import run
    c = tiny(cell)
    drv = run.driver_class(c["traffic"]["kind"])(c, "cpu")
    seed = 31337
    drv.warm_up(seed)
    units, served, _, _, _ = drv.window(seed, 1.0)
    return c, drv.check(seed, units, served,
                        control=c["config"]["control"])


@pytest.mark.parametrize("cell", [DOCK, CKPT, TRAIN])
def test_control_is_not_correct(cell):
    """The reference rounded to the configuration's ``control`` dtype,
    read on a tiny run's own outputs in the program's place, is judged
    not correct against the cell's limits; the program is correct."""
    from lib import bench
    c, got = control_readings(cell)
    limits = c["limits"]["limits"]
    control = dict(got, **{k[len("control_"):]: v for k, v in got.items()
                           if k.startswith("control_")})
    assert bench.judge(got, limits)[0], got
    ok, checks = bench.judge(control, limits)
    assert not ok, checks


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """No card: exit non-zero, no result line.  A directory holding only
    BENCHMARK.json and the benchmark's files: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    root = os.path.dirname(BENCH)
    p = subprocess.run([sys.executable, "dockbench/run.py", "--workload",
                        DOCK, "--seed", "1", "--seconds", "1"], cwd=root,
                       env=env, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
    subprocess.run(["cp", "-r", BENCH, str(tmp_path / "dockbench")],
                   check=True)
    subprocess.run(["cp", os.path.join(root, "BENCHMARK.json"),
                    str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "dockbench/run.py", "--workload",
                        DOCK, "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card_is_correct():
    """One short run of the checkpoint cell on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = os.path.dirname(BENCH)
    p = subprocess.run([sys.executable, "dockbench/run.py", "--workload",
                        "dock-ckpt-g64-fp32", "--seed", "424242",
                        "--seconds", "5"], cwd=root, capture_output=True,
                       text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.splitlines()[-1])["correct"] is True
