"""The ``full-sweep`` preset's own model as the benchmark runs it, on the
CPU: the port's biased 3-layer CNN against the benchmark's plain
reference, a tiny copy of ``dock-fullsweep-g128-fp32`` judged correct,
two planted faults judged not correct, and the seeded weights file.
"""
import importlib.util
import os
import sys
import time

import numpy as np
import pytest
import torch

from deeplocalproteindocking_torch import weights
from deeplocalproteindocking_torch.config import PRESETS, DockConfig
from deeplocalproteindocking_torch.models.scoring import ScoringModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "dockbench")
CELL = "dock-fullsweep-g128-fp32"
WEIGHTS = os.path.join(BENCH, "data", "full-sweep-seed0.npz")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's modules (``run``, ``lib``, ``reference``, its
    tests' ``tiny``) on a path restored after the test."""
    monkeypatch.setattr(sys, "path", [BENCH, ROOT] + sys.path)
    conftest = _load("dockbench_conftest",
                     os.path.join(BENCH, "tests", "conftest.py"))
    import run
    from lib import bench as lib_bench
    from reference import model
    # This suite's conftest loads JAX into every test process, and
    # run_cell refuses a process that holds it; that the port itself
    # loads no JAX is test_port_imports_without_jax's to show.
    monkeypatch.setattr(lib_bench, "forbidden_modules", lambda: [])
    return run, conftest.tiny, model


def _flat():
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files}


def test_config_file_is_the_preset():
    import json
    cfg = json.load(open(os.path.join(BENCH, "configs",
                                      "full-sweep-g128-fp32.json")))
    assert DockConfig.from_json(json.dumps(cfg["dock_config"])) \
        == PRESETS["full-sweep"]
    assert cfg["weights"] == os.path.basename(WEIGHTS)


def test_representation_matches_the_plain_reference(bench):
    """``Representation((32, 32, 16))`` with biases and ELU against the
    reference's ``cnn`` on the same seeded weights, float32.  Both run
    ``F.conv3d`` on the CPU, the port on a channels-last view and the
    reference on its own permute, so the 27 C_in-term sums may be taken
    in another order: 1e-5 relative, 1e-6 absolute (float32 rounding of
    three layers of ~900-term sums)."""
    _, _, model = bench
    flat = _flat()
    m = ScoringModel(features=(32, 32, 16), shape_prior=False)
    m.load_state_dict(weights.params_from_numpy(flat))
    vol = torch.rand((2, 12, 12, 12, 11),
                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = m.represent(vol)
        want = model.cnn(vol, model.Weights(flat, "cpu"))
    assert got.shape == want.shape == (2, 12, 12, 12, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # The biases reach the output: without them it moves well past that.
    flat0 = {k: (v * 0 if k.endswith("bias") else v)
             for k, v in flat.items()}
    with torch.no_grad():
        unbiased = model.cnn(vol, model.Weights(flat0, "cpu"))
    assert (unbiased - want).abs().max() > 1e-2


def _faulty_params(fault):
    orig = weights.params_from_numpy

    def params(flat):
        out = orig(flat)
        if fault == "biases":
            for k in out:
                if k.endswith(".bias"):
                    out[k] = torch.zeros_like(out[k])
        elif fault == "diagonal":
            out["coupling"] = torch.diag(torch.diagonal(out["coupling"]))
        return out
    return params


@pytest.mark.parametrize("fault", [None, "biases", "diagonal"])
def test_tiny_cell_against_the_reference(bench, monkeypatch, fault):
    """A tiny copy of the cell (grid 48, 64 rotations) on the CPU: the
    program's served poses are correct against the plain reference;
    with its biases zeroed, or its coupling cut to its diagonal, they
    are not."""
    run, tiny, _ = bench
    if fault:
        monkeypatch.setattr(weights, "params_from_numpy",
                            _faulty_params(fault))
    cell = tiny(CELL)
    assert cell["config"]["dock_config"]["rep_features"] == [32, 32, 16]
    result, checks = run.run_cell(cell, 987654321123, 1.0, False,
                                  device="cpu", t0=time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"] is (fault is None), checks


def test_make_weights_is_seeded_and_loads_both_ways(bench, tmp_path):
    """The same seed writes the same bytes (the committed file's); both
    readers take the file, with the same shapes."""
    _, _, model = bench
    tool = _load("make_weights", os.path.join(BENCH, "tools",
                                              "make_weights.py"))
    a, b, c = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz"))
    tool.write_npz(a, tool.weights(0))
    tool.write_npz(b, tool.weights(0))
    tool.write_npz(c, tool.weights(1))
    data = [open(p, "rb").read() for p in (a, b, c, WEIGHTS)]
    assert data[0] == data[1] == data[3]
    assert data[2] != data[0]
    flat = _flat()
    sd = weights.params_from_numpy(flat)
    ref = model.Weights(flat, "cpu")
    m = ScoringModel(features=(32, 32, 16), shape_prior=False)
    m.load_state_dict(sd)
    assert not ref.shape_prior
    for i, conv in enumerate(m.representation.convs):
        assert tuple(ref.kernels[i].shape) == tuple(conv.weight.shape)
        assert tuple(ref.biases[i].shape) == tuple(conv.bias.shape)
        torch.testing.assert_close(ref.kernels[i], conv.weight,
                                   rtol=0, atol=0)
        assert ref.biases[i].abs().min() > 0
    assert tuple(ref.coupling.shape) == tuple(m.coupling.shape) == (16, 16)
    off = ref.coupling - torch.diag(torch.diagonal(ref.coupling))
    assert off.count_nonzero() == 16 * 15
