"""The CNN's per-convolution spans, and the benchmark readers that read
them, on the CPU.

Each convolution of a CNN (with its layout copies and ELU) is the span
``cnn.conv<i>``, an operator range under a profiler; the sweep's are
those inside ``sweep.cnn``, one per convolution per chunk, for the plain
biased stack and for the hybrid model's rank-folded ``rep_fn``.  With no
profiler no range is entered.  The benchmark's ``cnn_roofline`` reader
works out the sweep's convolutions' work from the configuration and the
ligand's box; it equals the work of the convolutions the profiler saw.
``corr_share.fullsweep`` counts each kernel once.
"""
import collections
import importlib.util
import math
import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.models.representation import (
    conv3d_channels_last, conv_layer)
from deeplocalproteindocking_torch.pipeline import DockingPipeline
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.utils import profiling
from deeplocalproteindocking_torch.utils.profiling import request_log, span

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dockbench")
N_ROT, CHUNK, BOX = 10, 4, 16
CHUNKS = math.ceil(N_ROT / CHUNK)
# features, shape prior, coupling rank; each sweep conv's (C_in, C_out).
MODELS = {
    "plain": ((12, 8, 6), False, None, [(11, 12), (12, 8), (8, 6)]),
    "hybrid-folded": ((8, 6), True, 2, [(11, 8), (8, 2)]),
}


def _cfg(name):
    features, prior, rank, _ = MODELS[name]
    return DockConfig(grid_size=32, resolution=1.5, num_rotations=N_ROT,
                      rotation_chunk=CHUNK, top_k=8, rep_features=features,
                      shape_prior=prior, coupling_rank=rank,
                      lig_grid_size=BOX)


def _pipe(name):
    pipe = DockingPipeline(_cfg(name), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(5))
    return pipe


def _dock(pipe):
    cplx = synthetic_complex(seed=42, n_res_rec=10, n_res_lig=5)
    return pipe.dock_complex(cplx, rotations=super_fibonacci_rotations(N_ROT))


def _profiled(fn, **kw):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        fn()
    return prof


def _inside(e, name):
    p = e.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p is not None


def _load(name, file):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, "metrics", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def readers(monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    return (_load("reader_cnn_roofline", "cnn_roofline.dock.py"),
            _load("reader_corr_share_fullsweep", "corr_share.fullsweep.py"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_counted_work_equals_the_shapes(name, readers):
    """The reader's FLOPs and bytes per layer equal those of the
    convolutions the profiler recorded inside ``sweep.cnn``."""
    pipe = _pipe(name)
    prof = _profiled(lambda: _dock(pipe), record_shapes=True)
    seen = collections.defaultdict(lambda: [0, 0])
    for e in prof.events():
        if e.name != "aten::conv3d" or not _inside(e, "dlpd::sweep.cnn"):
            continue
        x, w = e.input_shapes[0], e.input_shapes[1]
        layer = e.cpu_parent
        while not layer.name.startswith("dlpd::cnn.conv"):
            layer = layer.cpu_parent
        vox = math.prod(x[:1] + x[2:])
        seen[layer.name][0] += 2 * vox * math.prod(w)
        seen[layer.name][1] += 4 * (vox * (x[1] + w[0]) + math.prod(w))
    cfg = {k: getattr(pipe.config, k) for k in (
        "num_atom_types", "rep_features", "shape_prior", "coupling_rank",
        "rotation_chunk", "rep_kernel", "compute_dtype")}
    work = readers[0].request_work(cfg, N_ROT, BOX)
    assert [(a, b) for a, b, _, _ in work] == MODELS[name][3]
    assert {f"dlpd::cnn.conv{i}": [f, n]
            for i, (_, _, f, n) in enumerate(work)} == dict(seen)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_conv_ranges_once_per_conv_per_chunk(name):
    pipe = _pipe(name)
    prof = _profiled(lambda: _dock(pipe))
    convs = collections.Counter()
    outside = collections.Counter()
    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    for e in prof.events():
        if not e.name.startswith(profiling.PREFIX + "cnn.conv"):
            continue
        # An operator range: on the card its kernels stay under the
        # device annotation of the user range around the CNN.
        assert e.scope != user
        if _inside(e, "dlpd::sweep.cnn"):
            convs[e.name] += 1
        else:
            # The receptor's and the ligand's CNN in dock.prepare.
            assert _inside(e, "dlpd::dock.prepare"), e.name
            outside[e.name] += 1
    n = len(MODELS[name][3])
    assert convs == {f"dlpd::cnn.conv{i}": CHUNKS for i in range(n)}
    assert sorted(outside) == [f"dlpd::cnn.conv{i}" for i in range(n)]


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _dock(_pipe("plain"))
    rec = request_log()[-1]
    assert rec.name == "dock"
    assert rec.count["cnn.conv2"] >= CHUNKS
    assert rec.count["sweep.cnn"] == CHUNKS


def test_conv_layer_is_a_span_of_the_open_record():
    x = torch.rand(1, 6, 6, 6, 3)
    w = torch.rand(4, 3, 3, 3, 3)
    b = torch.rand(4)
    with span("outer", root=True):
        y = conv_layer(x, w, b, 1, True)
        z = conv_layer(x, w, None, 1, False)
    assert torch.equal(y, F.elu(conv3d_channels_last(x, w, b)))
    assert torch.equal(z, conv3d_channels_last(x, w, None))
    rec = request_log()[-1]
    assert rec.name == "outer" and rec.count == {"cnn.conv1": 2}


# ---- the benchmark's readers, on stub traces ----

def _event(name, kernels=(), children=()):
    e = types.SimpleNamespace(
        name=name, cpu_parent=None, cpu_children=list(children),
        kernels=[types.SimpleNamespace(name=k, duration=d)
                 for k, d in kernels])
    for c in e.cpu_children:
        c.cpu_parent = e
    return e


def _flatten(roots):
    out = []

    def walk(e):
        out.append(e)
        for c in e.cpu_children:
            walk(c)
    for r in roots:
        walk(r)
    return out


def _conv_events(dev_s):
    """Two conv spans under ``dlpd::sweep.cnn``, each launching through
    an operator (half of ``dev_s``) with a host event that the profiler
    also gave a kernel (left out), and a conv span nested in a conv span
    (counted once); a conv span outside the sweep (left out)."""
    half = dev_s / 2 * 1e6
    convs = []
    for i in range(2):
        op = _event("aten::cudnn_convolution",
                    [("fprop", half / 2), ("nchwToNhwc", half / 2)],
                    [_event("Command Buffer Full", [("fprop", 7e5)])])
        convs.append(_event(f"dlpd::cnn.conv{i}", [],
                            [op, _event(f"dlpd::cnn.conv{i}")]))
    sweep = _event("dlpd::sweep.cnn", [("other", 9e6)], convs)
    receptor = _event("dlpd::cnn.conv0", [], [_event(
        "aten::cudnn_convolution", [("fprop", 5e6)])])
    return _flatten([sweep, _event("dlpd::dock.prepare", [], [receptor])])


class _Trace:
    def __init__(self, boxes, dtype="bfloat16", dev_s=0.5):
        self.units = [{"rotations": 13000, "lig_box": b} for b in boxes]
        self.cfg = {"num_atom_types": 11, "rep_features": [32, 32, 16],
                    "shape_prior": False, "coupling_rank": None,
                    "rotation_chunk": 128, "rep_kernel": 3,
                    "compute_dtype": dtype}
        self._cpu = _conv_events(dev_s)


def test_cnn_roofline_reads_the_traced_requests(readers):
    mod = readers[0]
    t = _Trace([40])
    assert mod.linked_s(t, {"dlpd::cnn.conv0", "dlpd::cnn.conv1"},
                        under="dlpd::sweep.cnn") == pytest.approx(0.5)
    # Box 40, 102 chunks of 128, bf16: 11 -> 32 and 32 -> 16 are bound
    # by their bytes (221 and 288 operations a byte, under the peaks'
    # 295), 32 -> 32 by its FLOPs.
    vox = 102 * 128 * 40 ** 3
    want = (2 * (vox * 43 + 102 * 27 * 11 * 32) / 3.35e12
            + 2 * vox * 27 * 32 * 32 / 989e12
            + 2 * (vox * 48 + 102 * 27 * 32 * 16) / 3.35e12)
    assert mod.request_bound_s(t.cfg, 13000, 40) == pytest.approx(want)
    assert mod.read(t) == pytest.approx(100 * want / 0.5)
    assert mod.read(_Trace([40, 48])) == pytest.approx(
        100 * (want + mod.request_bound_s(t.cfg, 13000, 48)) / 0.5)
    t32 = _Trace([40], "float32")
    assert mod.read(t32) == pytest.approx(
        100 * mod.request_bound_s(t32.cfg, 13000, 40) / 0.5)
    assert mod.request_bound_s(t32.cfg, 13000, 40) > want
    # A rank-3 coupling folded into the last layer of the hybrid.
    hybrid = dict(t.cfg, rep_features=[32, 14], shape_prior=True,
                  coupling_rank=3)
    assert mod.layers(hybrid) == [(11, 32), (32, 3)]
    assert mod.read(_Trace([40], dev_s=0.0)) is None
    assert mod.read(_Trace([])) is None
    # A program without the conv spans (the parent's): no value.
    t.units, t._cpu = [{"rotations": 13000, "lig_box": 40}], [
        e for e in t._cpu if not e.name.startswith("dlpd::cnn.conv")]
    assert mod.read(t) is None


def test_corr_share_fullsweep_counts_kernels_once(readers):
    mod = readers[1]
    k1 = "void dlpd::(anonymous namespace)::fused_correlate_tf32_kernel"
    splat = "void dlpd::separable_splat_kernel"
    gemm = _event("aten::mm", [("gemm", 2e5)],
                  [_event("Command Buffer Full", [("gemm", 2e5)])])
    # A program kernel the profiler did link is counted from the table.
    odd = _event("aten::copy_", [(k1, 1e5)])
    corr = _event("dlpd::sweep.correlate", [], [gemm, odd])
    t = types.SimpleNamespace(
        _cpu=_flatten([corr]), busy_s=2.0,
        kernels={k1: [2, 0.6], splat: [1, 0.3], "gemm": [1, 0.2]})
    assert mod.read(t) == pytest.approx(100 * (0.2 + 0.6) / 2.0)
    t.busy_s = 0.0
    assert mod.read(t) is None
    t.busy_s, t._cpu = 2.0, []
    assert mod.read(t) is None
