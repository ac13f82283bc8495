"""The port's spans (``utils/profiling.span``) and the benchmark readers
of what they record, on the CPU.

With no profiler a span enters no ``record_function`` and still adds its
host time to the open root's record; under a profiler the ranges nest
as the program's layers do (a tiny ``dock`` and a tiny train step); the
record log stays bounded; the readers in ``dockbench/metrics/`` pick the
untraced units' records and read ``op_s`` under the spans' names.
"""
import collections
import importlib.util
import math
import os
import sys
import types

import pytest
import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data import synthetic_complex
from deeplocalproteindocking_torch.pipeline import DockingPipeline
from deeplocalproteindocking_torch.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_torch.train import data_gen
from deeplocalproteindocking_torch.train.trainer import Trainer
from deeplocalproteindocking_torch.utils import profiling
from deeplocalproteindocking_torch.utils.profiling import (
    SpanRecord, request_log, span)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dockbench")
PHASES = ("sweep.rotate", "sweep.splat", "sweep.cnn", "sweep.correlate",
          "sweep.merge")
N_ROT, CHUNK = 10, 4


def _dock_cfg():
    return DockConfig(grid_size=32, resolution=1.5, num_rotations=N_ROT,
                      rotation_chunk=CHUNK, top_k=8, rep_features=(8,),
                      sweep_mode="resplat")


def _dock():
    cplx = synthetic_complex(seed=42, n_res_rec=10, n_res_lig=5)
    return DockingPipeline(_dock_cfg(), device="cpu").dock_complex(
        cplx, rotations=super_fibonacci_rotations(N_ROT))


def _no_ranges(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _span_parent(e):
    """The nearest enclosing ``dlpd::`` range of event ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(profiling.PREFIX):
        p = p.cpu_parent
    return p and p.name[len(profiling.PREFIX):]


def _by_name(prof):
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            out[e.name[len(profiling.PREFIX):]].append(e)
    return out


def test_span_without_profiler_enters_no_range(monkeypatch):
    _no_ranges(monkeypatch)
    with span("outer", root=True):
        with span("a"):
            with span("a.inner"):
                pass
        with span("a"):
            pass
    rec = request_log()[-1]
    assert (rec.name, rec.profiled) == ("outer", False)
    assert rec.count == {"a": 2, "a.inner": 1}
    assert rec.host_ns["a"] >= rec.host_ns["a.inner"] >= 0
    assert rec.end_ns - rec.start_ns >= rec.host_ns["a"]
    seq = rec.seq
    with span("no.root"):                  # no record open: nothing kept
        pass
    assert request_log()[-1].seq == seq


def test_dock_without_profiler_enters_no_range(monkeypatch):
    _no_ranges(monkeypatch)
    poses = _dock()
    rec = request_log()[-1]
    assert (rec.name, rec.profiled) == ("dock", False)
    chunks = math.ceil(N_ROT / CHUNK)
    assert rec.count["sweep.chunk"] == chunks
    assert all(rec.count[p] == chunks for p in PHASES)
    assert rec.count["sweep"] == rec.count["dock.cluster"] == 1
    assert sum(rec.host_ns[p] for p in PHASES) <= rec.host_ns["sweep.chunk"]
    assert rec.host_ns["sweep.chunk"] <= rec.host_ns["sweep"]
    assert len(poses.scores) > 0


def test_dock_spans_nest_under_the_profiler():
    prof, _ = _profile(_dock)
    ev = _by_name(prof)
    chunks = math.ceil(N_ROT / CHUNK)
    assert len(ev["dock"]) == 1 and len(ev["sweep"]) == 1
    assert len(ev["sweep.chunk"]) == chunks
    assert [_span_parent(e) for e in ev["sweep"]] == ["dock"]
    assert {_span_parent(e) for e in ev["sweep.chunk"]} == {"sweep"}
    for p in PHASES:
        assert len(ev[p]) == chunks, p
        assert {_span_parent(e) for e in ev[p]} == {"sweep.chunk"}, p
    for p in ("dock.prepare", "dock.receptor", "dock.readback",
              "dock.cluster"):
        assert len(ev[p]) == 1, p
        assert _span_parent(ev[p][0]) == "dock", p
    rec = request_log()[-1]
    assert (rec.name, rec.profiled) == ("dock", True)
    assert rec.count["sweep.chunk"] == chunks


def test_train_step_spans_nest_under_the_profiler():
    cfg = DockConfig(grid_size=16, resolution=1.5, rep_features=(4,),
                     shape_prior=True, num_decoys=6, batch_complexes=2,
                     num_rotations=4, rotation_chunk=4, decoy_max_shift=4.0,
                     decoy_max_angle_deg=40.0, decoy_global_frac=0.34,
                     near_native_rmsd=5.0, hinge_margin=20.0)
    cplx = [synthetic_complex(seed=s, n_res_rec=6, n_res_lig=3)
            for s in range(3)]
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()

    def step():
        batch = data_gen.make_training_batch(
            torch.Generator().manual_seed(1), cplx, cfg, device="cpu")
        return tr.train_step(state, batch)
    prof, (new, m) = _profile(step)
    assert math.isfinite(float(m["loss"]))
    ev = _by_name(prof)
    assert len(ev["train.batch"]) == len(ev["train.step"]) == 1
    for p in ("train.forward", "train.backward", "train.optimizer"):
        assert [_span_parent(e) for e in ev[p]] == ["train.step"], p
    batch_rec, step_rec = request_log()[-2:]
    assert (batch_rec.name, step_rec.name) == ("train.batch", "train.step")
    assert batch_rec.profiled and step_rec.profiled
    # The CNN's one convolution runs as a span on each side of each of
    # the batch's two complexes.
    assert step_rec.count == {"train.forward": 1, "train.backward": 1,
                              "train.optimizer": 1, "cnn.conv0": 4}
    assert batch_rec.end_ns <= step_rec.start_ns


def test_request_log_stays_bounded():
    for _ in range(profiling.LOG_SIZE + 5):
        with span("bounded", root=True):
            pass
    log = request_log()
    assert len(log) == profiling.LOG_SIZE
    assert all(r.name == "bounded" for r in log)
    seqs = [r.seq for r in log]
    assert seqs == list(range(seqs[0], seqs[0] + profiling.LOG_SIZE))


# ---- the benchmark's readers ----

def _reader(name, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(seq, name, profiled, seconds, chunk_ns=0, chunks=0):
    r = SpanRecord(seq, name, profiled, 0, int(seconds * 1e9))
    if chunks:
        r.host_ns["sweep.chunk"] = chunk_ns
        r.count["sweep.chunk"] = chunks
    return r


class _Trace:
    def __init__(self, untraced_s):
        self.untraced = [{"seconds": s} for s in untraced_s]


def _log(monkeypatch, records):
    monkeypatch.setattr(profiling, "_log", collections.deque(
        records, maxlen=profiling.LOG_SIZE))


def test_chunk_host_reader_picks_the_untraced_requests(monkeypatch):
    read = _reader("chunk_host_us.ckpt", monkeypatch).read
    warm = _rec(1, "dock", False, 0.5, 9_000_000, 2)
    untraced = [_rec(2 + i, "dock", False, 3.0, 4_000_000 * (i + 1), 1_000)
                for i in range(3)]
    steps = [_rec(10, "train.step", False, 0.1)]
    profiled = [_rec(20 + i, "dock", True, 3.3, 1, 1) for i in range(4)]
    _log(monkeypatch, [warm] + untraced + steps + profiled)
    # 24e6 ns over 3,000 chunks: 8 us a chunk.
    assert read(_Trace([3.0, 3.01, 2.99])) == pytest.approx(8.0)
    # The untraced units' seconds do not match the records' (within 2%).
    assert read(_Trace([3.2, 3.2, 3.2])) is None
    # More untraced units than records before the first profiled one.
    assert read(_Trace([3.0] * 5)) is None
    _log(monkeypatch, [warm] + untraced)       # no profiled record
    assert read(_Trace([3.0] * 3)) is None
    assert read(_Trace([])) is None


def test_step_host_reader_picks_the_untraced_steps(monkeypatch):
    read = _reader("step_host_ms.train", monkeypatch).read
    recs = [_rec(1, "train.step", False, 0.5)]          # a checked step
    for i in range(4):
        recs += [_rec(2 + 2 * i, "train.batch", False, 0.01),
                 _rec(3 + 2 * i, "train.step", False, 0.08 + 0.01 * i)]
    recs += [_rec(20, "train.batch", True, 0.02),
             _rec(21, "train.step", True, 0.2)]
    _log(monkeypatch, recs)
    assert read(_Trace([0.1] * 4)) == pytest.approx(95.0)   # 0.08 .. 0.11
    assert read(_Trace([0.1] * 3)) == pytest.approx(100.0)  # the last 3
    assert read(_Trace([0.1] * 6)) is None
    _log(monkeypatch, recs[:-2])
    assert read(_Trace([0.1] * 4)) is None


def test_readers_return_none_without_the_programs_records(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "deeplocalproteindocking_torch.utils.profiling",
                        None)
    for name in ("chunk_host_us.ckpt", "step_host_ms.train"):
        assert _reader(name, monkeypatch).read(_Trace([1.0])) is None


@pytest.mark.parametrize("name,op", [
    ("corr_share.dock", "dlpd::sweep.correlate"),
    ("fwd_share.train", "dlpd::train.forward")])
def test_share_readers_read_op_s_on_a_cpu_profile(name, op, monkeypatch):
    """Built from a CPU profile of a tiny dock or step, the harness's
    trace finds the span's events (device time 0 on the CPU: the reader
    reads nothing); with device time under the name the reader divides
    it by the busy time, the correlation's adding the program's own
    kernels that the profiler linked to no host operation."""
    spec = importlib.util.spec_from_file_location(
        "dockbench_trace", os.path.join(BENCH, "lib", "trace.py"))
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)

    class Rec:
        spans, records = {}, {}
    if name.startswith("corr"):
        prof, _ = _profile(_dock)
    else:
        cfg = DockConfig(grid_size=16, resolution=1.5, rep_features=(4,),
                         num_decoys=4, batch_complexes=1)
        cplx = [synthetic_complex(seed=0, n_res_rec=6, n_res_lig=3)]
        tr = Trainer(cfg, device="cpu")
        prof, _ = _profile(lambda: tr.train_step(
            tr.init_state(), data_gen.make_training_batch(
                torch.Generator().manual_seed(0), cplx, cfg,
                device="cpu")))
    t = trace.Trace(prof, 1.0, Rec(), [], {}, False)
    assert any(e.name == op for e in t._cpu)
    assert t.op_s([op]) == 0.0
    read = _reader(name, monkeypatch).read
    assert read(t) is None

    class Stub:
        busy_s = 2.0
        asked = []
        # 0.3 s of the program's own kernel, 0.1 s of it linked to a
        # host operation: the correlation's share counts the other 0.2.
        kernels = {"void dlpd::k1<3>": [4, 0.3], "aten_kernel": [9, 0.4]}
        _cpu = [types.SimpleNamespace(kernels=[types.SimpleNamespace(
            name="void dlpd::k1<3>", duration=1e5)])]

        def op_s(self, names):
            self.asked.append(list(names))
            return 0.5
    stub = Stub()
    assert read(stub) == pytest.approx(
        35.0 if name.startswith("corr") else 25.0)
    assert stub.asked == [[op]]
