"""Profiling hooks: a ``torch.profiler`` trace around a region, and the
port's own spans.

Port of ``deeplocalproteindocking_tpu/utils/profiling.py``: the CLI's
``--profile DIR`` wraps a command's device work in :func:`maybe_trace`,
which writes a Chrome trace (``chrome://tracing``, Perfetto) into DIR.

:class:`span` marks a phase of the program (``"sweep.chunk"``,
``"train.forward"``, ...).  While a profiler records, the span is a
``record_function("dlpd::<name>")`` range, so the trace shows the
port's phases over the kernels they launch; with no profiler it enters
no range at all.  Always, it adds its host nanoseconds
(``time.perf_counter_ns``, no device synchronization) and a count of
one under its name to the record of the root span open on its thread.
A root span (``span(name, root=True)``: one request or step) opens a
:class:`SpanRecord`; :func:`request_log` returns the latest ones.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch

PREFIX = "dlpd::"
LOG_SIZE = 4096

_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns
_open = threading.local()
_log: collections.deque = collections.deque(maxlen=LOG_SIZE)
_seq = itertools.count(1)


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Trace the region's CPU and CUDA activity into
    ``trace_dir/trace_<pid>_<n>.json`` when ``trace_dir`` is set."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    n = len([f for f in os.listdir(trace_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{n}.json"))


@dataclass(slots=True)
class SpanRecord:
    """One root span: ``seq`` (its identifier, the ``args`` of its
    profiler range), ``name``, ``profiled`` (a profiler was recording
    when it opened), ``start_ns`` / ``end_ns`` (``perf_counter_ns``;
    ``end_ns`` None while open), and the host nanoseconds and calls of
    the spans inside it by name."""
    seq: int
    name: str
    profiled: bool
    start_ns: int
    end_ns: int | None = None
    host_ns: dict = field(default_factory=dict)
    count: dict = field(default_factory=dict)


class span:
    """``with span(name):`` -- a phase of the program; ``root=True``
    opens a record of its own (see the module's docstring).  A root
    inside another root is itself a span of the outer one.

    The range is a user annotation, which the profiler also draws on the
    device over the kernels launched inside it and no inner annotation.
    ``annotate=False`` records it as an operator instead: the kernels
    keep the device annotation of the range around it, and the span's
    device time is its host event's."""

    __slots__ = ("name", "root", "annotate", "_range", "_outer", "_rec",
                 "_t0")

    def __init__(self, name: str, root: bool = False, annotate: bool = True):
        self.name = name
        self.root = root
        self.annotate = annotate

    def __enter__(self):
        profiled = _profiling()
        self._outer = getattr(_open, "record", None)
        args = None
        if self.root:
            rec = SpanRecord(next(_seq), self.name, profiled, _clock())
            _log.append(rec)
            _open.record = self._rec = rec
            args = str(rec.seq)
        self._range = None
        if profiled:
            self._range = (
                torch.profiler.record_function(PREFIX + self.name, args)
                if self.annotate else
                torch._C._profiler._RecordFunctionFast(PREFIX + self.name))
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.root:
            self._rec.end_ns = t1
            _open.record = self._outer
        rec = self._outer
        if rec is not None:
            name = self.name
            rec.host_ns[name] = rec.host_ns.get(name, 0) + t1 - self._t0
            rec.count[name] = rec.count.get(name, 0) + 1
        return False


def request_log() -> list:
    """The latest root records, oldest first (at most ``LOG_SIZE``)."""
    return list(_log)
