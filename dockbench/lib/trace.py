"""Tracing for the traced run (``--trace 1``): probes, the profiler and
the reduction of its events to what the metric readers read.

A probe is a file ``dockbench/probes/<name>.json`` naming a function of
the program as ``"module:attribute.path"``.  In the traced run only, the
harness replaces that attribute with a wrapper that

* ``"range"``: runs the call under ``record_function("dockbench::<name>")``,
  so the profiler puts the kernels it launches under that name;
* ``"span"``: also times the call on the host clock, from a
  ``cuda.synchronize`` before it to one after it;
* ``"record": "shapes"``: keeps the shape and dtype of every tensor
  argument of each call;
* ``"wrap_arg": i``: wraps the callable passed as positional argument i
  instead of the function itself, with the range;
* ``"range": "<label>"``: names the range ``<label>`` instead of the
  probe's name (two probes of one layer share a label).

Adding a probe adds a file; no code here changes.
"""
from __future__ import annotations

import glob
import importlib
import json
import os
import time
from collections import defaultdict

import torch

PREFIX = "dockbench::"
PROBES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "probes")


def run_window(unit, seconds: float, traced: bool, limit: int, cfg: dict,
               device: torch.device, go=bool, label: str = "unit",
               lean: int = 0):
    """``(units, window_s, trace or None)``: ``unit(i)`` (a dict with
    ``done``) called back to back while ``go(fewer than seconds have
    passed)``; ``go`` makes every rank of a mesh follow rank 0's clock.

    The traced run first runs ``lean`` units untraced (the host seconds
    the MFU is read over), then profiles the next ``lean`` with the
    device's activity alone (the device's idle share, at a small cost
    on the host), then installs the probes and profiles ``limit`` units
    with the host's operations and ranges.  It runs past ``seconds``
    until all three are done."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    rec = prof = lean_prof = None
    if traced:
        rec = Recorder()
        prof = profiler()
        lean_prof = profiler(lean=True)
    full = 2 * lean                   # the first fully traced unit
    units, tp0, tw, tl0, tl, tr = [], None, None, None, None, None
    t0 = time.perf_counter()
    try:
        while go(time.perf_counter() - t0 < seconds
                 or traced and len(units) < full + limit):
            if traced and lean and len(units) == lean:
                sync()
                lean_prof.start()
                tl0 = time.perf_counter()
            if traced and len(units) == full:
                rec.install(PROBES, sync)
                sync()
                prof.start()
                tp0 = time.perf_counter()
            t1 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + label):
                units.append(unit(len(units)))
            units[-1]["seconds"] = time.perf_counter() - t1
            if traced and lean and len(units) == full:
                sync()
                tl = time.perf_counter() - tl0
                lean_prof.stop()
            if traced and len(units) == full + limit:
                sync()
                tw = time.perf_counter() - tp0
                prof.stop()
                rec.uninstall()        # spans and records of these units
        window_s = time.perf_counter() - t0
        if traced:
            tr = Trace(prof, tw, rec, units[full:full + limit], cfg,
                       device.type == "cuda")
            if lean:
                tr.add_lean(lean_prof, tl, units[lean:full], units[:lean])
    finally:
        if rec is not None:
            rec.uninstall()
    return units, window_s, tr


class Recorder:
    """Spans (host seconds per call) and recorded arguments by probe."""

    def __init__(self):
        self.spans = defaultdict(list)
        self.records = defaultdict(list)
        self._undo = []

    def install(self, probe_dir: str, sync) -> None:
        for path in sorted(glob.glob(os.path.join(probe_dir, "*.json"))):
            name = os.path.basename(path)[:-len(".json")]
            with open(path) as f:
                spec = json.load(f)
            mod_name, attr = spec["target"].split(":")
            owner = importlib.import_module(mod_name)
            *parents, leaf = attr.split(".")
            for p in parents:
                owner = getattr(owner, p)
            orig = getattr(owner, leaf)
            setattr(owner, leaf, self._wrap(name, spec, orig, sync))
            self._undo.append((owner, leaf, orig))

    def uninstall(self) -> None:
        for owner, leaf, orig in reversed(self._undo):
            setattr(owner, leaf, orig)
        self._undo.clear()

    def _wrap(self, name, spec, fn, sync):
        label = PREFIX + spec.get("range", name)
        span = spec.get("span", False)
        record = spec.get("record")
        arg = spec.get("wrap_arg")
        rec = self

        def ranged(f):
            def call(*a, **kw):
                with torch.profiler.record_function(label):
                    return f(*a, **kw)
            return call

        if arg is not None:
            def wrapper(*a, **kw):
                a = list(a)
                a[arg] = ranged(a[arg])
                return fn(*a, **kw)
            return wrapper

        def wrapper(*a, **kw):
            if record == "shapes":
                rec.records[name].append(
                    [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                     for x in a if isinstance(x, torch.Tensor)])
            if span:
                sync()
                t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*a, **kw)
            if span:
                sync()
                rec.spans[name].append(time.perf_counter() - t0)
            return out
        return wrapper


def profiler(lean: bool = False):
    """The host's operations and the device's; ``lean``: the device's
    alone (the host's where there is no card)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts = ([] if lean else acts) + [ProfilerActivity.CUDA]
    return profile(activities=acts)


def _on_device(prof):
    """The device's operations of a profile, without the ranges'
    annotations: ``(events, sorted [start, end) intervals)``."""
    dev = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == dev and not (
        getattr(e, "is_user_annotation", False)
        or e.name.startswith(PREFIX))]
    return kern, sorted((k.time_range.start, k.time_range.end)
                        for k in kern)


def union_s(intervals) -> float:
    """Length of the union of ``[start, end)`` intervals (microseconds in,
    seconds out)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


def overlap_s(iv, spans) -> float:
    """Seconds of the sorted operation intervals ``iv`` that fall inside
    the sorted, disjoint ``spans`` (microseconds in)."""
    total, j = 0.0, 0
    for s, e in iv:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < e:
            total += min(e, spans[k][1]) - max(s, spans[k][0])
            k += 1
    return total / 1e6


class Trace:
    """What the metric readers read (all times in seconds):

    ``window_s`` the traced window (host clock); ``busy_s`` the union of
    the device's operation intervals in it; ``lean_window_s``,
    ``lean_busy_s`` and ``lean_units`` the same of the units profiled
    with the device's activity alone, and ``untraced`` the units run
    before them (None where there were none); ``spans`` and
    ``records``
    from the probes; ``range_s[name]`` the device time of operations
    that ran inside the device spans of probe ``name``'s range; ``kernels[name] = [count,
    seconds]`` of every operation that ran on the device;
    ``op_s(names)`` the device time under the outermost CPU
    ops of those names; ``units`` what the driver did in the window
    (one dict per request or step); ``cfg`` the configuration's
    ``dock_config``; ``gaps`` the idle gaps by what the host was doing.
    """

    def __init__(self, prof, window_s, recorder, units, cfg, device_ok):
        self.window_s = window_s
        self.spans = dict(recorder.spans)
        self.records = dict(recorder.records)
        self.units = units
        self.cfg = cfg
        self.device_ok = device_ok
        self.lean_window_s = self.lean_busy_s = None
        self.lean_units = self.untraced = None
        events = list(prof.events())
        dev = torch.autograd.DeviceType.CUDA
        # A range's span on the device is an annotation, not an operation.
        notes = [e for e in events if e.device_type == dev and (
            getattr(e, "is_user_annotation", False)
            or e.name.startswith(PREFIX))]
        kern, iv = _on_device(prof)
        cpu = [e for e in events if e.device_type != dev]
        self.kernels = {}
        for k in kern:
            c = self.kernels.setdefault(k.name, [0, 0.0])
            c[0] += 1
            c[1] += (k.time_range.end - k.time_range.start) / 1e6
        self.busy_s = union_s(iv) if device_ok else 0.0
        spans = defaultdict(list)
        for e in notes:
            if e.name.startswith(PREFIX):
                spans[e.name[len(PREFIX):]].append(
                    (e.time_range.start, e.time_range.end))
        self.range_s = defaultdict(float, {
            name: overlap_s(iv, sorted(sp)) for name, sp in spans.items()})
        self._cpu = cpu
        self.gaps = self._idle_gaps(iv, cpu)

    def add_lean(self, prof, window_s, units, untraced) -> None:
        """The units profiled with the device's activity alone, and the
        untraced ones before them."""
        if not units:
            return
        self.lean_window_s, self.lean_units = window_s, units
        self.untraced = untraced or None
        self.lean_busy_s = (union_s(_on_device(prof)[1])
                            if self.device_ok else 0.0)

    def device_window(self) -> tuple:
        """``(busy_s, window_s)`` of the lean units where there are any,
        else of the fully traced ones."""
        if self.lean_units:
            return self.lean_busy_s, self.lean_window_s
        return self.busy_s, self.window_s

    def lean_cost(self) -> str:
        """A line comparing the host seconds per unit of the untraced,
        the lean and the fully traced units."""
        def mean(us):
            return sum(u["seconds"] for u in us) / len(us) if us else None
        return (f"trace: {len(self.untraced or [])} untraced units "
                f"{mean(self.untraced)} s each, "
                f"{len(self.lean_units or [])} lean {mean(self.lean_units)}"
                f" s each (device busy {self.lean_busy_s} s of "
                f"{self.lean_window_s}), {len(self.units)} fully traced "
                f"{mean(self.units)} s each")

    def op_s(self, names) -> float:
        """Device seconds under the outermost CPU ops named in ``names``."""
        names = set(names)
        total = 0.0
        for e in self._cpu:
            if e.name not in names:
                continue
            p = e.cpu_parent
            while p is not None and p.name not in names:
                p = p.cpu_parent
            if p is None:
                total += e.device_time_total / 1e6
        return total

    @staticmethod
    def _idle_gaps(iv, cpu, top=10):
        """The idle gaps between device operations, summed by the
        innermost harness range and the innermost op the host was in at
        each gap's middle."""
        if not iv:
            return []
        ranges = sorted((e.time_range.start, e.time_range.end,
                         e.name.startswith(PREFIX), e.name)
                        for e in cpu if not e.is_async)
        gaps = defaultdict(float)
        active, nxt = [], 0
        end = iv[0][1]
        for s, e in iv[1:]:
            if s > end:
                mid = 0.5 * (s + end)
                while nxt < len(ranges) and ranges[nxt][0] <= mid:
                    active.append(ranges[nxt])
                    nxt += 1
                active = [r for r in active if r[1] > mid]
                inner = max((r for r in active if r[2]), default=None)
                outer = max((r for r in active if not r[2]), default=None)
                label = "/".join(
                    x for x in (inner and inner[3][len(PREFIX):],
                                outer and outer[3]) if x) or "host"
                gaps[label] += (s - end) / 1e6
            end = max(end, e)
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]

    def breakdown(self, top=10):
        ops = sorted(((n, s) for n, (_, s) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in self.gaps]}
