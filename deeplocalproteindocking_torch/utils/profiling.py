"""Profiling hooks: a ``torch.profiler`` trace around a region, and
host wall-clock timing of stages.

Port of ``deeplocalproteindocking_tpu/utils/profiling.py``: the CLI's
``--profile DIR`` wraps a command's device work in :func:`maybe_trace`,
which writes a Chrome trace (``chrome://tracing``, Perfetto) into DIR.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


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


class StageTimer:
    """Host wall-clock seconds per named stage, each stage ending when
    the devices of its tensors have finished their queued work."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *sync_tensors):
        t0 = time.perf_counter()
        yield
        for dev in {t.device for t in sync_tensors
                    if isinstance(t, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)
