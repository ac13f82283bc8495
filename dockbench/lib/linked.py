"""Device time of the kernels that the profiler links to torch's
operators, under the program's ranges.

The harness's ``Trace.op_s`` sums the device time of every host event
under a range.  The profiler attaches a kernel to every host event whose
number equals its operator's correlation number, and in a long trace
other events' numbers meet the operators' (6,592 shared in one
full-sweep request of ``dock-fullsweep-g128-fp32``, 3.2 s of kernels
attached to "Command Buffer Full" events under the CNN's spans), so
``op_s`` counts kernels more than once there.  This counts only the
kernels of events named ``<namespace>::<op>``.
"""
from __future__ import annotations


def _below(e, skip) -> float:
    own = sum(k.duration for k in e.kernels
              if skip is None or skip not in k.name) if "::" in e.name else 0.0
    return own + sum(_below(c, skip) for c in e.cpu_children)


def _inside(e, name: str) -> bool:
    p = e.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p is not None


def linked_s(t, names, under: str | None = None,
             skip: str | None = None) -> float:
    """Device seconds of the kernels linked to torch operators under the
    outermost host events named in ``names``; with ``under``, only under
    those that lie inside an event named ``under``; with ``skip``, not
    the kernels whose names hold it."""
    names = set(names)
    total = 0.0
    for e in t._cpu:
        if e.name not in names:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        if p is None and (under is None or _inside(e, under)):
            total += _below(e, skip)
    return total / 1e6
