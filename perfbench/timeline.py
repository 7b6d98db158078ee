"""Reading a ``torch.profiler`` trace of a slice of whole calls.

The arithmetic of ``chip_smoke.py``'s launch profiles (device kernels
counted from the profiler's events, kernel time summed by name), with the
timeline read directly: the union of device intervals (kernels, memcpy,
memset) inside the wall span of the traced calls gives the busy and idle
time, and each idle gap is named by the host operation that was running at
its middle. The trace is summarized in memory; no Chrome trace is written.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

#: the name of the host annotation around each traced call
CALL = "perfbench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime")
#: what a gap is named when no host operation spans its middle
OUTSIDE = "host outside torch ops"
TOP = 10
NAME_CHARS = 120


@dataclass
class Event:
    start: int  # ns
    end: int
    name: str
    kind: str


@dataclass
class Summary:
    kernels: int              # device kernel events in the window
    kernel_s: float           # their summed durations
    busy_s: float             # union of device intervals in the window
    window_s: float           # wall span of the traced calls
    calls: int                # traced calls
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most first
    idle_gaps: list = field(default_factory=list)   # [[host op, seconds]], most first
    by_kernel: dict = field(default_factory=dict)   # {base name: [launches, seconds]}

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def base_name(name: str) -> str:
    """A kernel's own name from the profiler's demangled signature:
    ``void (anonymous namespace)::dia_pair_kernel<float, 4>(float const*)``
    is ``dia_pair_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def _kind(e, device_type) -> str:
    """The event's kind: one of DEVICE_KINDS or HOST_KINDS, "call" for the
    traced call's own annotation, else "other"."""
    name = e.name()
    if name == CALL:
        return "call" if device_type == "CPU" else "other"
    try:
        kind = str(e.activity_type())
    except AttributeError:  # an older profiler: by device and name
        if device_type != "CPU":
            low = name.lower()
            kind = ("gpu_memcpy" if low.startswith("memcpy") else
                    "gpu_memset" if low.startswith("memset") else "kernel")
        else:
            kind = "cuda_runtime" if name.startswith("cuda") else "cpu_op"
    if device_type != "CPU":
        return kind if kind in DEVICE_KINDS else "other"
    return kind if kind in HOST_KINDS else "other"


def events(prof) -> list:
    """The profile's events as :class:`Event` (ns on one clock)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dtype = str(e.device_type()).split(".")[-1]
        kind = _kind(e, dtype)
        if kind == "other":
            continue
        start = int(e.start_ns())
        out.append(Event(start, start + int(e.duration_ns()), e.name(), kind))
    return out


def union(intervals):
    """Disjoint sorted intervals covering ``intervals`` ((start, end))."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def top_level(host):
    """The host events not inside an earlier one: (starts, events)."""
    tops = []
    for ev in sorted(host, key=lambda ev: (ev.start, -ev.end)):
        if tops and ev.end <= tops[-1].end:
            continue
        tops.append(ev)
    return [ev.start for ev in tops], tops


def gap_names(gaps, host):
    """{host op: idle seconds} over ``gaps``, each named by the outermost
    host operation that spans its middle."""
    starts, tops = top_level(host)
    named = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = tops[i].name if i >= 0 and tops[i].end > mid else OUTSIDE
        named[name] = named.get(name, 0.0) + (e - s) / 1e9
    return named


def ranked(totals: dict):
    return [[name[:NAME_CHARS], seconds]
            for name, seconds in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(evs) -> Summary:
    """The summary of the events of one profile (:func:`events`)."""
    calls = [ev for ev in evs if ev.kind == "call"]
    if not calls:
        raise ValueError(f"the trace holds no {CALL} annotation")
    t0, t1 = min(ev.start for ev in calls), max(ev.end for ev in calls)
    device = [ev for ev in evs if ev.kind in DEVICE_KINDS and ev.end > t0 and ev.start < t1]
    host = [ev for ev in evs if ev.kind in HOST_KINDS]
    busy = union((max(ev.start, t0), min(ev.end, t1)) for ev in device)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    by_name = {}
    for ev in device:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (ev.end - ev.start) / 1e9
    kernels = [ev for ev in device if ev.kind == "kernel"]
    by_kernel = {}
    for ev in kernels:
        entry = by_kernel.setdefault(base_name(ev.name), [0, 0.0])
        entry[0] += 1
        entry[1] += (ev.end - ev.start) / 1e9
    return Summary(
        kernels=len(kernels),
        kernel_s=sum(ev.end - ev.start for ev in kernels) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        window_s=(t1 - t0) / 1e9,
        calls=len(calls),
        device_ops=ranked(by_name),
        idle_gaps=ranked(gap_names(gaps, host)),
        by_kernel=by_kernel,
    )
