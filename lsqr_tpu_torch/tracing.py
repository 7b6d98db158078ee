"""Spans and counters inside the solvers: where a call's time goes.

Counters are always on: plain integers, bumped once a segment or a
megakernel launch, never once a masked iteration, read with :func:`counts`.

=====================  ========================================================
counter                bumped
=====================  ========================================================
iterations_launched    the steps a segment of ``solver._run_segments``
                       enqueued (at most its ``seg``); ``K`` a megakernel
                       launch
iterations_needed      the solve's final itn (the largest row itn of a solve
                       over rows), from the read that already brings it
segments_cut           1 a segment of ``solver._run_segments`` that a stop
                       flag read without blocking ended before ``seg`` steps
=====================  ========================================================

Spans are recorded while a ``torch.profiler`` session records, or between
:func:`enable` and :func:`disable`. Off, a span site costs one flag check:
no profiler range, no CUDA event, no host read. On, a span is kept in
memory as a :class:`Span` stamped with ``time.time_ns()``, the clock of the
profiler's host events, and every span but ``entry`` opens a profiler range
``lsqr_tpu_torch.<name>`` on the host thread, so it lies in the profiler's
trace (and in :func:`lsqr_tpu_torch.utils.profiling.trace`'s Chrome trace)
over the device lanes, and a gap of the card inside a call is named by its
layer. The range is a function-scope one (``_RecordFunctionFast``, an
event of kind ``cpu_op``), not ``record_function``'s user scope: the
profiler mirrors a user-scope range onto the device lanes as a span over
the kernels it launched, and a profiler without ``activity_type()`` on its
events (PyTorch 2.11) cannot tell that span from a kernel. A PyTorch
without ``_RecordFunctionFast`` records the spans in memory alone. At most
:data:`MAX_SPANS` are kept; later ones are dropped and counted
(``counts()["spans_dropped"]``).

A kernel span times one launch in :data:`SAMPLE` of each counted wrapper,
its first included: two CUDA events and a range a launch would, under
the profiler, slow the host enough to show in the card's idle time.

=================  ====================  ============================================
span               parent                where
=================  ====================  ============================================
entry              none                  an outermost entry call (no profiler range):
                                         ``entry``, ``rows`` and the call's deltas of the counters and of
                                         ``spmv.launch_counts()`` (``launches``)
prepare, finalize  entry                 set-up before the loop, the result after it
segment.enqueue    entry                 a segment's masked steps (``seg``: at most)
segment.read       entry                 its host read (``itn``)
mk.launch          entry                 a megakernel launch and its snapshot (``K``)
mk.wait            entry                 the wait for a snapshot, the final state
kernel             the enclosing span    a sampled kernel launch (``spmv._launch``):
                                         ``kernel_name``, ``variant``, ``work`` (the
                                         wrapper's declared unit: ``pair`` with
                                         ``rows``, ``product``, ``iterations`` with
                                         ``iterations`` = K, ``copy``) and
                                         ``device_s``, timed by two CUDA events
build              none                  an operator builder: ``builder``, ``bytes``
build.pack,        build                 the host or device packing, the copy to the
build.upload                             card
=================  ====================  ============================================

Attributes may hold CUDA event pairs or device tensors; :func:`spans`
resolves them (a kernel's ``device_s``), never the hot path.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import inspect
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # a PyTorch without it: spans in memory alone
    _Range = None

__all__ = ["Span", "enable", "disable", "enabled", "spans", "counts", "clear", "span",
           "entry", "builder", "kernel", "count", "MAX_SPANS", "SAMPLE", "PREFIX",
           "COUNTERS"]

#: the prefix of every span's name in the profiler's trace
PREFIX = "lsqr_tpu_torch."
#: spans kept in memory; later ones are dropped and counted
MAX_SPANS = 2 ** 17
#: a kernel span times one launch in SAMPLE of each wrapper: a prime, so
#: the launches of a batch's rows take turns
SAMPLE = 17
COUNTERS = ("iterations_launched", "iterations_needed", "segments_cut")


class Span(NamedTuple):
    """One recorded span: ``call`` is the id of the entry span it lies in
    (None outside every entry), ``parent`` that of the innermost span open
    when it began; stamps in ns of ``time.time_ns()``."""

    id: int
    parent: Optional[int]
    call: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


_counts = dict.fromkeys(COUNTERS, 0)
_records: list = []
_stack: list = []  # the open spans, innermost last
#: "resolved": the records whose attributes :func:`spans` has resolved
_state = {"forced": False, "dropped": 0, "next_id": 0, "depth": 0, "resolved": 0}


def enable() -> None:
    """Record spans also outside a profiler session."""
    _state["forced"] = True


def disable() -> None:
    """Record spans only while a profiler session records."""
    _state["forced"] = False


def enabled() -> bool:
    """Whether a span opened now is recorded."""
    return _state["forced"] or _profiler._is_profiler_enabled


def count(name: str, k: int) -> None:
    """Add ``k`` to counter ``name``."""
    _counts[name] += k


def counts() -> dict:
    """The counters' running totals, and ``spans_dropped``."""
    return {**_counts, "spans_dropped": _state["dropped"]}


def clear() -> None:
    """Forget the recorded spans and set every counter to 0."""
    _records.clear()
    _state["dropped"] = _state["resolved"] = 0
    for name in _counts:
        _counts[name] = 0


class _Timer(NamedTuple):
    """A device interval between two recorded CUDA events."""

    start: torch.cuda.Event
    end: torch.cuda.Event

    def seconds(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _resolve(value):
    if isinstance(value, _Timer):
        return value.seconds()
    if isinstance(value, torch.Tensor):
        return value.tolist()
    return value


def spans() -> list:
    """The recorded spans, oldest first, their device attributes resolved
    (this waits for the device work they time)."""
    for rec in _records[_state["resolved"]:]:
        for key, value in rec.attrs.items():
            rec.attrs[key] = _resolve(value)
    _state["resolved"] = len(_records)
    return list(_records)


class _Null:
    """The span of a site while spans are off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span being recorded; ``with`` gives its attribute dict."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        _state["next_id"] += 1
        self.id = _state["next_id"]
        outer = _stack[-1] if _stack else None
        self.parent = outer.id if outer else None
        self.call = outer.call if outer and outer.call is not None else (
            self.id if self.name == "entry" else None)
        _stack.append(self)
        # no range over a whole call: a gap of the card is named by its layer
        self.rf = _Range(PREFIX + self.name) if _Range and self.name != "entry" else None
        if self.rf is not None:
            self.rf.__enter__()
        self.start = time.time_ns()  # next to the annotation's own stamp
        return self.attrs

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack.pop()
        if len(_records) >= MAX_SPANS:
            _state["dropped"] += 1
            return False
        _records.append(Span(self.id, self.parent, self.call, self.name, self.start, end,
                             self.attrs))
        return False


def span(name: str, **attrs):
    """A span named ``name`` over a ``with`` block, with ``attrs``; the
    block gets the attribute dict to add to (None while spans are off)."""
    if not enabled():
        return _NULL
    return _Open(name, attrs)


class kernel:
    """The span of one sampled kernel launch (:func:`spmv._launch`) on
    ``stream``: the wrapper's declared ``work`` unless given, ``rows`` of
    a pair (1 unless given), ``iterations`` of a megakernel launch, and
    the launch's device time between two CUDA events. Only open it while
    :func:`enabled`."""

    def __init__(self, wrapper, variant: str, stream, work: Optional[str] = None,
                 rows: Optional[int] = None, iterations: Optional[int] = None):
        work = work or getattr(wrapper, "work", "product")
        attrs = {"kernel_name": wrapper.kernel_name, "variant": variant, "work": work}
        if work == "pair":
            attrs["rows"] = int(rows or 1)
        if iterations is not None:
            attrs["iterations"] = int(iterations)
        self.stream = stream
        self.span = _Open("kernel", attrs)

    def __enter__(self):
        attrs = self.span.__enter__()
        timer = attrs["device_s"] = _Timer(torch.cuda.Event(enable_timing=True),
                                           torch.cuda.Event(enable_timing=True))
        # no garbage collection between the two events: where the card has
        # caught up with the host, a pause there would count as the kernel's
        self.collecting = gc.isenabled()
        gc.disable()
        timer.start.record(self.stream)
        return attrs

    def __exit__(self, *exc):
        self.span.attrs["device_s"].end.record(self.stream)
        if self.collecting:
            gc.enable()
        return self.span.__exit__(*exc)


def _problems(value, by_length: bool) -> int:
    """Problems in an argument: the entries of a list of damps
    (``by_length``), else the leading length of a 2-D right-hand side, and
    1 for a vector."""
    if by_length:
        return int(torch.as_tensor(value).numel())
    shape = np.shape(value)
    return int(shape[0]) if len(shape) == 2 else 1


def _launch_counts() -> dict:
    from .ops import spmv

    return spmv.launch_counts()


def entry(name: str, rows: Optional[str] = None, rows_by_length: bool = False):
    """Decorate an entry point: while spans are on, each outermost call is
    an ``entry`` span with the call's name, its problems (of argument
    ``rows``: see :func:`_problems`; 1 without), and its deltas of the counters and of ``spmv.launch_counts()``
    (``launches``, the kernels that launched). Calls inside it (the warm
    start's recursion, ``lsqr`` handing over to ``lsqr_megakernel``) open
    no entry of their own."""

    def wrap(fn):
        signature = inspect.signature(fn)

        def traced(args, kwargs):
            problems = 1 if rows is None else _problems(
                signature.bind(*args, **kwargs).arguments.get(rows), rows_by_length)
            before, launches = dict(_counts), _launch_counts()
            with span("entry", entry=name, rows=problems) as attrs:
                out = fn(*args, **kwargs)
                attrs.update({k: _counts[k] - before[k] for k in COUNTERS})
                attrs["launches"] = {k: v - launches.get(k, 0)
                                     for k, v in _launch_counts().items()
                                     if v != launches.get(k, 0)}
            return out

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _state["depth"] or not enabled():
                return fn(*args, **kwargs)
            _state["depth"] = 1
            try:
                return traced(args, kwargs)
            finally:
                _state["depth"] = 0

        return run

    return wrap


def _held_bytes(obj, seen: set) -> int:
    """Bytes of the distinct tensors an operator holds (through its
    dataclass fields, nested ones included)."""
    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_held_bytes(getattr(obj, f.name), seen) for f in dataclasses.fields(obj))
    return 0


def builder(name: str):
    """Decorate an operator builder: while spans are on, each call is a
    ``build`` span with the builder's name and the ``bytes`` the operator
    holds; the builder marks its ``build.pack`` and ``build.upload``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with span("build", builder=name) as attrs:
                op = fn(*args, **kwargs)
                attrs["bytes"] = _held_bytes(op, set())
            return op

        return run

    return wrap
