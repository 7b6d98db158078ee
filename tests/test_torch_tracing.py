"""The port's spans and counters (lsqr_tpu_torch.tracing): what the solvers
record with the profiler on and off, the span tree of each entry point,
the stamps against the profiler's own events, the cap, and answers that
tracing leaves bit for bit as they were. The last cases need the card
(``-m cuda``): the kernel spans' event times and the band's declared pair.
"""

import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lsqr_tpu_torch as lt
from lsqr_tpu_torch import tracing
from lsqr_tpu_torch.ops import spmv
from lsqr_tpu_torch.solver import AHEAD

from _torch_parity import banded, cuda_device  # noqa: F401

OFFSETS = (-2, -1, 0, 1, 2)
M = 256
SEG = 8


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def band(device="cpu", m=M, offsets=OFFSETS, shared=True, seed=0, boost=5.0):
    data, _ = banded(np.random.default_rng(seed), m, m, offsets, boost=boost, dense=False)
    if shared:
        return lt.dia_shared_operator(m, m, offsets, data, device=device)
    return lt.dia_operator_device(m, m, offsets, torch.from_numpy(data).to(device))


def rhs(rows=None, m=M, device="cpu"):
    g = torch.Generator().manual_seed(1)
    shape = (m,) if rows is None else (rows, m)
    return torch.randn(shape, generator=g).to(device)


def profiled(fn, cuda=False):
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        out = fn()
    return out, prof


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_is_recorded_off_the_profiler_and_the_counters_count():
    res = lt.lsqr(band(), rhs(), 0.01, atol=1e-6, btol=1e-6, loop_segment=SEG)
    itn = int(res.itn)
    assert tracing.spans() == []
    c = tracing.counts()
    assert set(c) == {*tracing.COUNTERS, "spans_dropped"} and c["spans_dropped"] == 0
    # a segment ends at most AHEAD masked steps past the stop, or at SEG
    assert c["iterations_needed"] == itn <= c["iterations_launched"] <= itn + AHEAD
    assert c["iterations_launched"] <= SEG * -(-itn // SEG)


def test_off_a_span_site_opens_no_annotation_and_no_event(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("a span site acted with spans off")

    monkeypatch.setattr(tracing, "_Range", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    lt.lsqr(band(), rhs(), 0.01, loop_segment=SEG)
    lt.lsqr_batch(band(), rhs(3), 0.01)
    lt.lsqr(band(shared=False), rhs(), 0.01, megakernel=True, itnlim=12)
    assert tracing.spans() == [] and tracing.counts()["iterations_launched"] > 0


def test_lsqr_records_its_span_tree_under_the_profiler():
    A = band()
    res, _ = profiled(lambda: lt.lsqr(A, rhs(), 0.01, atol=1e-6, btol=1e-6,
                                      loop_segment=SEG))
    spans = by_name(tracing.spans())
    entry, = spans["entry"]
    assert entry.parent is None and entry.call == entry.id
    assert entry.attrs["entry"] == "lsqr" and entry.attrs["rows"] == 1
    for name in ("prepare", "segment.enqueue", "segment.read", "finalize"):
        assert spans[name] and all(s.parent == entry.id and s.call == entry.id
                                   for s in spans[name]), name
    segments = len(spans["segment.enqueue"])
    assert len(spans["segment.read"]) == segments
    assert all(s.attrs["seg"] == SEG for s in spans["segment.enqueue"])
    assert spans["segment.read"][-1].attrs["itn"] == int(res.itn)
    # seg is the most a segment runs: all but the last run it whole
    assert SEG * (segments - 1) < entry.attrs["iterations_launched"] <= SEG * segments
    assert int(res.itn) <= entry.attrs["iterations_launched"] <= int(res.itn) + AHEAD
    assert entry.attrs["iterations_needed"] == int(res.itn)
    order = [s.name for s in sorted(tracing.spans(), key=lambda s: s.start_ns)]
    assert order[:3] == ["entry", "prepare", "segment.enqueue"] and order[-1] == "finalize"


def test_lsqr_batch_records_its_rows_and_the_largest_itn():
    res, _ = profiled(lambda: lt.lsqr_batch(band(), rhs(3), 0.01, atol=1e-6, btol=1e-6))
    spans = by_name(tracing.spans())
    entry, = spans["entry"]
    assert entry.attrs["entry"] == "lsqr_batch" and entry.attrs["rows"] == 3
    assert entry.attrs["iterations_needed"] == int(res.itn.max())
    launched = entry.attrs["iterations_launched"]
    assert launched <= 64 * len(spans["segment.enqueue"])
    assert int(res.itn.max()) <= launched <= int(res.itn.max()) + AHEAD
    assert spans["prepare"][0].parent == spans["finalize"][0].parent == entry.id


def test_the_megakernel_records_each_launch_and_its_k():
    """The plain path (the CPU twin): ``lsqr`` hands over to
    ``lsqr_megakernel`` inside one entry; each call is an ``mk.launch``
    with its K, and the counters add the K of every launch."""
    res, _ = profiled(lambda: lt.lsqr(band(shared=False), rhs(), 0.01, megakernel=True,
                                      itnlim=20, atol=1e-9, btol=1e-9))
    spans = by_name(tracing.spans())
    entry, = spans["entry"]
    assert entry.attrs["entry"] == "lsqr"
    launches = spans["mk.launch"]
    assert [s.attrs["K"] for s in launches] == [20, 20]
    assert entry.attrs["iterations_launched"] == sum(s.attrs["K"] for s in launches) == 40
    assert entry.attrs["iterations_needed"] == int(res.itn) == 20
    assert len(spans["mk.wait"]) == 2
    for name in ("prepare", "mk.launch", "mk.wait", "finalize"):
        assert all(s.parent == entry.id for s in spans[name]), name


def test_each_span_lies_on_its_profiler_annotation():
    """Each span's stamps (``time.time_ns()``) within 0.5 ms of its event
    in the profiler's own trace, on the host; the entry opens no range, so
    that a gap inside a call is named by its layer. The stamps are
    two reads of one clock a few calls apart: a first annotation's set-up
    (warmed here) or a garbage collection of the test process's heap
    (paused here) between them would part them by milliseconds."""
    def solves():
        return lt.lsqr(band(), rhs(), 0.01, loop_segment=SEG), lt.lsqr_batch(band(), rhs(2), 0.01)

    profiled(solves)
    tracing.clear()
    gc.collect()
    gc.disable()
    try:
        _, prof = profiled(solves)
    finally:
        gc.enable()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            assert str(e.device_type()).endswith("CPU")
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = by_name(tracing.spans())
    assert spans.pop("entry")
    assert {tracing.PREFIX + name for name in spans} == set(events)
    for name, recorded in spans.items():
        stamps = sorted((s.start_ns, s.end_ns) for s in recorded)
        seen = sorted(events[tracing.PREFIX + name])
        assert len(stamps) == len(seen), name
        for (s0, s1), (e0, e1) in zip(stamps, seen):
            assert abs(s0 - e0) < 500_000 and abs(s1 - e1) < 500_000, name


def test_the_chrome_trace_shows_the_spans(tmp_path):
    from lsqr_tpu_torch.utils import profiling

    A = band()
    with profiling.trace(str(tmp_path)):
        lt.lsqr(A, rhs(), 0.01, loop_segment=SEG)
    text, = [p.read_text() for p in tmp_path.iterdir()]
    for name in ("prepare", "segment.enqueue", "segment.read", "finalize"):
        assert f'"{tracing.PREFIX}{name}"' in text, name
    assert f'"{tracing.PREFIX}entry"' not in text


def test_without_the_profiler_range_the_spans_are_kept_in_memory(monkeypatch):
    """A PyTorch without ``_RecordFunctionFast``: the same spans, none of
    them in the profiler's trace."""
    monkeypatch.setattr(tracing, "_Range", None)
    _, prof = profiled(lambda: lt.lsqr(band(), rhs(), 0.01, loop_segment=SEG))
    names = {s.name for s in tracing.spans()}
    assert {"entry", "prepare", "segment.enqueue", "segment.read", "finalize"} <= names
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(tracing.PREFIX)]


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    tracing.enable()
    lt.lsqr(band(), rhs(), 0.01, loop_segment=SEG)
    kept, c = tracing.spans(), tracing.counts()
    assert len(kept) == 5 and c["spans_dropped"] > 0
    # the children close first: the entry is among the dropped
    assert "entry" not in {s.name for s in kept}
    tracing.clear()
    assert tracing.spans() == [] and tracing.counts()["spans_dropped"] == 0


def test_enable_records_outside_the_profiler_and_entries_do_not_nest():
    """``enable``/``disable``; a warm start's recursion and ``lsqr``'s
    hand-over stay inside the one outermost entry."""
    tracing.enable()
    lt.lsqr(band(), rhs(), 0.0, x0=torch.ones(M), loop_segment=SEG)
    entries = [s for s in tracing.spans() if s.name == "entry"]
    assert len(entries) == 1
    needed = tracing.counts()["iterations_needed"]
    assert entries[0].attrs["iterations_needed"] == needed > 0
    tracing.disable()
    lt.lsqr(band(), rhs(), 0.0, loop_segment=SEG)
    assert len([s for s in tracing.spans() if s.name == "entry"]) == 1
    assert tracing.counts()["iterations_needed"] > needed


def test_builders_record_their_pack_upload_and_bytes():
    rng = np.random.default_rng(3)
    m, n, nnz = 4096, 64, 20000
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    tracing.enable()
    A = lt.wcoo_operator(m, n, vals, rows, cols, device="cpu")
    S = band()
    spans = by_name(tracing.spans())
    builds = {s.attrs["builder"]: s for s in spans["build"]}
    assert set(builds) == {"wcoo_operator", "dia_shared_operator"}
    assert builds["dia_shared_operator"].attrs["bytes"] == 4 * (S.dp.numel() + len(OFFSETS))
    assert builds["wcoo_operator"].attrs["bytes"] >= A.packed.vals.numel() * 4
    for name in ("build.pack", "build.upload"):
        assert {s.parent for s in spans[name]} == {s.id for s in spans["build"]}, name


CASES = {
    "lsqr": lambda: lt.lsqr(band(), rhs(), 0.01, atol=1e-6, btol=1e-6, loop_segment=SEG),
    "lsqr_batch": lambda: lt.lsqr_batch(band(), rhs(3), 0.01, atol=1e-6, btol=1e-6),
    "megakernel": lambda: lt.lsqr(band(shared=False), rhs(), 0.01, megakernel=True,
                                  itnlim=20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_answers_are_bit_equal_with_tracing_on_and_off(case):
    off = CASES[case]()
    on, _ = profiled(CASES[case])
    assert tracing.spans()
    for field in ("x", "istop", "itn", "rnorm"):
        assert torch.equal(getattr(off, field), getattr(on, field)), field


class FakeEvent:
    """A CUDA event's surface on the host clock, in ms as CUDA's."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream):
        assert stream == "stream" and gc.isenabled() is False
        self.at = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def test_a_kernel_span_times_its_launch_between_two_events(monkeypatch):
    """The launch's span (``spmv._launch`` opens it on the card) with the
    wrapper's declared work, its events around the launch alone, and no
    garbage collection between them; the time is read in ``spans()``."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    tracing.enable()
    with tracing.kernel(spmv.dia_pair_shared, "f32", "stream"):
        time.sleep(0.002)
    assert gc.isenabled()
    with tracing.kernel(spmv.dia_pair_shared, "f32", "stream", work="product"):
        pass
    with tracing.kernel(spmv.dia_matvec, "bf16", "stream", iterations=32):
        pass
    pair, product, mk = tracing.spans()
    assert pair.name == "kernel" and pair.attrs["kernel_name"] == "dia_pair_shared"
    assert pair.attrs["work"] == "pair" and pair.attrs["rows"] == 1
    assert 0.002 <= pair.attrs["device_s"] <= (pair.end_ns - pair.start_ns) / 1e9
    assert product.attrs["work"] == "product" and "rows" not in product.attrs
    assert mk.attrs["variant"] == "bf16" and mk.attrs["iterations"] == 32


class FakeStream:
    cuda_stream = 0


def test_one_launch_in_sample_of_a_wrapper_is_a_kernel_span(monkeypatch):
    """``spmv._launch`` times the first launch of a wrapper and every
    ``SAMPLE``-th after it; each launch is counted all the same."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(FakeEvent, "record", lambda self, stream: setattr(
        self, "at", time.perf_counter()))
    wrapper = spmv.dia_pair_shared
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "variants", {"f32": 0})
    stripes = torch.zeros(1)
    tracing.enable()
    for _ in range(2 * tracing.SAMPLE + 1):
        spmv._launch(wrapper, lambda stream: 0, stripes, variant="f32")
    kernels = tracing.spans()
    assert wrapper.launches == 2 * tracing.SAMPLE + 1 == wrapper.variants["f32"]
    assert len(kernels) == 3 and {s.name for s in kernels} == {"kernel"}
    assert all(s.attrs["work"] == "pair" and s.attrs["device_s"] >= 0 for s in kernels)


def test_every_counted_wrapper_declares_its_work():
    declared = {fn.kernel_name: fn.work for fn in spmv.KERNELS}
    assert set(declared.values()) <= {"pair", "product", "iterations", "copy"}
    for name in ("dia_pair_shared", "dia_pair", "zdia_pair", "wcoo_pair", "wwcoo_pair",
                 "block_ell_pair_windowed"):
        assert declared[name] == "pair", name
    for name in ("lsqr_megakernel", "lsmr_megakernel", "craig_megakernel"):
        assert declared[name] == "iterations", name


# --- on the card --------------------------------------------------------------


def pair_kernels(prof):
    """Device seconds of each of the profiler's pair kernels (the staged
    pair and the ring kernel of ``dia_pair_shared``) launched inside a
    ``kernel`` span's range: the profiler links a kernel to the host range
    open at its launch by the launch's correlation id."""
    evs = list(prof.profiler.kineto_results.events())
    ranges = {e.correlation_id() for e in evs if e.name() == tracing.PREFIX + "kernel"}
    return [e.duration_ns() / 1e9 for e in evs
            if str(e.device_type()).endswith("CUDA") and "dia_pair" in e.name()
            and e.linked_correlation_id() in ranges]


@pytest.mark.cuda
def test_kernel_spans_time_the_pair_as_the_profiler_does(cuda_device):
    # the benchmark's band and batch (2^23 x 11, +12 on the diagonal: one
    # 64-iteration segment; 16 rows), so the card, not the host, sets the
    # pace under the profiler: where the card waits on the host (2^22 x 16
    # rows), a launch's events also hold its launch latency
    A = band(cuda_device, m=2 ** 23, offsets=tuple(range(-5, 6)), boost=12.0)
    B = rhs(16, m=2 ** 23, device=cuda_device)
    lt.lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6)  # warm
    torch.cuda.synchronize()
    tracing.clear()

    def solve():
        out = lt.lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6)
        torch.cuda.synchronize()
        return out

    _, prof = profiled(solve, cuda=True)
    pairs = [s for s in tracing.spans() if s.name == "kernel"
             and s.attrs["kernel_name"] == "dia_pair_shared"]
    assert pairs and all(s.attrs["device_s"] > 0 for s in pairs)
    # the sum prog_pair_roofline divides by, against the profiler's time of
    # the same launches; the events also hold each launch's start on the
    # card (a few µs of a 0.2 ms pair)
    seen = pair_kernels(prof)
    assert len(seen) == len(pairs)
    ours, theirs = sum(s.attrs["device_s"] for s in pairs), sum(seen)
    assert theirs > 0 and abs(ours - theirs) <= 0.05 * theirs, (ours, theirs)


@pytest.mark.cuda
def test_the_band_declares_its_pair_and_the_megakernel_its_k(cuda_device):
    offsets = tuple(range(-5, 6))
    A = band(cuda_device, m=2 ** 16, offsets=offsets, boost=12.0)
    spmv.reset_launch_counts()
    tracing.enable()
    res = lt.lsqr_batch(A, rhs(4, m=2 ** 16, device=cuda_device), 0.01, atol=1e-6,
                        btol=1e-6)
    spans = by_name(tracing.spans())
    entry, = spans["entry"]
    pairs = [s for s in spans["kernel"] if s.attrs["work"] == "pair"]
    assert {s.attrs["kernel_name"] for s in pairs} == {"dia_pair_shared"}
    assert all(s.attrs["rows"] == 1 and s.call == entry.id for s in pairs)
    launched = entry.attrs["launches"]["dia_pair_shared"]
    assert launched == 4 * entry.attrs["iterations_launched"]
    assert entry.attrs["iterations_launched"] <= 64 * len(spans["segment.enqueue"])
    assert len(pairs) == -(-launched // tracing.SAMPLE)
    assert entry.attrs["iterations_needed"] == int(res.itn.max())
    tracing.clear()
    spmv.reset_launch_counts()
    P = band(cuda_device, m=2 ** 16, offsets=offsets, shared=False, boost=12.0)
    lt.lsqr(P, rhs(m=2 ** 16, device=cuda_device), 0.01, megakernel=True, itnlim=32,
            atol=1e-9, btol=1e-9)
    entry, = [s for s in tracing.spans() if s.name == "entry"]
    assert entry.attrs["launches"]["lsqr_megakernel"] == 2
    launches = [s for s in tracing.spans() if s.name == "kernel"
                and s.attrs["work"] == "iterations"]
    assert [s.attrs["iterations"] for s in launches] == [32]  # the first of the two
    assert all(s.attrs["kernel_name"] == "lsqr_megakernel" for s in launches)
    assert all(s.attrs["device_s"] > 0 for s in launches)
