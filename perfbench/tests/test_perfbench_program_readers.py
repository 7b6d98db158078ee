"""The readers of the program's own spans and counters on synthetic span
lists, and their silence where the program records none."""

import sys
from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from perfbench import roofline
from perfbench.common import HERE, load_module

READERS = ["prog_masked_iter_share", "prog_pair_roofline", "prog_call_host_ms"]
MS = 1_000_000  # ns
M = 2 ** 23
VALUES = 11 * M - 30  # the band's stored values (perfbench.families.band)


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    call: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", name)


def ctx(traced_calls=2):
    cell = SimpleNamespace(config={"m": M, "n": M, "offsets": list(range(-5, 6))},
                           family=load_module(HERE / "families" / "band.py", "band"))
    return SimpleNamespace(cell=cell, window=SimpleNamespace(traced_calls=traced_calls))


def synthetic():
    """An earlier call (id 1) and the two traced calls (ids 10 and 20):
    call 10 over 0-10 ms, a 64-iteration segment over 2-8 ms, itn 31, two
    pair kernels (rows 1 and 2) and a product; call 20 over 20-24 ms, two
    megakernel launches of K = 32 over 21-23 ms, itn 32."""
    def entry(i, t0, t1, launched, needed):
        return Span(i, None, i, "entry", t0 * MS, t1 * MS,
                    {"entry": "lsqr", "rows": 1, "iterations_launched": launched,
                     "iterations_needed": needed})

    return [
        entry(1, -50, -40, 64, 2),
        Span(2, 1, 1, "kernel", -48 * MS, -47 * MS, {"work": "pair", "rows": 1,
                                                     "device_s": 1.0}),
        Span(11, 10, 10, "prepare", 1 * MS, 2 * MS, {}),
        Span(12, 10, 10, "segment.enqueue", 2 * MS, 7 * MS, {"seg": 64}),
        Span(13, 12, 10, "kernel", 3 * MS, 4 * MS, {"work": "pair", "rows": 1,
                                                    "device_s": 2e-4}),
        Span(14, 12, 10, "kernel", 4 * MS, 5 * MS, {"work": "pair", "rows": 2,
                                                    "device_s": 3e-4}),
        Span(15, 12, 10, "kernel", 5 * MS, 6 * MS, {"work": "product", "device_s": 1e-4}),
        Span(16, 10, 10, "segment.read", 7 * MS, 8 * MS, {"itn": 31}),
        Span(17, 10, 10, "finalize", 8 * MS, 9 * MS, {}),
        entry(10, 0, 10, 64, 31),
        Span(21, 20, 20, "mk.launch", 21 * MS, 22 * MS, {"K": 32}),
        Span(22, 20, 20, "mk.launch", 22 * MS, 22 * MS + MS // 2, {"K": 32}),
        Span(23, 20, 20, "mk.wait", 22 * MS + MS // 2, 23 * MS, {}),
        Span(24, 21, 20, "kernel", 21 * MS, 22 * MS, {"work": "iterations",
                                                     "iterations": 32, "device_s": 3e-3}),
        entry(20, 20, 24, 64, 32),
    ]


def test_the_masked_share_counts_the_traced_calls_alone():
    assert reader("prog_masked_iter_share").value(ctx(), synthetic()) == pytest.approx(
        100 * (1 - (31 + 32) / 128))


def test_the_pair_roofline_reads_the_declared_pairs_alone():
    vectors = roofline.work_bytes(0, M, M, "pair")
    nbytes = 2 * 4 * VALUES + 3 * vectors
    assert vectors == 16 * M
    assert reader("prog_pair_roofline").value(ctx(), synthetic()) == pytest.approx(
        100 * nbytes / 3.35e12 / 5e-4)
    # one right-hand side's pair is the roofline rule's pair
    one = [Span(1, None, 1, "entry", 0, 1, {}),
           Span(2, 1, 1, "kernel", 0, 1, {"work": "pair", "rows": 1, "device_s": 2e-4})]
    assert reader("prog_pair_roofline").value(ctx(1), one) == pytest.approx(
        roofline.share_percent(roofline.work_bytes(VALUES, M, M, "pair"), 2e-4))


def test_the_call_host_time_leaves_out_the_loop():
    # call 10: 10 ms less the 5 + 1 ms of its segment; call 20: 4 ms less
    # the 1 + 0.5 + 0.5 ms of its launches and wait
    assert reader("prog_call_host_ms").value(ctx(), synthetic()) == pytest.approx(
        (4.0 + 2.0) / 2)


def test_a_cell_without_pairs_reads_no_pair_roofline():
    spans = [s for s in synthetic() if s.attrs.get("work") != "pair"]
    assert reader("prog_pair_roofline").value(ctx(), spans) is None


@pytest.mark.parametrize("name", READERS)
def test_the_readers_find_nothing_without_spans(name):
    assert reader(name).value(ctx(), []) is None
    # fewer entries than traced calls: the calls were not recorded
    assert reader(name).value(ctx(4), synthetic()) is None


@pytest.mark.parametrize("name", READERS)
def test_the_readers_find_nothing_where_the_program_records_none(name):
    from lsqr_tpu_torch import tracing

    tracing.clear()
    assert reader(name).read(ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_the_readers_find_nothing_without_the_tracing_module(name, monkeypatch):
    import lsqr_tpu_torch

    monkeypatch.delattr(lsqr_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "lsqr_tpu_torch.tracing", None)
    assert reader(name).read(ctx()) is None


def test_the_readers_read_the_programs_spans():
    """A small solve recorded by the program: the masked share and the host
    time read; the CPU launches no kernel, so no pair is read."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch import tracing

    data = torch.randn(3, 512, generator=torch.Generator().manual_seed(0))
    data[1] += 6.0
    A = lt.dia_shared_operator(512, 512, (-1, 0, 1), data, device="cpu")
    tracing.clear()
    tracing.enable()
    try:
        res = lt.lsqr(A, torch.ones(512), 0.01, loop_segment=16)
    finally:
        tracing.disable()
    c = ctx(1)
    launched = tracing.counts()["iterations_launched"]
    assert reader("prog_masked_iter_share").read(c) == pytest.approx(
        100 * (1 - int(res.itn) / launched))
    assert reader("prog_call_host_ms").read(c) > 0
    assert reader("prog_pair_roofline").read(c) is None
    tracing.clear()
