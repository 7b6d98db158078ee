"""The trace summary and every metric reader on synthetic tables."""

from types import SimpleNamespace

import pytest

from perfbench import core, roofline, timeline
from perfbench.common import HERE, load_module
from perfbench.timeline import Event

MS = 1_000_000  # ns


def synthetic():
    """Two traced calls over 0-10 ms; kernels at 1-3, 2-4 (overlapping),
    a memcpy at 6-7; the host in aten::where over 4-6 and outside torch
    ops over 7-10."""
    return [
        Event(0, 5 * MS, timeline.CALL, "call"),
        Event(5 * MS, 10 * MS, timeline.CALL, "call"),
        Event(1 * MS, 3 * MS, "void (anonymous namespace)::pair_kernel<float, 4>(float const*)",
              "kernel"),
        Event(2 * MS, 4 * MS, "elementwise", "kernel"),
        Event(6 * MS, 7 * MS, "Memcpy DtoH", "gpu_memcpy"),
        Event(4 * MS, 6 * MS, "aten::where", "cpu_op"),
        Event(4 * MS + 10, 5 * MS, "cudaLaunchKernel", "cuda_runtime"),
        Event(0, 1 * MS, "aten::randn", "cpu_op"),
    ]


def test_summary_of_a_synthetic_timeline():
    s = timeline.summarize(synthetic())
    assert s.calls == 2 and s.kernels == 2
    assert s.kernel_s == pytest.approx(4e-3)
    assert s.busy_s == pytest.approx(4e-3)        # [1, 4] and [6, 7]
    assert s.window_s == pytest.approx(10e-3)
    assert s.idle_share == pytest.approx(0.6)
    assert s.device_ops[0] == ["void (anonymous namespace)::pair_kernel<float, 4>(float const*)",
                               pytest.approx(2e-3)]
    assert s.by_kernel == {"pair_kernel": [1, pytest.approx(2e-3)],
                           "elementwise": [1, pytest.approx(2e-3)]}
    gaps = dict(s.idle_gaps)
    assert gaps == {"aten::randn": pytest.approx(1e-3), "aten::where": pytest.approx(2e-3),
                    timeline.OUTSIDE: pytest.approx(3e-3)}


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::lsqr_megakernel_staged<float>((anonymous namespace)::Params<float>)",
     "lsqr_megakernel_staged"),
    ("void dia_pair_kernel<float, 4, true>(float const*, long long)", "dia_pair_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float> >(int)",
     "vectorized_elementwise_kernel"),
    ("dia_pair_ring_kernel(float const*)", "dia_pair_ring_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_base_names_of_kernels(name, base):
    assert timeline.base_name(name) == base


def test_a_trace_without_calls_is_refused():
    with pytest.raises(ValueError):
        timeline.summarize(synthetic()[2:])


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", name)


def ctx(**window):
    cell = SimpleNamespace(config={"m": 2 ** 23, "n": 2 ** 23, "offsets": list(range(-5, 6))},
                           family=load_module(HERE / "families" / "band.py", "band"),
                           traffic={"rows": 16, "pair": {"counter": "pairs",
                                                         "kernels": ["pair_kernel", "other"]}})
    summary = timeline.summarize(synthetic())
    win = core.Window(calls=4, seconds=2.0, call_s=[0.4] * 4, summary=summary,
                      traced_itn=50, traced_counts={"pairs": 10, "unrelated": 3})
    for k, v in window.items():
        setattr(win, k, v)
    return SimpleNamespace(cell=cell, window=win, iterations=128, setup_s=12.5, build_s=0.75,
                           peak_bytes=3 * 2 ** 30, device=SimpleNamespace(type="cpu"))


def test_end_to_end_readers():
    c = ctx()
    assert reader("solve_ms").read(c) == pytest.approx(500.0)
    assert reader("setup_s").read(c) == 12.5
    assert reader("peak_mem_gib").read(c) == pytest.approx(3.0)
    assert reader("operator_build_s").read(c) == 0.75
    assert reader("solve_p95_ms").read(c) is None  # fewer than 200 calls
    times = [i / 1000 for i in range(1, 301)]
    assert reader("solve_p95_ms").read(ctx(call_s=times)) == pytest.approx(285.05)
    assert reader("solve_ms").read(ctx(calls=0)) is None


def test_layer_readers():
    c = ctx()
    assert reader("launches_per_iter").read(c) == pytest.approx(2 / 128)
    assert reader("masked_iter_share").read(c) == pytest.approx(100 * (1 - 50 / 128))
    assert reader("device_idle_share").read(c) == pytest.approx(60.0)
    nbytes = roofline.work_bytes(11 * 2 ** 23 - 30, 2 ** 23, 2 ** 23, "lsqr_iteration")
    assert reader("mk_roofline").read(c) == pytest.approx(
        100 * 50 * nbytes / 3.35e12 / 4e-3)
    pair = roofline.work_bytes(11 * 2 ** 23 - 30, 2 ** 23, 2 ** 23, "pair")
    assert reader("pair_roofline").read(c) == pytest.approx(100 * 10 * pair / 3.35e12 / 2e-3)


def test_the_pair_roofline_finds_nothing_without_its_pairs():
    c = ctx(traced_counts={"unrelated": 3})
    assert reader("pair_roofline").read(c) is None
    c = ctx()
    c.cell.traffic = {"rows": 16}
    assert reader("pair_roofline").read(c) is None
    c = ctx()
    c.cell.traffic["pair"]["kernels"] = ["absent_kernel"]
    assert reader("pair_roofline").read(c) is None


@pytest.mark.parametrize("name", ["launches_per_iter", "masked_iter_share", "mk_roofline",
                                  "device_idle_share", "pair_roofline"])
def test_layer_readers_find_nothing_without_a_trace(name):
    assert reader(name).read(ctx(summary=None)) is None


def cell_with(iterations, rows=4):
    return SimpleNamespace(traffic={"rows": rows, "iterations": iterations})


def test_iterations_launched_a_pair_a_row():
    cell = cell_with({"counter": "pairs"})
    assert core.iterations_launched(cell, {"pairs": 256, "other": 9}, None) == 64


def test_iterations_launched_from_each_launch_keyword():
    cell = cell_with({"counter": "mk", "per_launch_keyword": "K"}, rows=1)
    assert core.iterations_launched(cell, {"mk": 3}, [32, 32, 8]) == 72
    # a launch unseen, an unread keyword, or no launcher: nothing to read
    assert core.iterations_launched(cell, {"mk": 3}, [32, 32]) == 0
    assert core.iterations_launched(cell, {"mk": 2}, [32, None]) == 0
    assert core.iterations_launched(cell, {"mk": 2}, None) == 0


def test_launch_keywords_records_what_each_launch_was_given():
    """The megakernel's launcher on the CPU (its plain twin): each call's K
    is recorded, the counters the card's launches bump reach the launcher
    itself, and the launcher is restored after."""
    import torch

    from lsqr_tpu_torch.ops import megakernel as mk

    original = mk.lsqr_megakernel_call
    launches = original.launches
    n = 64
    with core.launch_keywords("lsqr_megakernel", "K") as seen:
        stand_in = mk.lsqr_megakernel_call  # looked up through the module, as the solver does
        assert stand_in is not original and stand_in.kernel_name == "lsqr_megakernel"
        data = torch.ones((1, n))
        (u, v, x, w), state = mk.lsqr_megakernel_prepare(
            SimpleNamespace(n=n, m=n, device=data.device, rmatvec=lambda t: t), torch.ones(n),
            itnlim=8)
        for K in (3, 5):
            stand_in(data, data, u, v, x, w, state, offsets=(0,), m=n, n=n, K=K)
        stand_in.launches += 2
    assert seen == [3, 5] and mk.lsqr_megakernel_call is original
    assert original.launches == launches + 2
    original.launches = launches
    with core.launch_keywords("no_such_counter", "K") as seen:
        assert seen is None
