#!/usr/bin/env python3
"""Where a benchmark cell's calls spend their time and the card its idle
time, by the program's spans (``lsqr_tpu_torch.tracing``).

    python3 tools/span_breakdown.py --workload band11.mk --seed 7 [--calls N] [--small]

From the root of a checkout, on the card; it refuses to run the cell
without one. ``--small`` runs the CPU at the test sizes of
``perfbench/tests/_small.py``. It builds the cell's operator and
runs its calls as ``perfbench/run.py --trace 1`` does: the cell's
``trace.calls`` calls (or ``--calls``) under ``torch.profiler``, each in a
``perfbench.call`` annotation and ended by a synchronize. Then, per span
name, it prints the time a call spent in those spans and the card's idle
time inside them: the gaps of the union of device intervals (kernels,
copies, sets) in the calls' wall span, each piece given to the innermost
span over it, and to "between calls" where none is.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import lsqr_tpu_torch as lt  # noqa: E402
from lsqr_tpu_torch import tracing  # noqa: E402
from perfbench import core, timeline  # noqa: E402

#: the pieces (ns) an idle gap is cut into to find the span over each
STEP = 20_000


def traced_calls(cell, seed, calls, device):
    """The profiler's events and the program's spans of ``calls`` calls."""
    inputs = cell.family.make(cell.config, seed, device)
    A, _ = core.build(lt, cell, inputs, device)
    core.call(lt, cell, A, core.rhs(cell, seed, -1, device))
    core.sync(device)
    tracing.clear()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        for i in range(calls):
            B = core.rhs(cell, seed, i, device)
            core.sync(device)
            with torch.profiler.record_function(timeline.CALL):
                core.call(lt, cell, A, B)
                core.sync(device)
    return timeline.events(prof), [s for s in tracing.spans() if s.name != "kernel"]


def breakdown(evs, spans):
    """(wall, busy, idle) ns of the calls, and per span name its total time
    and the idle ns inside it (innermost span first)."""
    calls = [e for e in evs if e.kind == "call"]
    t0, t1 = min(e.start for e in calls), max(e.end for e in calls)
    busy = timeline.union((max(e.start, t0), min(e.end, t1)) for e in evs
                          if e.kind in timeline.DEVICE_KINDS and e.end > t0 and e.start < t1)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    total, idle = {}, {}
    for s in spans:
        total[s.name] = total.get(s.name, 0) + s.end_ns - s.start_ns

    def owner(t):
        over = [s for s in spans if s.start_ns <= t < s.end_ns]
        return min(over, key=lambda s: s.end_ns - s.start_ns).name if over else "between calls"

    for g0, g1 in gaps:
        for t in range(g0, g1, STEP):
            step = min(STEP, g1 - t)
            name = owner(t + step // 2)
            idle[name] = idle.get(name, 0) + step
    busy_ns = sum(e - s for s, e in busy)
    return (t1 - t0, busy_ns, t1 - t0 - busy_ns), total, idle


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=None)
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    if args.small:
        from perfbench.tests import _small

        cell, device = _small.cell(args.workload), torch.device("cpu")
    elif torch.cuda.is_available():
        cell, device = core.load_cell(args.workload), torch.device("cuda", 0)
    else:
        raise SystemExit("no CUDA device: the cell's breakdown is the card's (--small "
                         "for the CPU at test sizes)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    n = args.calls or int(cell.spec["trace"]["calls"])
    (wall, busy, idle_ns), total, idle = breakdown(*traced_calls(cell, args.seed, n, device))
    print(f"{args.workload} on {name}: {n} calls, {wall / n / 1e6:.4f} ms a call, busy "
          f"{busy / n / 1e6:.4f}, idle {idle_ns / n / 1e6:.4f}")
    for name in sorted(set(total) | set(idle), key=lambda k: -idle.get(k, 0)):
        print(f"  {name:18s} {total.get(name, 0) / n / 1e6:9.4f} ms a call, idle inside "
              f"{idle.get(name, 0) / n / 1e6:8.4f}")


if __name__ == "__main__":
    main()
