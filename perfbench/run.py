"""Run one cell of the benchmark of ``lsqr_tpu_torch`` and print its result.

    python3 perfbench/run.py --workload band11.batch16 --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up makes the cell's inputs on the card from ``--seed``, builds the
operator with the user's builder, warms the cell's shapes with one call,
then the window runs calls for ``--seconds``. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics (a slice of
calls under ``torch.profiler``). After the window the plain reference
judges a sample of the answers. The last line of standard output is one
JSON object; the numbers the check compared, with their limits, are the
last lines of standard error. Exits nonzero, printing no result, without
the card(s), or where JAX or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# the repository root, not this folder, leads the module path: the
# harness's modules are the package ``perfbench`` and shadow nothing
_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from perfbench import core  # noqa: E402
from perfbench.common import HERE, load_module  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup(cell, seed, device, parts):
    """(lsqr_tpu_torch, operator): the program imported, its kernels
    built or loaded, the inputs made, the operator built, one warm call."""
    parts["torch_import"] = T_TORCH - T_START
    t = time.perf_counter()
    import lsqr_tpu_torch as lt

    parts["program_import"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        torch.empty(1, device=device)
    parts["cuda_start"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        from lsqr_tpu_torch import native
        from lsqr_tpu_torch.ops import _cuda

        _cuda.library()
        native.available()
    parts["library"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = cell.family.make(cell.config, seed, device)
    core.sync(device)
    parts["generate"] = time.perf_counter() - t
    A, parts["operator_build"] = core.build(lt, cell, inputs, device)
    del inputs
    t = time.perf_counter()
    core.call(lt, cell, A, core.rhs(cell, seed, -1, device))
    core.sync(device)
    parts["warm_call"] = time.perf_counter() - t
    return lt, A


def read_metrics(cell, ctx, traced):
    """{name: {value, unit}} of this run's metrics; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for metric in core.metrics_of(cell, traced):
        reader = load_module(HERE / "metrics" / f"{metric['name']}.py", metric["name"])
        value = reader.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def run(args, device, cell=None):
    """The result of one run (the dict printed as the last line)."""
    cell = cell or core.load_cell(args.workload)
    traced = bool(args.trace)
    parts = {}
    lt, A = setup(cell, args.seed, device, parts)
    setup_s = time.perf_counter() - T_START
    core.log("setup parts (s): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
             + f"; setup_s {setup_s:.4f}")
    win = core.run_window(lt, cell, A, args.seed, args.seconds, device, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    core.refuse_forbidden_modules()
    core.log(f"window: {win.calls} calls, {win.failed} failed, {win.seconds:.4f} s; "
             f"largest itn of the first calls {[int(t) for t in win.itn_max[:8]]}")
    ctx = SimpleNamespace(
        cell=cell, device=device, setup_s=setup_s, build_s=parts["operator_build"],
        window=win, peak_bytes=peak, iterations=win.traced_iterations)
    metrics = read_metrics(cell, ctx, traced)
    if traced and device.type == "cuda":
        from lsqr_tpu_torch.ops.roofline import stream_ceiling

        core.log(f"context: streaming ceiling {stream_ceiling(device):.1f} GB/s (3350 is "
                 "the data sheet's peak, which the rooflines use)")
    del A, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = core.judge(cell, core.reference_of(cell, args.seed, device), args.seed, win.kept,
                       device)
    correct, compared = core.verdict(cell.spec, worst, win.failed)
    core.refuse_forbidden_modules()
    result = {"correct": correct, "attempted": win.calls + win.failed, "failed": win.failed,
              "metrics": metrics,
              "device": (core.device_info(device, peak) if device.type == "cuda"
                         else {"platform": "cpu", "kind": "cpu", "count": 1,
                               "memory_peak_bytes": 0})}
    if traced and win.summary is not None:
        s = win.summary
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["check"] = compared
    for name, c in compared.items():
        core.log(f"check {name} {c['value']} limit {c['limit']}")
    return result


def main(argv=None):
    args = parse(argv)
    cell = core.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"{cell.name} needs {chips} CUDA device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args, torch.device("cuda", 0), cell)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
