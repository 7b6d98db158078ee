"""One run of one cell: set-up, the measured window, the trace, the check.

The window is a closed loop with one caller: each call draws its
right-hand sides on the device from (seed, call index), calls the
traffic's entry on the operator the traffic's builder made, and ends in
``torch.cuda.synchronize()``; the next call starts when it returns. The
window closes at the first call that ends ``--seconds`` after the first
began. A reservoir drawn from the seed keeps the answers of
``cells/<workload>.json``'s ``check.calls`` calls, which the plain
reference judges once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import contextlib
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import torch

from perfbench import timeline
from perfbench.common import HERE, MANIFEST, derive, forbidden_loaded, load_json, load_module
from perfbench.reference import lsqr_rows

#: calls that may raise before the window gives up
MAX_FAILED = 3
#: a result's fields that the check reads
FIELDS = ("x", "istop", "itn", "rnorm", "xnorm")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Cell:
    """A workload of the manifest with everything its names lead to."""
    workload: dict
    config: dict
    traffic: dict
    spec: dict              # cells/<workload>.json
    family: object          # families/<family>.py
    manifest: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


def make_cell(workload: dict, config_file, manifest: dict) -> Cell:
    """A cell from its workload entry and its configuration's file."""
    config = load_json(config_file)
    return Cell(
        workload=workload, config=config,
        traffic=load_json(HERE / "traffic" / f"{workload['traffic']}.json"),
        spec=load_json(HERE / "cells" / f"{workload['name']}.json"),
        family=load_module(HERE / "families" / f"{config['family']}.py", config["family"]),
        manifest=manifest)


def load_cell(name: str, manifest_path=MANIFEST) -> Cell:
    """The manifest's workload ``name``."""
    manifest = load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    entry = {c["name"]: c for c in manifest["configs"]}[cells[name]["config"]]
    return make_cell(cells[name], manifest_path.parent / entry["file"], manifest)


def metrics_of(cell: Cell, traced: bool) -> list:
    """The manifest's metrics that this cell reports in this kind of run."""
    group = cell.manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell.name in m.get("workloads", [cell.name])]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(lt, cell: Cell, inputs, device, control=False):
    """(operator, seconds): the traffic's builder on the family's inputs,
    with a synchronize; ``control`` builds the family's lower-precision
    control instead."""
    kwargs = {}
    if control:
        inputs, kwargs = cell.family.control(cell.config, inputs)
    builder = getattr(lt, cell.traffic["builder"])
    sync(device)
    t0 = time.perf_counter()
    A = builder(*cell.family.builder_args(cell.config, inputs), **kwargs)
    sync(device)
    return A, time.perf_counter() - t0


def rhs(cell: Cell, seed: int, index: int, device) -> torch.Tensor:
    """Call ``index``'s right-hand sides: (rows, m) N(0, 1) f32 drawn on
    ``device`` from (seed, index); a vector where the entry takes one."""
    rows, m = int(cell.traffic["rows"]), int(cell.config["m"])
    g = torch.Generator(device=device).manual_seed(derive(seed, "rhs", index))
    B = torch.randn((rows, m), generator=g, device=device, dtype=torch.float32)
    return B if cell.traffic["batched"] else B[0]


def call(lt, cell: Cell, A, B):
    """One call of the traffic's entry."""
    entry = getattr(lt, cell.traffic["entry"])
    return entry(A, B, float(cell.config["damp"]), **cell.traffic["options"])


def answer(res) -> dict:
    """The fields of a result that the check reads, as (rows, ...) tensors."""
    out = {}
    for name in FIELDS:
        value = getattr(res, name)
        out[name] = value if value.dim() == (2 if name == "x" else 1) else value.unsqueeze(0)
    return out


def iterations_launched(cell: Cell, counts: dict, per_launch: Optional[list]) -> int:
    """Iterations the traced calls launched, from what ran: the launches
    of the traffic's ``iterations.counter`` (``counts``: the program's
    launch counters over those calls) divided by the right-hand sides, as
    a pair a right-hand side an iteration; or, where the traffic names
    ``iterations.per_launch_keyword``, the sum of that keyword over the
    launcher's calls (``per_launch``, one value a launch: a megakernel
    launch runs K iterations). 0 where the two do not agree."""
    spec = cell.traffic["iterations"]
    launches = int(counts.get(spec["counter"], 0))
    if "per_launch_keyword" not in spec:
        return launches // int(cell.traffic["rows"])
    if (per_launch is None or len(per_launch) != launches
            or not all(isinstance(k, int) and k > 0 for k in per_launch)):
        seen = None if per_launch is None else len(per_launch)
        log(f"iterations launched unread: {launches} launches of {spec['counter']}, "
            f"keyword {spec['per_launch_keyword']} seen on {seen} calls")
        return 0
    return sum(per_launch)


class _Recording:
    """Stands in for a counted launcher of the program: records one keyword
    of each call, and passes the call and every attribute to the launcher
    (its launch counters among them)."""

    def __init__(self, fn, keyword: str, seen: list):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_keyword", keyword)
        object.__setattr__(self, "_seen", seen)

    def __call__(self, *args, **kwargs):
        self._seen.append(kwargs.get(self._keyword))
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def launch_keywords(counter: str, keyword: str):
    """While open, the value of ``keyword`` in each call of the program's
    launcher counted as ``counter`` (``spmv.launch_counts()``), as its
    module's callers look it up; None where no such launcher is found."""
    from lsqr_tpu_torch.ops import spmv

    found = [fn for fn in spmv.KERNELS if getattr(fn, "kernel_name", None) == counter]
    module = sys.modules.get(found[0].__module__) if len(found) == 1 else None
    if module is None or getattr(module, found[0].__name__, None) is not found[0]:
        yield None
        return
    fn, seen = found[0], []
    setattr(module, fn.__name__, _Recording(fn, keyword, seen))
    try:
        yield seen
    finally:
        setattr(module, fn.__name__, fn)


@dataclass
class Window:
    calls: int = 0
    failed: int = 0
    seconds: float = 0.0
    call_s: list = field(default_factory=list)
    itn_max: list = field(default_factory=list)   # device tensors, one a call
    kept: dict = field(default_factory=dict)      # call index -> answer
    summary: Optional[timeline.Summary] = None
    traced_counts: dict = field(default_factory=dict)
    traced_itn: int = 0
    traced_calls: int = 0
    traced_iterations: int = 0                    # iterations launched in them


def run_window(lt, cell: Cell, A, seed, seconds, device, traced: bool) -> Window:
    """The closed loop for ``seconds``; with ``traced``, the first
    ``trace.calls`` calls of the cell run under the profiler."""
    from lsqr_tpu_torch.ops import spmv

    win = Window()
    keep = int(cell.spec["check"]["calls"])
    sample = random.Random(derive(seed, "sample"))
    n_traced = int(cell.spec["trace"]["calls"]) if traced else 0
    iterations = cell.traffic["iterations"]
    prof = stack = per_launch = None
    start = time.perf_counter()
    while True:
        i = win.calls + win.failed
        if i == 0 and n_traced:
            from torch.profiler import ProfilerActivity, profile

            stack = contextlib.ExitStack()
            if "per_launch_keyword" in iterations:
                per_launch = stack.enter_context(launch_keywords(
                    iterations["counter"], iterations["per_launch_keyword"]))
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            before = spmv.launch_counts()
        B = rhs(cell, seed, i, device)
        sync(device)
        t0 = time.perf_counter()
        try:
            if prof is not None:
                with torch.profiler.record_function(timeline.CALL):
                    res = call(lt, cell, A, B)
                    sync(device)
            else:
                res = call(lt, cell, A, B)
                sync(device)
        except Exception:  # the answer never comes: counted, judged below
            log(f"call {i} raised:\n{traceback.format_exc()}")
            win.failed += 1
            res = None
        t1 = time.perf_counter()
        del B
        answered = res is not None
        if answered:
            win.calls += 1
            win.call_s.append(t1 - t0)
            win.itn_max.append(res.itn.max())
            # reservoir sampling of the answers the check will judge
            if len(win.kept) < keep:
                win.kept[i] = answer(res)
            else:
                j = sample.randrange(win.calls)
                if j < keep:
                    del win.kept[sorted(win.kept)[j]]
                    win.kept[i] = answer(res)
            del res
        if prof is not None and (i + 1 == n_traced or not answered):
            after = spmv.launch_counts()
            stack.close()
            win.traced_counts = {k: after[k] - before.get(k, 0) for k in after}
            win.traced_calls = i + 1
            win.traced_itn = int(sum(int(t) for t in win.itn_max[:win.traced_calls]))
            win.traced_iterations = iterations_launched(cell, win.traced_counts, per_launch)
            win.summary = timeline.summarize(timeline.events(prof))
            prof = None
        if (t1 - start >= seconds and prof is None) or win.failed >= MAX_FAILED:
            break
    win.seconds = time.perf_counter() - start
    return win


# --- the check ---------------------------------------------------------------


def readings(program: dict, ref: dict) -> dict:
    """The numbers of one call's answers against the reference's, each the
    worst over the rows: the relative gap of x to the reference's answer
    and to its iterate at the program's own itn, |itn - itn_ref|, the rows
    whose istop differs, and the relative gap of rnorm."""
    x = program["x"].to(torch.float64)
    itn = program["itn"].to(torch.int64)

    def rel(a, b):
        den = torch.linalg.vector_norm(b, dim=1)
        num = torch.linalg.vector_norm(a - b, dim=1)
        return float(torch.where(den > 0, num / torch.where(den > 0, den, 1.0), num).max())

    rnorm = program["rnorm"].to(torch.float64)
    return {
        "x_err": rel(x, ref["x"]),
        "x_step_err": rel(x, ref["x_at"]),
        "itn_gap": int((itn - ref["itn"]).abs().max()),
        "istop_diff": int((program["istop"].to(torch.int64) != ref["istop"]).sum()),
        "rnorm_err": float(((rnorm - ref["rnorm"]).abs() / ref["rnorm"]).max()),
    }


def reference_of(cell: Cell, seed, device):
    """(forward, adjoint): the reference's float64 products on the
    benchmark's own inputs, made again from the seed."""
    inputs = cell.family.make(cell.config, seed, device)
    return cell.family.products(cell.config, inputs, torch.float64)


def sample_rows(cell: Cell, seed: int, index: int) -> Optional[list]:
    """The rows of call ``index`` that the check judges: all (None), or
    ``check.rows`` of them drawn from (seed, index)."""
    rows, take = int(cell.traffic["rows"]), cell.spec["check"].get("rows")
    if take is None or int(take) >= rows:
        return None
    return sorted(random.Random(derive(seed, "rows", index)).sample(range(rows), int(take)))


def judge_one(cell: Cell, products, B, prog: dict, rows=None) -> dict:
    """The readings of one call's answers ``prog`` against the reference
    on its right-hand sides ``B``, on ``rows`` of them (None: all)."""
    opts = cell.traffic["options"]
    B = B if B.dim() == 2 else B.unsqueeze(0)
    prog = {k: v.to(B.device) for k, v in prog.items()}
    if rows is not None:
        B, prog = B[rows], {k: v[rows] for k, v in prog.items()}
    ref = lsqr_rows(*products, B, float(cell.config["damp"]),
                    atol=float(opts["atol"]), btol=float(opts["btol"]),
                    itnlim=int(opts.get("itnlim", 4 * int(cell.config["n"]))),
                    snap_at=prog["itn"])
    got = readings(prog, ref)
    log(f"  itn {prog['itn'].tolist()[:16]} ref {ref['itn'].tolist()[:16]}; istop "
        f"{sorted(set(prog['istop'].tolist()))} ref {sorted(set(ref['istop'].tolist()))}")
    return got


def judge(cell: Cell, products, seed, kept: dict, device) -> dict:
    """The worst readings over the kept calls, each against the reference
    on the same right-hand sides; an empty sample reads nothing."""
    worst = {}
    for i, prog in sorted(kept.items()):
        got = judge_one(cell, products, rhs(cell, seed, i, device), prog,
                        sample_rows(cell, seed, i))
        log(f"check call {i}: {got}")
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def verdict(spec: dict, worst: dict, failed: int):
    """(correct, {number: {value, limit}}): every compared number at or
    under its limit, a sample that read something, and no failed call."""
    limits = spec["check"]["limits"]
    compared = {k: {"value": worst.get(k), "limit": lim} for k, lim in limits.items()}
    ok = bool(worst) and failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


def refuse_forbidden_modules():
    found = forbidden_loaded(sys.modules)
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        raise SystemExit(3)


def device_info(device, peak_bytes, count=1) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": int(count), "memory_peak_bytes": int(peak_bytes)}
