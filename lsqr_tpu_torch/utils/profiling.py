"""Profiling hooks: a trace of the card's kernels and a product-rate meter.

PyTorch counterpart of :mod:`lsqr_tpu.utils.profiling`. ``trace`` records
the host and CUDA activity of its block with ``torch.profiler`` and writes
a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``;
``product_rate`` times a chain of operator products with CUDA events on the
card (with the host's clock on the CPU).

Inside ``trace`` the solvers' own spans are on
(:mod:`lsqr_tpu_torch.tracing`): the Chrome trace shows each call's
``lsqr_tpu_torch.prepare``, ``segment.enqueue`` / ``segment.read`` or
``mk.launch`` / ``mk.wait``, ``finalize`` and a ``kernel`` over one
counted launch in ``tracing.SAMPLE`` on the host thread, above the device
lanes that run what they launched; ``tracing.spans()`` gives the same
spans with their attributes (a kernel's event-timed ``device_s``), and
each call's ``entry`` with its counter deltas, after the block.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

__all__ = ["trace", "product_rate"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``trace_<pid>_<time>.json`` (Chrome trace format) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def product_rate(A, *, iters: int = 50, pair: bool = True) -> dict:
    """The SpMV (+ SpMV-T) rate of an operator: {"seconds_per_product",
    "gnnz_per_s" (where the operator has ``nnz``), "iters"}.

    ``pair=True`` times matvec then rmatvec per step (an LSQR iteration's
    products), else matvec alone (square operators only). The steps form a
    chain (each one's input is the last one's output times 1e-3, which
    keeps it finite without another pass over the vector); one warm-up
    chain, then the timed one between CUDA events on the card."""
    if not pair and A.m != A.n:
        raise ValueError("pair=False requires a square operator")
    dtype = A.dtype or torch.float32
    x0 = torch.ones(A.n, dtype=dtype, device=A.device)
    cuda = x0.is_cuda

    def run(x):
        for _ in range(iters):
            y = A.matvec(x)
            z = A.rmatvec(y) if pair else y
            x = z * 1e-3
        return x

    float(run(x0).sum())  # warm-up and sync
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(x0)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        out = run(x0)
        float(out.sum())
        dt = (time.perf_counter() - t0) / iters
    result = {"seconds_per_product": dt, "iters": iters}
    nnz = getattr(A, "nnz", None)
    if nnz:
        result["gnnz_per_s"] = (2 if pair else 1) * nnz / dt / 1e9
    return result
