"""The card's measured streaming ceiling: an in-place f32 stream copy.

PyTorch counterpart of ``bench.py``'s ``bench_roofline`` (its nested
``stream_copy`` and ``_copy_kernel``), the JAX package's measured streaming
ceiling. The kernel is written by hand in CUDA C++ (csrc/stream_copy.cu)
and has a plain PyTorch twin beside it:

=================  ==========================================  ====================
wrapper            computes                                    source
=================  ==========================================  ====================
stream_copy        x <- x * 1.0000001 in place (f32)           csrc/stream_copy.cu
=================  ==========================================  ====================

:func:`stream_ceiling` times ``k`` chained launches of :func:`stream_copy`
over a (rows, cols) f32 array and returns GB/s = 2 * rows * cols * 4 /
(time / k), as ``bench.py`` does. Its defaults are ``bench.py``'s
``ROOF_ROWS``, ``ROOF_COLS`` and ``ROOF_K``; ``ROOF_BR``/``ROOF_BC`` tile
the TPU's grid and have no meaning here. JAX chains the copies inside one
dispatch (``fori_loop``) to avoid its relay's per-dispatch latency; on the
card, back-to-back launches on one stream pipeline, and a launch's few
microseconds are small beside the ~0.64 ms of copying, so the chain is
``k`` plain launches between two CUDA events. The card first spins for
~10 ms (``torch.cuda._sleep``) while the host queues them, so that a pause
of the host cannot leave the card idle inside the timed chain (without the
spin, one chain on an H100 80GB HBM3 read 2695 GB/s in a run where the
same kernel's mean time gave 2975).

A wrapper given a CPU tensor runs the twin; on CUDA it launches its kernel
or raises, with no fallback. :func:`stream_ceiling` refuses a CPU device: a
streaming ceiling of the card has no meaning there.
"""

from __future__ import annotations

import torch

from . import spmv

__all__ = ["stream_copy", "stream_copy_plain", "stream_ceiling", "SCALE", "ROWS", "COLS",
           "K"]

#: the factor of ``bench.py``'s ``_copy_kernel`` (one f32 rounding)
SCALE = 1.0000001
#: ``bench.py``'s ROOF_ROWS, ROOF_COLS and ROOF_K: 1 GiB of f32, 20 copies
ROWS, COLS, K = 1024, 1 << 18, 20
#: the card's spin before the chain: ~10 ms at the H100's boost clock
#: (1.98 GHz), time for the host to queue the k launches
SPIN_CYCLES = 20_000_000


def stream_copy_plain(x):
    """Plain twin of :func:`stream_copy`: ``x *= SCALE`` in f32, in place
    (the factor a 0-d f32 tensor, which any device's tensor takes)."""
    return x.mul_(torch.tensor(SCALE, dtype=torch.float32))


def stream_copy(x):
    """x <- x * 1.0000001 in place (f32, contiguous); returns x."""
    if not x.is_cuda:
        return stream_copy_plain(x)
    spmv._check("x", x, torch.float32, x.device, tuple(x.shape))
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads 16 bytes a thread)")
    from . import _cuda

    spmv._launch(stream_copy, _cuda.library().lsqr_stream_copy_f32, x, x.data_ptr(),
                 x.numel())
    return x


spmv.register(stream_copy, ("f32",))


def stream_ceiling(device=None, rows=ROWS, cols=COLS, k=K):
    """GB/s of ``k`` chained in-place :func:`stream_copy` launches over a
    (rows, cols) f32 array on the card (``device``: a CUDA device, the
    current one when None), after one warm-up launch, timed with CUDA
    events while the card holds the queued chain back (``SPIN_CYCLES``):
    2 * rows * cols * 4 bytes per launch over the mean time."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"stream_ceiling measures the card; got device {device}")
    with torch.cuda.device(device):
        g = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((rows, cols), generator=g, device=device, dtype=torch.float32)
        stream_copy(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(k):
            stream_copy(x)
        end.record()
        end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / k
    return 2 * rows * cols * 4 / seconds / 1e9
