#!/usr/bin/env python3
"""Launch shapes of ``stream_copy`` against ``x.mul_``, in turns, on one card.

    python3 tools/stream_copy_designs.py [--turns 5] [--reps 20] [--out FILE]

Writes one source per design (threads a block, float4s a thread, streaming
cache hints, reversed block order: ``VARIANT`` below, the kernel of
``lsqr_tpu_torch/csrc/stream_copy.cu`` with those four settings) into
``build/stream_copy_designs/`` and builds each there, with the shipped
``stream_copy.cu`` itself as the design ``1024x1 (shipped)`` (one ``nvcc``
each, all started together). It checks each bit for bit against ``x.mul_``
at ``bench.py``'s roofline shape (1024 x 2^18 f32) and a ragged length,
then times every design and ``x.mul_`` at that shape in turns (design by
design, ``x.mul_`` after each; ``--turns`` rounds) with
``chip_smoke.time_ms`` (the mean device time of ``--reps`` calls). First it
records what ``x.mul_`` launches there (kernel name, grid, block, from a
``torch.profiler`` trace). Prints one JSON object with the card's name and
power limit; ``--out`` also writes it. Needs one CUDA device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

#: name: (threads a block, float4s a thread, streaming hints, reversed order)
DESIGNS = {
    "256x4": (256, 4, 0, 0),
    "128x2": (128, 2, 0, 0),
    "128x4": (128, 4, 0, 0),
    "256x2": (256, 2, 0, 0),
    "256x8": (256, 8, 0, 0),
    "512x2": (512, 2, 0, 0),
    "128x8": (128, 8, 0, 0),
    "1024x1": (1024, 1, 0, 0),
    "512x1": (512, 1, 0, 0),
    "256x1": (256, 1, 0, 0),
    "128x1": (128, 1, 0, 0),
    "1024x2": (1024, 2, 0, 0),
    "1024x1 hints": (1024, 1, 1, 0),
    "128x2 hints": (128, 2, 1, 0),
    "256x4 hints": (256, 4, 1, 0),
    "256x4 reversed": (256, 4, 0, 1),
}

#: the shipped kernel with the four settings of a design (the tail launch
#: as shipped)
VARIANT = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = THREADS;
constexpr int kUnroll = UNROLL;
constexpr float kScale = 1.0000001f;

__global__ void __launch_bounds__(kThreads) stream_copy_kernel(float4* __restrict__ x4,
                                                               long long len4) {
  const long long block = REVERSE ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const long long base = block * kThreads * kUnroll + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (base + k * kThreads < len4) v[k] = HINTS ? __ldcs(x4 + base + k * kThreads)
                                                 : x4[base + k * kThreads];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (base + k * kThreads < len4) {
      v[k].x *= kScale;
      v[k].y *= kScale;
      v[k].z *= kScale;
      v[k].w *= kScale;
      if (HINTS) {
        __stcs(x4 + base + k * kThreads, v[k]);
      } else {
        x4[base + k * kThreads] = v[k];
      }
    }
  }
}

__global__ void stream_copy_tail(float* __restrict__ x, long long from, long long len) {
  const long long i = from + threadIdx.x;
  if (i < len) x[i] *= kScale;
}

}  // namespace

extern "C" int lsqr_stream_copy_f32(void* x, long long len, void* stream) {
  const long long len4 = len / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  if (len4 > 0) {
    stream_copy_kernel<<<static_cast<unsigned>((len4 + per_block - 1) / per_block), kThreads, 0,
                         s>>>(static_cast<float4*>(x), len4);
  }
  if (len > 4 * len4) stream_copy_tail<<<1, 4, 0, s>>>(static_cast<float*>(x), 4 * len4, len);
  return static_cast<int>(cudaGetLastError());
}
"""

SHIPPED = "1024x1 (shipped)"


def build(out_dir):
    """{design: loaded library}, one nvcc per design, all at once."""
    from lsqr_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {SHIPPED: _cuda.CSRC / "stream_copy.cu"}
    for name, settings in DESIGNS.items():
        src = out_dir / f"{name.replace(' ', '_')}.cu"
        text = VARIANT
        for key, value in zip(("THREADS", "UNROLL", "HINTS", "REVERSE"), settings):
            text = text.replace(key, str(value))
        src.write_text(text)
        sources[name] = src
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"lib_{name.replace(' ', '_').replace('(', '').replace(')', '')}.so"
        procs[name] = (lib, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
                                              str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        fn = ctypes.CDLL(str(lib)).lsqr_stream_copy_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, regs)
    return libs


def mul_launch(x, scale, trace):
    """What ``x.mul_(scale)`` launches: [{name, grid, block}] of its kernels
    in a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x.mul_(scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.mul_(scale)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(Path(trace).read_text())["traceEvents"]
    return [{"name": e["name"], "grid": e["args"].get("grid"), "block": e["args"].get("block"),
             "registers_per_thread": e["args"].get("registers per thread")}
            for e in events if e.get("cat") == "kernel"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("stream_copy_designs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lsqr_tpu_torch.ops import roofline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    card = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0]
    out_dir = HERE / "build" / "stream_copy_designs"
    libs = build(out_dir)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, x):
        code = fn(x.data_ptr(), x.numel(), stream)
        if code:
            raise RuntimeError(f"launch failed with CUDA error {code}")

    g = torch.Generator(device=dev).manual_seed(18)
    result = {"card": card, "shape": [roofline.ROWS, roofline.COLS],
              "mul_launch": mul_launch(torch.randn(roofline.ROWS, roofline.COLS, device=dev),
                                       roofline.SCALE, out_dir / "mul_trace.json"),
              "ptxas": {name: regs for name, (_, regs) in libs.items()}}
    cs.log(card)
    cs.log(f"x.mul_ launches: {result['mul_launch']}")
    for shape in ((roofline.ROWS, roofline.COLS), (1_000_003,)):
        x = torch.randn(shape, generator=g, device=dev)
        for name, (fn, _) in libs.items():
            got, ref = x.clone(), x.clone()
            call(fn, got)
            ref.mul_(roofline.SCALE)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} differs from x.mul_ at {shape}")
    x = torch.randn((roofline.ROWS, roofline.COLS), generator=g, device=dev)
    turns = {name: [] for name in libs}
    turns["x.mul_"] = []
    for turn in range(args.turns):
        for name, (fn, _) in libs.items():
            turns[name].append(cs.time_ms(lambda fn=fn: call(fn, x), args.reps))
            turns["x.mul_"].append(cs.time_ms(lambda: x.mul_(roofline.SCALE), args.reps))
        cs.log(f"turn {turn}: " + ", ".join(f"{k} {v[-1]:.5f}" for k, v in turns.items()
                                             if k != "x.mul_")
               + f"; x.mul_ {min(turns['x.mul_'][-len(libs):]):.5f}-"
               f"{max(turns['x.mul_'][-len(libs):]):.5f} ms")
    result["turns_ms"] = turns
    result["mean_ms"] = {k: sum(v) / len(v) for k, v in turns.items()}
    for k, v in sorted(result["mean_ms"].items(), key=lambda kv: kv[1]):
        cs.log(f"  {k:16s} {v:.5f} ms ({2 * x.numel() * 4 / (v * 1e6):.1f} GB/s)  [{card}]")
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
