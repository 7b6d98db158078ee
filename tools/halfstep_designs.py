#!/usr/bin/env python3
"""Designs of the staged shared half-step (``dia_product_shared_axpy``) and
the staged complex pair (``zdia_pair``), and their times against the
parent's, on one card.

    python3 tools/halfstep_designs.py designs [--reps N] [--out FILE]
    python3 tools/halfstep_designs.py times ROOT [ROOT ...] [--reps N] [--out FILE]

The shapes: the half-step on ``chip_smoke.py``'s main band (m = n = 2^23,
11 diagonals, phase 1's stripes, seed 0) and on its 81-diagonal band
(``chip_smoke.MANY``, 2^20, phase 4's stripes, seed 104), f32 and bf16
stripes, forward and adjoint; the complex pair at ``bench.py``'s zdia shape
(m = n = 2^21, offsets -2..2, phase 16's planes, seed 160).

``designs`` writes one source per design into ``build/halfstep_designs/``,
builds them all at once with nvcc (the library's flags) and times each
with ``chip_smoke.time_ms`` after holding its result to the shipped
kernel's bit for bit (every design sums in the same order). The designs:

* ``T``: the shipped build at other tiles than the rule's (``axpy_tile``,
  ``zpair_tile``), and the half-step's direct kernel (T = 0, the parent's
  design: one thread an output);
* ``stages S``: the shipped source with S tiles in shared memory
  (``kAxpyStages``, ``kZStages``);
* ``blocks P``: the shipped source with its staged launch capped at P
  blocks an SM (as many as fit otherwise);
* ``threads 128``: the half-step's block of 128 threads (``kAxpyThreads``);
* ``bulk``: each stage by 1-D bulk copies (TMA) that one thread issues and
  an mbarrier counts, instead of 16-byte cp.async copies (``BULK`` below).

``times`` runs each ROOT (a checkout; to compare a commit with its parent,
``git archive <parent> | tar -x -C build/parent`` and pass
``build/parent . . build/parent``) in a process of its own: both kernels at
the shapes above through each checkout's wrappers, and the three solves
that launch them: phase 3's 2^23 f32 ``pair=False`` solve (phase 2's
stripes, seed 100, +12 on the diagonal), phase 8's bf16 one (``fused=True,
pair=False``, the same stripes) and phase 17's 2^21 ZDIA solve (seed 17,
+12, right-hand side seed 171): istop, itn, the wall ms per iteration of a
fixed 64-iteration run after a warm-up one and the kernel ms per iteration
(``chip_smoke.phase_launches``). It prints the max |difference| of every
output and x to the first run's on the same inputs. Every checkout is
timed by this checkout's ``chip_smoke.time_ms``. Prints one JSON object
per run (the card's name and power limit with it) and, with ``--out
FILE``, writes them all there. Needs one CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CSRC = HERE / "lsqr_tpu_torch" / "csrc"

#: the half-step's tiles and the complex pair's spans timed on the shipped build
AXPY_TS = (2048, 1024, 512, 256, 128, 64)
ZPAIR_SPANS = (4096, 2048, 1024, 512, 256)
#: (design, source file, {constant: value}) of the variants built from the
#: shipped sources; a "blocks" value caps the blocks an SM of the launch
VARIANTS = [
    ("axpy stages 3", "dia_shared.cu", {"kAxpyStages": 3}),
    ("axpy stages 4", "dia_shared.cu", {"kAxpyStages": 4}),
    ("axpy blocks 1", "dia_shared.cu", {"blocks": 1}),
    ("axpy blocks 2", "dia_shared.cu", {"blocks": 2}),
    ("axpy threads 128", "dia_shared.cu", {"kAxpyThreads": 128}),
    ("zpair stages 3", "zdia.cu", {"kZStages": 3}),
    ("zpair blocks 1", "zdia.cu", {"blocks": 1}),
    ("zpair blocks 2", "zdia.cu", {"blocks": 2}),
]
#: the line of each source's staged launcher before which a blocks cap goes
TILES_LINE = {"dia_shared.cu": "  const long long tiles = (dim_out + T - 1) / T;\n",
              "zdia.cu": "  const long long tiles = (dim + T - 1) / T;\n"}

BULK = r"""
// Designs of the staged half-step and complex pair (tools/halfstep_designs.py):
// each stage by 1-D bulk copies (cp.async.bulk, the TMA's) that thread 0
// issues and an mbarrier a stage counts in bytes, instead of 16-byte
// cp.async copies; the sums are the shipped kernels' (the same bits). Same
// arguments as lsqr_dia_shared_axpy_* and lsqr_zdia_pair_f32.

#include "@SHARED@"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk(void* dst, const void* src, unsigned bytes,
                                     unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
               "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ unsigned pieces16(long long elems, int per) {
  return static_cast<unsigned>((elems + per - 1) / per) * 16u;
}

// the half-step's stage by thread 0: the pieces axpy_stage copies, as one
// bulk copy a diagonal, one for the window, one for y
template <typename S>
__device__ void axpy_stage_bulk(unsigned char* buf, const AxpyLayout& lay, const S* rows,
                                long long stride, int ph, const float* vec, const float* y,
                                const int* kk, int nd, long long dim_out, long long dim_in,
                                int lo, int hi, int T, long long c0, int adjoint,
                                unsigned long long* bar) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(dim_out - c0 < T ? dim_out - c0 : T);
  const long long xa = c0 - lo > 0 ? c0 - lo : 0;
  const long long xb = c0 + len + hi < dim_in ? c0 + len + hi : dim_in;
  const int shx = static_cast<int>(xa & 3);
  unsigned total = pieces16(len, 4) + (xa < xb ? pieces16(shx + (xb - xa), 4) : 0u);
  for (int d = 0; d < nd; ++d) {
    const int sh = static_cast<int>((ph + c0 + (adjoint ? kk[d] : 0)) & (V - 1));
    total += pieces16(sh + len, V);
  }
  bar_expect(bar, total);
  S* const st = reinterpret_cast<S*>(buf);
  for (int d = 0; d < nd; ++d) {
    const long long s = c0 + (adjoint ? kk[d] : 0);
    const int sh = static_cast<int>((ph + s) & (V - 1));
    bulk(st + d * lay.L, rows + d * stride + s - sh, pieces16(sh + len, V), bar);
  }
  float* const xs = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S));
  if (xa < xb) bulk(xs, vec + xa - shx, pieces16(shx + (xb - xa), 4), bar);
  bulk(xs + lay.LX, y + c0, pieces16(len, 4), bar);
}

template <typename S, int R>
__global__ void __launch_bounds__(kAxpyThreads) axpy_bulk_kernel(
    const S* __restrict__ rows, long long stride, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long dim_out, long long dim_in, int lo,
    int hi, int T, long long tiles, int adjoint) {
  constexpr int V = 16 / sizeof(S);
  extern __shared__ __align__(16) unsigned char smem[];
  const AxpyLayout lay(nd, lo, hi, T, sizeof(S));
  int* const kk = reinterpret_cast<int*>(smem + kAxpyStages * lay.stage);
  auto* const bars = reinterpret_cast<unsigned long long*>(smem + lay.bytes);
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    const int k = __ldg(offsets + d);
    kk[d] = adjoint ? -k : k;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kAxpyStages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(rows) / sizeof(S)) % V);
  const long long grid = gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kAxpyStages - 1; ++s) {
      const long long tile = blockIdx.x + s * grid;
      if (tile < tiles) {
        axpy_stage_bulk(smem + s * lay.stage, lay, rows, stride, ph, vec, y, kk, nd, dim_out,
                        dim_in, lo, hi, T, tile * T, adjoint, bars + s);
      }
    }
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    bar_wait(bars + it % kAxpyStages, (it / kAxpyStages) & 1);
    __syncthreads();
    const long long ahead = tile + (kAxpyStages - 1) * grid;
    if (threadIdx.x == 0 && ahead < tiles) {
      const int b = (it + kAxpyStages - 1) % kAxpyStages;
      axpy_stage_bulk(smem + b * lay.stage, lay, rows, stride, ph, vec, y, kk, nd, dim_out,
                      dim_in, lo, hi, T, ahead * T, adjoint, bars + b);
    }
    axpy_sum<S, R>(smem + it % kAxpyStages * lay.stage, lay, ph, kk, nd, c1, c2, out, dim_out,
                   dim_in, lo, hi, T, tile * T, adjoint);
  }
}

template <typename S, int R>
int launch_axpy_bulk(const void* dp, const void* vec, const void* y, const void* c1,
                     const void* c2, void* out, const void* offsets, int nd, long long Lp,
                     int H, long long dim_out, long long dim_in, int adjoint, int lo, int hi,
                     int T, void* stream) {
  if (adjoint) { const int t = lo; lo = hi; hi = t; }
  const AxpyLayout lay(nd, lo, hi, T, sizeof(S));
  const long long bytes = lay.bytes + 8 * kAxpyStages;
  auto kernel = axpy_bulk_kernel<S, R>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kAxpyThreads, bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (dim_out + T - 1) / T;
  const long long slots = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(tiles < slots ? tiles : slots), kAxpyThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dp) + H, Lp, static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(out),
      static_cast<const int*>(offsets), nd, dim_out, dim_in, lo, hi, T, tiles, adjoint);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int axpy_bulk(const void* dp, const void* vec, const void* y, const void* c1, const void* c2,
              void* out, const void* offsets, int nd, long long Lp, int H, long long dim_out,
              long long dim_in, int adjoint, int lo, int hi, int T, void* stream) {
  if (T < 16 || T % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (T >= 4 * kAxpyThreads) {
    return launch_axpy_bulk<S, 4>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out,
                                  dim_in, adjoint, lo, hi, T, stream);
  }
  if (T >= 2 * kAxpyThreads) {
    return launch_axpy_bulk<S, 2>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out,
                                  dim_in, adjoint, lo, hi, T, stream);
  }
  return launch_axpy_bulk<S, 1>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out,
                                dim_in, adjoint, lo, hi, T, stream);
}

}  // namespace

extern "C" {
int lsqr_axpy_bulk_f32(const void* dp, const void* vec, const void* y, const void* c1,
                       const void* c2, void* out, const void* offsets, int nd, long long Lp,
                       int H, long long dim_out, long long dim_in, int adjoint, int lo, int hi,
                       int T, void* stream) {
  return axpy_bulk<float>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out, dim_in,
                          adjoint, lo, hi, T, stream);
}
int lsqr_axpy_bulk_bf16(const void* dp, const void* vec, const void* y, const void* c1,
                        const void* c2, void* out, const void* offsets, int nd, long long Lp,
                        int H, long long dim_out, long long dim_in, int adjoint, int lo,
                        int hi, int T, void* stream) {
  return axpy_bulk<__nv_bfloat16>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out,
                                  dim_in, adjoint, lo, hi, T, stream);
}
}
"""

#: the complex pair's bulk design, in a source of its own (zdia.cu and
#: dia_shared.cu both define kThreads)
ZBULK = r"""
#include "@ZDIA@"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk(void* dst, const void* src, unsigned bytes,
                                     unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
               "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ unsigned pieces16(long long elems, int per) {
  return static_cast<unsigned>((elems + per - 1) / per) * 16u;
}

// the complex pair's stage by thread 0: zpair_stage's pieces, one bulk copy
// a plane row, one for win, one for y (an empty tile arrives with 0 bytes)
__device__ void zpair_stage_bulk(unsigned char* buf, const ZPairLayout& lay, const float* dr,
                                 const float* di, const int* dm, const float2* win,
                                 const float2* y, int nd, long long m, long long n, int lo,
                                 int hi, int T, long long c0, unsigned long long* bar) {
  const long long ra = c0 - hi > 0 ? c0 - hi : 0;
  const long long rb = c0 + T + lo < m ? c0 + T + lo : m;
  if (ra >= rb) {
    bar_expect(bar, 0);
    return;
  }
  const int len = static_cast<int>(rb - ra);
  const long long xa = ra - lo > 0 ? ra - lo : 0;
  const long long xb = rb + hi < n ? rb + hi : n;
  const int shx = static_cast<int>(xa & 1), shy = static_cast<int>(ra & 1);
  unsigned total = pieces16(shy + len, 2) + (xa < xb ? pieces16(shx + (xb - xa), 2) : 0u);
  for (int d = 0; d < nd; ++d) {
    total += 2 * pieces16(((dm[d] + static_cast<int>(ra & 3)) & 3) + len, 4);
  }
  bar_expect(bar, total);
  float* const st = reinterpret_cast<float*>(buf);
  for (int row = 0; row < 2 * nd; ++row) {
    const int d = row < nd ? row : row - nd;
    const int sh = (dm[d] + static_cast<int>(ra & 3)) & 3;
    bulk(st + row * lay.L, (row < nd ? dr : di) + d * m + ra - sh, pieces16(sh + len, 4), bar);
  }
  float2* const xs = reinterpret_cast<float2*>(buf + 2LL * nd * lay.L * 4);
  if (xa < xb) bulk(xs, win + xa - shx, pieces16(shx + (xb - xa), 2), bar);
  bulk(xs + lay.LX, y + ra - shy, pieces16(shy + len, 2), bar);
}

__global__ void __launch_bounds__(kThreads) zpair_bulk_kernel(
    const float* __restrict__ dr, const float* __restrict__ di,
    const float2* __restrict__ win, const float2* __restrict__ y,
    const float* __restrict__ c1p, const float* __restrict__ c2p,
    float2* __restrict__ u, float2* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n, int lo,
    int hi, int T, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ZPairLayout lay(nd, lo, hi, T);
  float2* const u_s = reinterpret_cast<float2*>(smem + kZStages * lay.stage);
  int* const ks = reinterpret_cast<int*>(u_s + lay.U);
  int* const dm = ks + round_up(nd, 4);
  auto* const bars = reinterpret_cast<unsigned long long*>(smem + lay.bytes);
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    ks[d] = __ldg(offsets + d);
    dm[d] = static_cast<int>(static_cast<unsigned long long>(d) * m & 3);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kZStages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long grid = gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kZStages - 1; ++s) {
      const long long tile = blockIdx.x + s * grid;
      if (tile < tiles) {
        zpair_stage_bulk(smem + s * lay.stage, lay, dr, di, dm, win, y, nd, m, n, lo, hi, T,
                         tile * T, bars + s);
      }
    }
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    bar_wait(bars + it % kZStages, (it / kZStages) & 1);
    __syncthreads();
    const long long ahead = tile + (kZStages - 1) * grid;
    if (threadIdx.x == 0 && ahead < tiles) {
      const int b = (it + kZStages - 1) % kZStages;
      zpair_stage_bulk(smem + b * lay.stage, lay, dr, di, dm, win, y, nd, m, n, lo, hi, T,
                       ahead * T, bars + b);
    }
    zpair_sum(smem + it % kZStages * lay.stage, lay, u_s, ks, dm, c1, c2, u, z, nd, m, n, lo,
              hi, T, tile * T);
  }
}

}  // namespace

extern "C" int lsqr_zpair_bulk_f32(const void* dr, const void* di, const void* win,
                                   const void* y, const void* c1, const void* c2, void* u,
                                   void* z, const void* offsets, int nd, long long m,
                                   long long n, int lo, int hi, int mode, int T,
                                   void* stream) {
  if (mode != 0 || T < 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long dim = m > n ? m : n;
  const ZPairLayout lay(nd, lo, hi, T);
  const long long bytes = lay.bytes + 8 * kZStages;
  int err = static_cast<int>(cudaFuncSetAttribute(
      zpair_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, zpair_bulk_kernel, kThreads, bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (dim + T - 1) / T;
  const long long slots = static_cast<long long>(per_sm) * sms;
  zpair_bulk_kernel<<<static_cast<unsigned>(tiles < slots ? tiles : slots), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<const float2*>(win), static_cast<const float2*>(y),
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<float2*>(u),
      static_cast<float2*>(z), static_cast<const int*>(offsets), nd, m, n, lo, hi, T, tiles);
  return static_cast<int>(cudaGetLastError());
}
"""


def yardstick():
    """This checkout's ``chip_smoke.py`` (loaded by path, so that a checkout
    under test cannot replace it): its shapes, seeds and ``time_ms``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shipped_source(name, constants=None):
    """csrc/<name> with absolute includes, these constants replaced and, for
    "blocks", the staged launch capped at that many blocks an SM."""
    src = (CSRC / name).read_text().replace(
        '#include "dia_pair_staged.cuh"', f'#include "{CSRC / "dia_pair_staged.cuh"}"')
    constants = dict(constants or {})
    if "blocks" in constants:
        cap = constants.pop("blocks")
        if src.count(TILES_LINE[name]) != 1:
            raise RuntimeError(f"csrc/{name}: the staged launcher's tiles line moved")
        src = src.replace(TILES_LINE[name], f"  per_sm = per_sm < {cap} ? per_sm : {cap};\n"
                          + TILES_LINE[name])
    for const, value in constants.items():
        line = next((ln for ln in src.splitlines()
                     if ln.startswith(f"constexpr int {const} = ")), None)
        if line is None:
            raise RuntimeError(f"csrc/{name} no longer defines {const}")
        src = src.replace(line, f"constexpr int {const} = {value};")
    return src


def designs():
    """{name: (source, {kind: entry point})}."""
    axpy = {"axpy f32": "lsqr_dia_shared_axpy_f32", "axpy bf16": "lsqr_dia_shared_axpy_bf16"}
    out = {}
    for name, src, constants in VARIANTS:
        entries = axpy if src == "dia_shared.cu" else {"zpair": "lsqr_zdia_pair_f32"}
        out[name] = (shipped_source(src, constants), entries)
    out["axpy bulk"] = (BULK.replace("@SHARED@", str(CSRC / "dia_shared.cu")),
                        {"axpy f32": "lsqr_axpy_bulk_f32", "axpy bf16": "lsqr_axpy_bulk_bf16"})
    out["zpair bulk"] = (ZBULK.replace("@ZDIA@", str(CSRC / "zdia.cu")),
                         {"zpair": "lsqr_zpair_bulk_f32"})
    return out


def build(out_dir, table):
    """{design: loaded library}: every design compiled at once."""
    from lsqr_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _) in table.items():
        stem = name.replace(" ", "_")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for kind, entry in table[name][1].items():
            sig = _cuda._SIGNATURES["lsqr_zdia_pair_f32" if kind == "zpair"
                                    else "lsqr_dia_shared_axpy_f32"]
            getattr(lib, entry).argtypes = sig
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def stage_bytes(kind, name, nd, lo, hi, T, esize=4):
    """A design's shared memory at tile T (``kind`` "axpy" or "zpair"): the
    rule's mirror at the design's stage count, with the bulk designs'
    mbarriers."""
    from lsqr_tpu_torch.ops import spmv

    constants = next((c for n, _, c in VARIANTS if n == name), {})
    if kind == "zpair":
        stages = constants.get("kZStages", spmv.ZPAIR_STAGES)
        nbytes = spmv.zpair_stage_bytes(nd, lo, hi, T, stages)
    else:
        stages = constants.get("kAxpyStages", spmv.AXPY_STAGES)
        nbytes = spmv.axpy_stage_bytes(nd, lo, hi, T, esize, stages)
    return nbytes + (8 * stages if name.endswith("bulk") else 0)


def axpy_inputs(smoke, dev, shape):
    """(stripes, y, v, offsets, m) of a half-step shape."""
    import torch

    m, ks, seed = shape
    data, y, g = smoke.random_stripes(m, m, ks, dev, seed=seed)
    return data, y, torch.randn(m, generator=g, device=dev), ks, m


def axpy_shapes(smoke):
    return {"2^23 x 11": (smoke.M_MAIN, smoke.OFFSETS, 0), "2^20 x 81": (smoke.MANY[0],
                                                                       smoke.MANY[1], 104)}


def run_designs(reps):
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import ZDIA_OFFSETS
    from lsqr_tpu_torch.ops import _cuda, spmv

    smoke = yardstick()
    table = designs()
    libs = build(HERE / "build" / "halfstep_designs", table)
    shipped = _cuda.library()
    dev = torch.device("cuda")
    optin = spmv._smem_limits(dev)[1]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {"times": {}, "max_abs_diff_to_shipped": {}}
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)

    def record(tag, fn, ref):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        diff = max(smoke.absdiff(a, b) for a, b in zip(got, ref))
        res["max_abs_diff_to_shipped"][tag] = diff
        res["times"][tag] = smoke.time_ms(fn, reps)
        smoke.log(f"  {tag:52s} {res['times'][tag]:.5f} ms  (max |diff| to shipped {diff:.3e})")
        smoke.check(diff == 0.0, f"{tag}: not the shipped kernel's bits")

    for label, shape in axpy_shapes(smoke).items():
        data, y, v, ks, m = axpy_inputs(smoke, dev, shape)
        lo, hi = spmv._halos(ks)
        H, Lp = spmv._geometry(ks, m, m)
        for storage in (torch.float32, torch.bfloat16):
            kind = "axpy f32" if storage == torch.float32 else "axpy bf16"
            A = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
            # (design, entry point, tiles): the shipped build also at T = 0
            entries = [("shipped", getattr(shipped, f"lsqr_dia_shared_axpy_{kind[5:]}"),
                        (0, *AXPY_TS))]
            entries += [(name, getattr(libs[name], table[name][1][kind]), AXPY_TS)
                        for name in table if kind in table[name][1]]
            for adj in (False, True):
                side = f"{kind} {label} {'adjoint' if adj else 'forward'}"
                kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
                wrapper = lambda: spmv.dia_product_shared_axpy(  # noqa: E731
                    A.dp, v, y, c1, c2, adjoint=adj, **kw)
                ref = (wrapper(),)
                rule = spmv.axpy_tile(len(ks), lo, hi, storage.itemsize,
                                      *spmv._smem_limits(dev))
                record(f"{side} shipped, the rule's T {rule}", wrapper, ref)
                for name, entry, ts in entries:
                    for T in ts:
                        if T and stage_bytes("axpy", name, len(ks), lo, hi, T,
                                             storage.itemsize) > optin:
                            continue

                        def call(entry=entry, T=T):
                            out = torch.empty(m, device=dev)
                            err = entry(A.dp.data_ptr(), v.data_ptr(), y.data_ptr(),
                                        c1.data_ptr(), c2.data_ptr(), out.data_ptr(),
                                        A.offsets_t.data_ptr(), len(ks), Lp, H, m, m, int(adj),
                                        lo, hi, T, stream())
                            if err:
                                raise RuntimeError(f"CUDA error {err}")
                            return out
                        record(f"{side} {name} T {T}" if T else f"{side} direct (T 0)", call,
                               ref)
            del A
        del data, y, v
        torch.cuda.empty_cache()

    m, ks = smoke.M_ZDIA, ZDIA_OFFSETS
    lo, hi = spmv._halos(ks)
    A = lt.dia_operator_device(m, m, ks, lt.zdia_stripes(m, m, ks, seed=160, device=dev,
                                                         generator="torch"))
    g = torch.Generator(device=dev).manual_seed(16)
    yv = torch.randn(m, generator=g, device=dev, dtype=torch.complex64)
    win = torch.randn(m, generator=g, device=dev, dtype=torch.complex64)
    kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
    wrapper = lambda: spmv.zdia_pair(A.dr, A.di, yv, win, c1, c2, **kw)  # noqa: E731
    ref = wrapper()
    record(f"zpair shipped, the rule's T {spmv.zpair_tile(len(ks), lo, hi, *spmv._smem_limits(dev))}",
           wrapper, ref)

    def raw(entry, mode, T):
        u = torch.empty(m, device=dev, dtype=torch.complex64)
        z = torch.empty(m, device=dev, dtype=torch.complex64)
        p = [torch.view_as_real(t).data_ptr() for t in (yv, win, u, z)]
        for md in ((spmv.ZPAIR_FORWARD, spmv.ZPAIR_ADJOINT) if mode is None else (mode,)):
            err = entry(A.dr.data_ptr(), A.di.data_ptr(), p[1], p[0], c1.data_ptr(),
                        c2.data_ptr(), p[2], p[3], A.offsets_t.data_ptr(), len(ks), m, m, lo,
                        hi, md, T, stream())
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return u, z
    entries = [("shipped", shipped.lsqr_zdia_pair_f32)] + [
        (name, getattr(libs[name], table[name][1]["zpair"])) for name in table
        if "zpair" in table[name][1]]
    for name, entry in entries:
        for span in ZPAIR_SPANS:
            T = span - spmv._round_up(lo + hi, 4)
            if stage_bytes("zpair", name, len(ks), lo, hi, T) <= optin:
                record(f"zpair {name} T {T}", lambda entry=entry, T=T: raw(
                    entry, spmv.ZPAIR_FUSED, T), ref)
    record("zpair two launches (u, then z from u)", lambda: raw(
        shipped.lsqr_zdia_pair_f32, None, 0), ref)
    return res


def one(root, reps, dump):
    """Times, solves and results of the checkout at ``root`` (this process)."""
    sys.path.insert(0, str(root))
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import ZDIA_OFFSETS
    from lsqr_tpu_torch.ops import spmv

    assert Path(lt.__file__).resolve().is_relative_to(Path(root).resolve()), lt.__file__
    smoke = yardstick()
    dev = torch.device("cuda")
    out, saved = {}, {}
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    for label, shape in axpy_shapes(smoke).items():
        data, y, v, ks, m = axpy_inputs(smoke, dev, shape)
        for storage in (torch.float32, torch.bfloat16):
            A = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
            kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
            for adj in (False, True):
                tag = (f"dia_product_shared_axpy{'' if storage == torch.float32 else '[bf16]'} "
                       f"{label} {'adjoint' if adj else 'forward'}")
                fn = lambda: spmv.dia_product_shared_axpy(A.dp, v, y, c1, c2,  # noqa: E731
                                                          adjoint=adj, **kw)
                out[tag] = smoke.time_ms(fn, reps)
                saved[tag] = [fn().cpu()]
            del A
        del data, y, v
        torch.cuda.empty_cache()
    m, ks = smoke.M_ZDIA, ZDIA_OFFSETS
    A = lt.dia_operator_device(m, m, ks, lt.zdia_stripes(m, m, ks, seed=160, device=dev,
                                                         generator="torch"))
    g = torch.Generator(device=dev).manual_seed(16)
    yv = torch.randn(m, generator=g, device=dev, dtype=torch.complex64)
    win = torch.randn(m, generator=g, device=dev, dtype=torch.complex64)
    fn = lambda: spmv.zdia_pair(A.dr, A.di, yv, win, c1, c2, offsets=ks, m=m,  # noqa: E731
                                n=m, offsets_t=A.offsets_t)
    out["zdia_pair 2^21 x 5"] = smoke.time_ms(fn, reps)
    saved["zdia_pair 2^21 x 5"] = [t.cpu() for t in fn()]
    del A, yv, win
    torch.cuda.empty_cache()

    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)

    def solve(label, A, b, **kw):
        res = lt.lsqr(A, b, smoke.DAMP, atol=1e-6, btol=1e-6, **kw)
        lt.lsqr(A, b, smoke.DAMP, **fixed, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt.lsqr(A, b, smoke.DAMP, **fixed, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 64
        prof = smoke.phase_launches(A, b, **kw)
        out[f"solve {label}"] = dict(istop=int(res.istop), itn=int(res.itn),
                                     wall_ms_per_iteration=wall,
                                     kernel_ms_per_iteration=prof["kernel_ms_per_iteration"],
                                     kernels_per_iteration=prof["kernels_per_iteration"])
        saved[f"x {label}"] = [res.x.cpu()]

    m = smoke.M_MAIN
    data, b, _ = smoke.random_stripes(m, m, smoke.OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_shared_operator(m, m, smoke.OFFSETS, data)
    solve("phase 3 f32 pair=False", A, b, pair=False)
    A = lt.dia_shared_operator(m, m, smoke.OFFSETS, data, storage_dtype=torch.bfloat16)
    solve("phase 8 bf16 fused=True pair=False", A, b, fused=True, pair=False)
    del A, data, b
    torch.cuda.empty_cache()
    m, ks = smoke.M_ZDIA, ZDIA_OFFSETS
    A = lt.dia_operator_device(m, m, ks, lt.zdia_stripes(m, m, ks, seed=17, diag=12.0,
                                                         device=dev, generator="torch"))
    b = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(171), device=dev,
                    dtype=torch.complex64)
    solve("phase 17 ZDIA", A, b)
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
    return out


def run_times(roots, reps):
    import torch

    runs = []
    dumps = HERE / "build" / "halfstep_designs" / "times"
    for i, root in enumerate(roots):
        root = str(Path(root).resolve())
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--reps", str(reps),
                               "--dump", str(dumps / f"{i}.pt")], capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(proc.returncode)
        runs.append({"root": root, **json.loads(proc.stdout.splitlines()[-1])})
        if i:  # each result against the first run's
            first, this = (torch.load(dumps / f"{k}.pt") for k in (0, i))
            runs[-1]["max_abs_diff_to_first"] = {
                tag: [float((a - b).abs().max()) for a, b in zip(this[tag], first[tag])]
                for tag in this}
        print(json.dumps(runs[-1]), flush=True)
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["designs", "times"])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="write the result to this JSON file too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.reps, args.dump)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("halfstep_designs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.mode == "times":
        result = {"card": card, "runs": run_times(args.roots or [str(HERE)], args.reps)}
    else:
        result = {"card": card, **run_designs(args.reps)}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
