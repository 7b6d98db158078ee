#!/usr/bin/env python3
"""Designs of the two pairs that keep their operand on chip between the two
products, and their times against the parent's, on one card.

    python3 tools/pair_designs.py designs [--reps N] [--out FILE]
    python3 tools/pair_designs.py times ROOT [ROOT ...] [--reps N] [--out FILE]

The pairs: ``spmv_sparse.block_ell_pair_windowed`` at ``chip_smoke.py``'s
2^18 BlockELL packing (128 x 128 blocks, 3 per block row, seed 13) and the
shared DIA pair's many-diagonal route (``spmv._dia_pair_shared_launch``
with ``tile=0``, the ring kernel) on ``chip_smoke.MANY`` (m = n = 2^20, 81
diagonals, phase 4's stripes), f32 and bf16 stripes.

``designs`` writes one source per design into ``build/pair_designs/``,
builds them all at once with nvcc (the library's flags) and times each
with ``chip_smoke.time_ms`` after holding its result to the shipped
kernel's (the DIA designs sum in the same order: the same bits; the
BlockELL ones within 1e-5 of the twin, relative). The designs:

* ``ring C/T/A/B``: ``csrc/dia_shared.cu`` with other ring constants (C
  rows a step, T threads, A chunks in flight, B diagonals a batch; the
  shipped one is the first of ``RINGS``);
* ``slide C/T/B``: the ring's walk with a window that slides by C rows a
  step instead of wrapping (``SLIDE`` below);
* ``persist T/MB``: a persistent grid of tiles of T indices whose u pass
  reads the stripes with an L2 evict-last policy and whose z pass reads
  them again with evict-first, as many tiles in flight as keep their
  stripe rows within MB of L2 (``PERSIST`` below);
* ``cluster`` (shipped, ``csrc/block_ell.cu``) and ``rows P``: one CTA a
  block row, its forward product 4 rows a warp straight into registers,
  u to shared memory, its transposed product reading the blocks again
  (from L2), P CTAs an SM (``ROWS`` below).

``times`` runs each ROOT (a checkout; to compare a commit with its parent,
``git archive <parent> | tar -x -C build/parent`` and pass
``build/parent . . build/parent``) in a process of its own: the two pairs
as above, through each checkout's wrappers; the phase-4 solves (damped,
to atol = btol = 1e-6; istop, itn) and the BlockELL ``pair=True`` solve
(istop, itn, wall ms per iteration of a fixed 64-iteration run after a
warm-up one, and kernel ms per iteration from ``chip_smoke.phase_launches``),
with the max |difference| of every u, z (zp) and x to the first run's on
the same inputs. Every checkout is timed by this checkout's
``chip_smoke.time_ms``. Prints one JSON object per run (the card's name and
power limit with it) and, with ``--out FILE``, writes them all there.
Needs one CUDA device.
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

#: ring designs: (C, T, A, B); the first is the shipped source's
RINGS = [(128, 128, 0, 4), (128, 128, 0, 8), (64, 64, 0, 4), (96, 96, 0, 4), (256, 256, 0, 4),
         (256, 256, 0, 8), (512, 512, 0, 8), (128, 128, 1, 4), (256, 256, 1, 4)]
#: persistent L2 designs: (tile, MB of stripe rows in flight)
PERSISTS = [(512, 24), (512, 40)]
#: BlockELL pair designs: CTAs an SM of the register-stream design
ROWS_PER_SM = [1, 2, 4, 8]

PERSIST = r"""
// A design of the shared pair's many-diagonal route (tools/pair_designs.py):
// a persistent grid of tiles of kTile indices; the u pass of a tile reads
// its stripe rows [c0 - hi, c0 + kTile + lo) with an L2 evict-last policy
// into u for those rows (shared memory), the z pass reads them again with
// an L2 evict-first policy. As many blocks as keep kBudget bytes of stripe
// rows in flight. Same sums and order as the shipped kernels: the same
// bits. Same arguments as lsqr_dia_pair_shared_*.

#include "@SHIPPED@"

namespace {

constexpr int kTile = @TILE@;
constexpr long long kBudget = @BUDGET@LL;

__device__ __forceinline__ float ld_hint(const float* p, unsigned long long pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float ld_hint(const __nv_bfloat16* p, unsigned long long pol) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

template <typename S>
__global__ void __launch_bounds__(256) dia_pair_persist_kernel(
    const S* __restrict__ rows, long long stride, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ u, float* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n, int lo, int hi,
    long long tiles) {
  extern __shared__ float u_s[];
  int* ks = reinterpret_cast<int*>(u_s + kTile + lo + hi);
  unsigned long long keep, drop;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(drop));
  for (int d = threadIdx.x; d < nd; d += blockDim.x) ks[d] = __ldg(offsets + d);
  const float c1 = __ldg(c1p), c2 = __ldg(c2p);
  const int span = kTile + lo + hi;
  __syncthreads();
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long c0 = tile * kTile;
    for (int t = threadIdx.x; t < span; t += blockDim.x) {
      const long long r = c0 - hi + t;
      float acc = 0.0f;
      if (r >= 0 && r < m) {
        acc = (-c2) * __ldg(y + r);
#pragma unroll 4
        for (int d = 0; d < nd; ++d) {
          const long long c = r + ks[d];
          if (c >= 0 && c < n) acc += ld_hint(rows + d * stride + r, keep) * (__ldg(vec + c) * c1);
        }
        if (t >= hi && t < hi + kTile) u[r] = acc;
      }
      u_s[t] = acc;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
      const long long j = c0 + t;
      if (j >= n) break;
      float acc = 0.0f;
#pragma unroll 4
      for (int d = 0; d < nd; ++d) {
        const long long r = j - ks[d];
        if (r >= 0 && r < m) acc += ld_hint(rows + d * stride + r, drop) * u_s[t + hi - ks[d]];
      }
      z[j] = acc;
    }
    __syncthreads();
  }
}

template <typename S>
int launch_persist(const void* dp, const void* vec, const void* y, const void* c1,
                   const void* c2, void* u, void* z, const void* offsets, int nd,
                   long long Lp, int H, long long m, long long n, int lo, int hi,
                   void* stream) {
  const long long dim = m > n ? m : n;
  if (dim == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(kTile + lo + hi + nd);
  auto kernel = dia_pair_persist_kernel<S>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) {
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  }
  if (!err) {
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, smem));
  }
  if (err) return err;
  const long long tiles = (dim + kTile - 1) / kTile;
  const long long tile_bytes = static_cast<long long>(nd) * (kTile + lo + hi) * sizeof(S);
  long long grid = kBudget / tile_bytes;
  grid = grid < 1 ? 1 : grid;
  grid = grid < static_cast<long long>(per_sm) * sms ? grid : static_cast<long long>(per_sm) * sms;
  grid = grid < tiles ? grid : tiles;
  kernel<<<static_cast<unsigned>(grid), 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dp) + H, Lp, static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(u), static_cast<float*>(z),
      static_cast<const int*>(offsets), nd, m, n, lo, hi, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
int lsqr_dia_pair_persist_f32(const void* dp, const void* vec, const void* y, const void* c1,
                              const void* c2, void* u, void* z, const void* offsets, int nd,
                              long long Lp, int H, long long m, long long n, int lo, int hi,
                              void* stream) {
  return launch_persist<float>(dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n, lo, hi,
                               stream);
}
int lsqr_dia_pair_persist_bf16(const void* dp, const void* vec, const void* y, const void* c1,
                               const void* c2, void* u, void* z, const void* offsets, int nd,
                               long long Lp, int H, long long m, long long n, int lo, int hi,
                               void* stream) {
  return launch_persist<__nv_bfloat16>(dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n,
                                       lo, hi, stream);
}
}  // extern "C"
"""

ROWS = r"""
// A design of block_ell_pair_windowed (tools/pair_designs.py): one CTA a
// block row; the forward product takes 4 rows a warp straight into
// registers (all loads issued before the products), u_r goes to shared
// memory, and the transposed product reads the row's blocks again, from
// L2 where the CTAs in flight (`keep` of them an SM, by padding the
// dynamic shared memory) hold their rows there. 16-byte packings only.
// Same arguments as lsqr_block_ell_pair_f32 (`ranks` unused).

#include "@SHIPPED@"

namespace {

__global__ void __launch_bounds__(kThreads) pair_rows_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ c1p, const float* __restrict__ c2p,
    float* __restrict__ u, float* __restrict__ zp, int kb, int bh, int bw) {
  extern __shared__ float su[];
  const long long r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / 4;
  const float c1 = *c1p, c2 = *c2p;
  for (int i0 = warp * kRows; i0 < bh; i0 += kWarps * kRows) {
    float acc[kRows] = {};
    for (int j = 0; j < kb; ++j) {
      const float* b0 = blocks + ((r * kb + j) * bh + i0) * bw;
      const float4* xs = reinterpret_cast<const float4*>(
          x + static_cast<long long>(__ldg(bcols + r * kb + j)) * bw);
      for (int q = lane; q < nvec; q += 32) {
        const float4 xv = __ldg(xs + q);
        float4 av[kRows];
#pragma unroll
        for (int t = 0; t < kRows; ++t)
          av[t] = i0 + t < bh ? __ldg(reinterpret_cast<const float4*>(b0 + t * bw) + q)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int t = 0; t < kRows; ++t)
          acc[t] += av[t].x * (xv.x * c1) + av[t].y * (xv.y * c1) + av[t].z * (xv.z * c1) +
                    av[t].w * (xv.w * c1);
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const float v = warp_sum(acc[t]);
      if (lane == 0 && i0 + t < bh) {
        const float ui = v - c2 * y[r * bh + i0 + t];
        su[i0 + t] = ui;
        u[r * bh + i0 + t] = ui;
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kb * bw; p += kThreads) {
    const int j = p / bw, c = p - j * bw;
    const float* col = blocks + (r * kb + j) * static_cast<long long>(bh) * bw + c;
    float acc = 0.0f;
    for (int i = 0; i < bh; ++i) acc += __ldcs(col + static_cast<long long>(i) * bw) * su[i];
    zp[(r * kb + j) * bw + c] = acc;
  }
}

}  // namespace

extern "C" int lsqr_block_ell_pair_rows_f32(const void* blocks, const void* bcols,
                                            const void* x, const void* y, const void* c1,
                                            const void* c2, void* u, void* zp, int mb, int kb,
                                            int bh, int bw, int ranks, int keep,
                                            void* stream) {
  (void)ranks;
  if (bw % 4 || !aligned16(blocks) || !aligned16(x)) return 1;
  int dev = 0, per_sm_bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&per_sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  size_t smem = static_cast<size_t>(per_sm_bytes / keep - 1024);
  smem = smem < 4 * static_cast<size_t>(bh) ? 4 * static_cast<size_t>(bh) : smem;
  int err = max_smem_attr(reinterpret_cast<const void*>(pair_rows_kernel), smem);
  if (err) return err;
  pair_rows_kernel<<<mb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<float*>(u),
      static_cast<float*>(zp), kb, bh, bw);
  return static_cast<int>(cudaGetLastError());
}
"""


SLIDE = r"""
// A design of the shared pair's many-diagonal route (tools/pair_designs.py):
// the ring kernel's walk, with a window that slides instead of wrapping.
// Shared memory holds W = G + C rows of every diagonal (G = lo + hi rounded
// up to 16 bytes' worth); at step k place q holds row c0 - G + q. A step
// moves places [C, C + G) to [0, G) (in pieces of at most C, a barrier
// after each), copies chunk k's stripe rows into [G, G + C), and reads row
// j - k of column c0 - lo + t at place G - lo - k + t: no place wraps, at
// the cost of the slide and a barrier a step. Same sums and order as the
// shipped kernels: the same bits. Same arguments as lsqr_dia_pair_shared_*.

#include "@SHIPPED@"

namespace {

constexpr int kSlideThreads = 128;
constexpr int kSlideChunk = 128;  // C: rows a step adds (a multiple of kSlideThreads)
constexpr int kSlideBatch = 4;    // diagonals whose loads a thread issues together
static_assert(kSlideChunk % kSlideThreads == 0 && kSlideBatch % 4 == 0, "slide shape");

// The window's shared memory: nd rows of W stripe elements, u for W rows,
// a step's x window (C + lo + hi floats, rounded up to 4), then the
// offsets and the z places (nd rounded up to 4 ints each).
struct SlideLayout {
  int G, W, LX, nd4;
  long long u_at, bytes;
  __host__ __device__ SlideLayout(int nd, int lo, int hi, int esize) {
    const int v = 16 / esize;
    G = (lo + hi + v - 1) / v * v;
    W = G + kSlideChunk;
    LX = (kSlideChunk + lo + hi + 3) / 4 * 4;
    nd4 = (nd + 3) / 4 * 4;
    u_at = round_up(static_cast<long long>(nd) * W * esize, 16);
    bytes = u_at + 4LL * W + 4LL * LX + 8LL * nd4;
  }
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows = dp + H (diagonal d's row r at rows[d * stride + r]); `units`
// chunks of kSlideChunk cover max(m, n). Each thread takes R rows (columns)
// of a step, kSlideThreads apart, their sums side by side, and issues the
// loads of kSlideBatch diagonals before it adds them (in offset order).
template <typename S>
__global__ void __launch_bounds__(kSlideThreads) dia_pair_slide_kernel(
    const S* __restrict__ rows, long long stride, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ u, float* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n, int lo, int hi,
    long long units) {
  constexpr int V = 16 / sizeof(S);
  constexpr int C = kSlideChunk;
  constexpr int R = C / kSlideThreads;
  constexpr int B = kSlideBatch;
  constexpr int kPieces = C / V;  // 16-byte copies a chunk and diagonal
  extern __shared__ __align__(16) unsigned char smem[];
  const SlideLayout lay(nd, lo, hi, sizeof(S));
  const int G = lay.G, W = lay.W;
  S* const win = reinterpret_cast<S*>(smem);
  float* const u_s = reinterpret_cast<float*>(smem + lay.u_at);
  float* const x_s = u_s + W;  // x[c0 - lo + e] at e
  int* const ks = reinterpret_cast<int*>(x_s + lay.LX);  // 16-byte aligned: W % 4 == 0
  int* const zo = ks + lay.nd4;  // G - lo - k_d: the place of row c0 - lo - k_d
  const int tid = threadIdx.x;
  const long long dim = m > n ? m : n;
  const long long a = static_cast<long long>(blockIdx.x) * units / gridDim.x * C;
  long long b = (static_cast<long long>(blockIdx.x) + 1) * units / gridDim.x * C;
  b = b < dim ? b : dim;
  if (a >= b) return;
  for (int d = tid; d < nd; d += kSlideThreads) {
    const int k = __ldg(offsets + d);
    ks[d] = k;
    zo[d] = G - lo - k;
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(rows) / sizeof(S)) % V);
  const long long t0 = ph + a - hi;  // s0: at or below a - hi, on the 16-byte grid
  const long long s0 = (t0 >= 0 ? t0 / V : -((V - 1 - t0) / V)) * V - ph;
  const int steps = static_cast<int>((b + lo - s0 + C - 1) / C);
  const int nb = nd / B * B;  // diagonals taken in whole batches
  __syncthreads();  // ks, zo

  for (int k = 0; k < steps; ++k) {
    const long long c0 = s0 + static_cast<long long>(k) * C;
    // 0. slide: places [C, C + G) (rows [c0 - G, c0)) move to [0, G), in
    // pieces of at most C places, each read before the next one is written
    for (int q0 = 0; k > 0 && q0 < G; q0 += C) {
      const int len = G - q0 < C ? G - q0 : C;
      for (int e = tid; e < (nd + 1) * (len / 4); e += kSlideThreads) {
        const int d = e / (len / 4), q = q0 + (e % (len / 4)) * 4;
        if (d < nd) {  // 4 elements: 16 bytes (f32) or 8 (bf16)
          S* row = win + static_cast<long long>(d) * W;
          if constexpr (sizeof(S) == 4) {
            *reinterpret_cast<float4*>(row + q) = *reinterpret_cast<const float4*>(row + q + C);
          } else {
            *reinterpret_cast<uint2*>(row + q) = *reinterpret_cast<const uint2*>(row + q + C);
          }
        } else {
          *reinterpret_cast<float4*>(u_s + q) = *reinterpret_cast<const float4*>(u_s + q + C);
        }
      }
      __syncthreads();
    }
    // 1. chunk k's stripe rows in [0, m) to places [G, G + C), and its x
    // window (zero outside [0, n): never read there)
    for (int e = tid; e < nd * kPieces; e += kSlideThreads) {
      const int d = e / kPieces, q = (e % kPieces) * V;
      const long long r = c0 + q;
      if (r + V > 0 && r < m) {
        cp_async16(win + static_cast<long long>(d) * W + G + q, rows + d * stride + r);
      }
    }
    cp_async_commit();
    for (int e = tid; e < C + lo + hi; e += kSlideThreads) {
      const long long c = c0 - lo + e;
      x_s[e] = c >= 0 && c < n ? __ldg(vec + c) : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    // 2. u for rows [c0, c0 + C): -c2 y, then the diagonals in offset
    // order; when all the thread's rows have their whole band inside
    // [0, n), without the mask
    {
      float acc[R];
      bool ok[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long r = c0 + tid + i * kSlideThreads;
        ok[i] = r >= 0 && r < m;
        acc[i] = ok[i] ? (-c2) * __ldg(y + r) : 0.0f;
      }
      const long long r0 = c0 + tid, rl = r0 + (R - 1) * kSlideThreads;
      const S* sr = win + G + tid;        // row r0 of diagonal d at sr[d * W]
      const float* xr = x_s + lo + tid;   // x[r0 + k] at xr[k]
      if (ok[0] && ok[R - 1] && r0 >= lo && rl + hi < n) {
        for (int d = 0; d < nb; d += B) {
          int kk[B];
#pragma unroll
          for (int q = 0; q < B; q += 4) {
            const int4 k4 = *reinterpret_cast<const int4*>(ks + d + q);
            kk[q] = k4.x, kk[q + 1] = k4.y, kk[q + 2] = k4.z, kk[q + 3] = k4.w;
          }
          float sv[R][B], xv[R][B];
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int q = 0; q < B; ++q) {
              sv[i][q] = lds(sr + (d + q) * W + i * kSlideThreads);
              xv[i][q] = xr[i * kSlideThreads + kk[q]];
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int q = 0; q < B; ++q) acc[i] += sv[i][q] * (xv[i][q] * c1);
          }
        }
        for (int d = nb; d < nd; ++d) {
          const int kd = ks[d];
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc[i] += lds(sr + d * W + i * kSlideThreads) * (xr[i * kSlideThreads + kd] * c1);
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int kd = ks[d];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const long long c = r0 + i * kSlideThreads + kd;
            if (ok[i] && c >= 0 && c < n)
              acc[i] += lds(sr + d * W + i * kSlideThreads) * (xr[i * kSlideThreads + kd] * c1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long r = r0 + i * kSlideThreads;
        if (ok[i] && r >= a && r < b) u[r] = acc[i];
        u_s[G + tid + i * kSlideThreads] = acc[i];  // zero outside [0, m)
      }
    }
    __syncthreads();
    // 3. z[j] = sum_d A[j - k, j] * u[j - k] for the columns [c0 - lo,
    // c0 + C - lo) of [a, b): row j - k at place zo[d] + t; when all the
    // thread's columns have their rows inside [0, m), without the mask
    {
      const long long j0 = c0 - lo + tid, jl = j0 + (R - 1) * kSlideThreads;
      float acc[R];
      bool ok[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long j = j0 + i * kSlideThreads;
        ok[i] = j >= a && j < b && j < n;
        acc[i] = 0.0f;
      }
      const S* st = win + tid;
      const float* ut = u_s + tid;
      if (ok[0] && ok[R - 1] && j0 >= hi && jl + lo < m) {
        for (int d = 0; d < nb; d += B) {
          int zz[B];
#pragma unroll
          for (int q = 0; q < B; q += 4) {
            const int4 z4 = *reinterpret_cast<const int4*>(zo + d + q);
            zz[q] = z4.x, zz[q + 1] = z4.y, zz[q + 2] = z4.z, zz[q + 3] = z4.w;
          }
          float sv[R][B], uv[R][B];
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int q = 0; q < B; ++q) {
              sv[i][q] = lds(st + (d + q) * W + zz[q] + i * kSlideThreads);
              uv[i][q] = ut[zz[q] + i * kSlideThreads];
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int q = 0; q < B; ++q) acc[i] += sv[i][q] * uv[i][q];
          }
        }
        for (int d = nb; d < nd; ++d) {
          const int zd = zo[d];
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc[i] += lds(st + d * W + zd + i * kSlideThreads) * ut[zd + i * kSlideThreads];
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int kd = ks[d], zd = zo[d];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const long long rr = j0 + i * kSlideThreads - kd;
            if (ok[i] && rr >= 0 && rr < m)
              acc[i] += lds(st + d * W + zd + i * kSlideThreads) * ut[zd + i * kSlideThreads];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (ok[i]) z[j0 + i * kSlideThreads] = acc[i];
      }
    }
    __syncthreads();  // before the next step slides the window
  }
}

template <typename S>
int launch_pair_slide(const void* dp, const void* vec, const void* y, const void* c1,
                     const void* c2, void* u, void* z, const void* offsets, int nd,
                     long long Lp, int H, long long m, long long n, int lo, int hi,
                     void* stream) {
  if (H < 0 || H > kPairMaxHalo || lo < 0 || hi < 0 || lo > H || hi > H || Lp % 16 ||
      !aligned16(dp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long dim = m > n ? m : n;
  if (dim == 0) return 0;
  const SlideLayout lay(nd, lo, hi, sizeof(S));
  auto kernel = dia_pair_slide_kernel<S>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kSlideThreads, lay.bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units = (dim + kSlideChunk - 1) / kSlideChunk;
  const long long slots = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(units < slots ? units : slots), kSlideThreads, lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dp) + H, Lp, static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(u), static_cast<float*>(z),
      static_cast<const int*>(offsets), nd, m, n, lo, hi, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
int lsqr_dia_pair_slide_f32(const void* dp, const void* vec, const void* y, const void* c1,
                            const void* c2, void* u, void* z, const void* offsets, int nd,
                            long long Lp, int H, long long m, long long n, int lo, int hi,
                            void* stream) {
  return launch_pair_slide<float>(dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n, lo, hi,
                                  stream);
}
int lsqr_dia_pair_slide_bf16(const void* dp, const void* vec, const void* y, const void* c1,
                             const void* c2, void* u, void* z, const void* offsets, int nd,
                             long long Lp, int H, long long m, long long n, int lo, int hi,
                             void* stream) {
  return launch_pair_slide<__nv_bfloat16>(dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n,
                                          lo, hi, stream);
}
}  // extern "C"
"""


def yardstick():
    """This checkout's ``chip_smoke.py`` (loaded by path, so that a checkout
    under test cannot replace it): its shapes, seeds and ``time_ms``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ring_source(C, T, A, B):
    """csrc/dia_shared.cu with these ring constants."""
    src = (CSRC / "dia_shared.cu").read_text().replace(
        '#include "dia_pair_staged.cuh"', f'#include "{CSRC / "dia_pair_staged.cuh"}"')
    for name, value in (("int kRingThreads", T), ("int kRingChunk", C), ("int kRingAhead", A),
                        ("int kRingBatch", B)):
        line = next((ln for ln in src.splitlines() if ln.startswith(f"constexpr {name} = ")),
                    None)
        if line is None:
            raise RuntimeError(f"csrc/dia_shared.cu no longer defines {name}")
        src = src.replace(line, f"constexpr {name} = {value};")
    return src


def designs():
    """{name: (source, {kind: entry point})}."""
    out = {}
    for C, T, A, B in RINGS:
        out[f"ring {C}/{T}/{A}/{B}"] = (ring_source(C, T, A, B), {
            "dia f32": "lsqr_dia_pair_shared_f32", "dia bf16": "lsqr_dia_pair_shared_bf16"})
    for tile, mb in PERSISTS:
        out[f"persist {tile}/{mb}"] = (
            PERSIST.replace("@SHIPPED@", str(CSRC / "dia_shared.cu"))
            .replace("@TILE@", str(tile)).replace("@BUDGET@", str(mb * 10 ** 6)),
            {"dia f32": "lsqr_dia_pair_persist_f32", "dia bf16": "lsqr_dia_pair_persist_bf16"})
    out["slide 128/128/4"] = (SLIDE.replace("@SHIPPED@", str(CSRC / "dia_shared.cu")), {
        "dia f32": "lsqr_dia_pair_slide_f32", "dia bf16": "lsqr_dia_pair_slide_bf16"})
    out["cluster"] = ((CSRC / "block_ell.cu").read_text(), {"bell": "lsqr_block_ell_pair_f32"})
    out["rows"] = (ROWS.replace("@SHIPPED@", str(CSRC / "block_ell.cu")),
                   {"bell": "lsqr_block_ell_pair_rows_f32"})
    return out


def build(out_dir, table):
    """{design: loaded library}: every design compiled at once."""
    from lsqr_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _) in table.items():
        stem = name.replace(" ", "_").replace("/", "-")
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
            sig = _cuda._SIGNATURES["lsqr_block_ell_pair_f32" if kind == "bell"
                                    else "lsqr_dia_pair_shared_f32"]
            getattr(lib, entry).argtypes = sig
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def run_designs(reps):
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import random_block_coo
    from lsqr_tpu_torch.ops import spmv
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    smoke = yardstick()
    table = designs()
    libs = build(HERE / "build" / "pair_designs", table)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {"times": {}, "max_abs_diff_to_shipped": {}}
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)

    def record(tag, fn, ref):
        got = fn()
        torch.cuda.synchronize()
        diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
        res["max_abs_diff_to_shipped"][tag] = diff
        res["times"][tag] = smoke.time_ms(fn, reps)
        smoke.log(f"  {tag:40s} {res['times'][tag]:.5f} ms  (max |diff| to shipped {diff:.3e})")
        return diff

    m, ks, boost = smoke.MANY
    lo, hi = spmv._halos(ks)
    data, b, g = smoke.random_stripes(m, m, ks, dev, seed=104, boost=boost)
    v = torch.randn(m, generator=g, device=dev)
    for storage in (torch.float32, torch.bfloat16):
        kind = "dia f32" if storage == torch.float32 else "dia bf16"
        A = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
        H, Lp = spmv._geometry(ks, m, m)
        kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
        ref = spmv._dia_pair_shared_launch(A.dp, v, b, c1, c2, tile=0, **kw)
        record(f"{kind} shipped (wrapper)",
               lambda: spmv._dia_pair_shared_launch(A.dp, v, b, c1, c2, tile=0, **kw), ref)
        for name, lib in libs.items():
            if kind not in table[name][1]:
                continue
            entry = getattr(lib, table[name][1][kind])

            def call(entry=entry, name=name):
                u = torch.empty(m, device=dev)
                z = torch.empty(m, device=dev)
                err = entry(A.dp.data_ptr(), v.data_ptr(), b.data_ptr(), c1.data_ptr(),
                            c2.data_ptr(), u.data_ptr(), z.data_ptr(), A.offsets_t.data_ptr(),
                            len(ks), Lp, H, m, m, lo, hi, stream())
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return u, z
            try:
                diff = record(f"{kind} {name}", call, ref)
            except RuntimeError as e:  # a ring too large for shared memory
                smoke.log(f"  {kind} {name}: {e}")
                res["times"][f"{kind} {name}"] = None
                continue
            smoke.check(diff == 0.0, f"{kind} {name}: not the shipped kernel's bits")
        del A
    del data, b, v
    torch.cuda.empty_cache()

    mm = smoke.M_BELL
    A = lt.block_ell_operator(mm, mm, *random_block_coo(mm, mm, diag=2.0, seed=13), device=dev)
    x, y = smoke.padded_vectors(dev, A, 13)
    mb, kb, bh, bw = A.blocks.shape
    twin = sp.block_ell_pair_plain(A.blocks, A.bcols, x, y, c1, c2)
    ref = sp.block_ell_pair_windowed(A.blocks, A.bcols, x, y, c1, c2)
    plan = sp.block_ell_pair_plan(kb, bh, bw, torch.cuda.get_device_properties(dev)
                                  .shared_memory_per_block_optin)
    record("bell shipped (wrapper)",
           lambda: sp.block_ell_pair_windowed(A.blocks, A.bcols, x, y, c1, c2), ref)
    for name, keep in [("cluster", int(plan.keep))] + [("rows", p) for p in ROWS_PER_SM]:
        entry = getattr(libs[name], table[name][1]["bell"])

        def call(entry=entry, keep=keep):
            u = torch.empty(mb * bh, device=dev)
            zp = torch.empty((mb, kb, bw), device=dev)
            err = entry(A.blocks.data_ptr(), A.bcols.data_ptr(), x.data_ptr(), y.data_ptr(),
                        c1.data_ptr(), c2.data_ptr(), u.data_ptr(), zp.data_ptr(), mb, kb, bh,
                        bw, plan.ranks, keep, stream())
            if err:
                raise RuntimeError(f"CUDA error {err}")
            return u, zp
        tag = f"bell {name}" + ("" if name == "cluster" else f" {keep}/SM")
        record(tag, call, ref)
        got = call()
        err = max(smoke.rel(a, t) for a, t in zip(got, twin))
        smoke.check(err <= 1e-5, f"{tag}: rel err {err:.3e} to the twin")
    return res


def one(root, reps, dump):
    """Times, solves and results of the checkout at ``root`` (this process)."""
    sys.path.insert(0, str(root))
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import random_block_coo
    from lsqr_tpu_torch.ops import spmv
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    assert Path(lt.__file__).resolve().is_relative_to(Path(root).resolve()), lt.__file__
    smoke = yardstick()
    dev = torch.device("cuda")
    out, saved = {}, {}
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    m, ks, boost = smoke.MANY
    data, b, g = smoke.random_stripes(m, m, ks, dev, seed=104, boost=boost)
    v = torch.randn(m, generator=g, device=dev)
    for storage in (torch.float32, torch.bfloat16):
        tag = str(storage)[6:]
        A = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
        kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
        fn = lambda: spmv._dia_pair_shared_launch(A.dp, v, b, c1, c2, tile=0, **kw)  # noqa
        out[f"dia_pair_shared[{spmv.UNSTAGED[storage]}] MANY"] = smoke.time_ms(fn, reps)
        saved[f"pair {tag}"] = [t.cpu() for t in fn()]
        res = lt.lsqr(A, b, smoke.DAMP, atol=1e-6, btol=1e-6)
        out[f"solve {tag} MANY"] = dict(istop=int(res.istop), itn=int(res.itn))
        saved[f"x {tag}"] = [res.x.cpu()]
        prof = smoke.phase_launches(A, b)
        out[f"solve {tag} MANY"]["kernel_ms_per_iteration"] = prof["kernel_ms_per_iteration"]
        del A
    del data, b, v
    torch.cuda.empty_cache()
    mm = smoke.M_BELL
    A = lt.block_ell_operator(mm, mm, *random_block_coo(mm, mm, diag=2.0, seed=13), device=dev)
    x, y = smoke.padded_vectors(dev, A, 13)
    args = (A.blocks, A.bcols, x, y, c1, c2)
    out["block_ell_pair_windowed[2^18]"] = smoke.time_ms(
        lambda: sp.block_ell_pair_windowed(*args), reps)
    saved["bell pair"] = [t.cpu() for t in sp.block_ell_pair_windowed(*args)]
    b = torch.randn(A.m, generator=torch.Generator(device=dev).manual_seed(22), device=dev)
    res = lt.lsqr(A, b, smoke.DAMP, atol=1e-6, btol=1e-6, pair=True)
    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65, pair=True)
    lt.lsqr(A, b, smoke.DAMP, **fixed)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lt.lsqr(A, b, smoke.DAMP, **fixed)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 64
    prof = smoke.phase_launches(A, b, pair=True)
    out["solve bell pair=True"] = dict(istop=int(res.istop), itn=int(res.itn),
                                       kernel_ms_per_iteration=prof["kernel_ms_per_iteration"],
                                       wall_ms_per_iteration=wall)
    saved["x bell pair=True"] = [res.x.cpu()]
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
    return out


def run_times(roots, reps):
    import torch

    runs = []
    dumps = HERE / "build" / "pair_designs" / "times"
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
                tag: [float((a.double() - b.double()).abs().max())
                      for a, b in zip(this[tag], first[tag])] for tag in this}
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
        print("pair_designs: no CUDA device", file=sys.stderr)
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
