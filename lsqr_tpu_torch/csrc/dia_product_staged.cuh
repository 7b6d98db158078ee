// The staged DIA product for Hopper (sm_90a), shared by both stripe layouts:
//     out[i] = sum_d rows[d * stride + r_d(i)] * vec[i + kk_d],  0 <= i < dim_out,
// the vector index masked to [0, dim_in), in f32 from f32 or bf16 stripes.
// csrc/dia_packed.cu (dia_matvec) and csrc/dia_shared.cu (dia_product_shared)
// include it; it replaces, with them, the TPU kernels dia_matvec and
// dia_product_shared (lsqr_tpu/ops/pallas_spmv.py).
//
// A side is a row stride, a row base and a direction:
//     forward  r_d(i) = i,        kk_d = k_d
//              packed data (stride m), packed tdata (stride n, offsets -k),
//              shared (stride Lp, base H)
//     column   r_d(i) = i - k_d,  kk_d = -k_d
//              packed data read from the column side (stride m), shared adjoint
// The kernel takes rows = stripes + base. A summed element's row index is a
// vector index in [0, dim_in) (column) or an output index (forward), so it
// lies inside its row; elements outside the row are never summed.
//
// What bounds it on the H100: bytes (~2 flops per stripe element read, far
// below the card's ~20 flop/byte ridge): the stripes once, the vector and
// the result. The first design (one thread an output, kept as the direct
// kernel of both sources) issues one dependent stripe load a diagonal (2
// bytes in bf16) and reads the vector window through L1/L2 once a diagonal.
//
// What the design does about it (row 3's staged half-step and the
// megakernels' staged phases, without y): a persistent grid of at most
// kProductBlocks blocks an SM walks tiles of T outputs and keeps
// kProductStages of them in shared memory, the next one's 16-byte cp.async
// copies in flight while this one is summed. A stage holds each diagonal's
// T + 16/esize stripe elements from the 16-byte boundary at or before its
// first, and the vector window [c0 - lo, c0 + T + hi) clipped to
// [0, dim_in). A row's 16-byte phase comes from its own address: where the
// stride is a multiple of 16 bytes' worth (the shared layout, whose Lp is a
// multiple of 1024, and packed rows of such a length) every row has row 0's
// phase and the kernel computes it (Uniform), else a table in shared memory
// holds each diagonal's. A piece wholly outside the stripe allocation (the
// column side's first and last diagonals, past the rows' ends) is not
// copied: it holds no summed element. Each thread sums R outputs
// kProductThreads apart side by side, the diagonals in offset order from
// +0, issuing kProductBatch diagonals' loads before it adds them; an output
// whose whole band lies inside [0, dim_in) skips the mask. The order and the
// expression (acc += stripe * vec) are the direct kernel's, so the two give
// the same bits. On the H100 (tools/product_designs.py, PERF.md) the table
// on every side cost 0-2.2% at 2^23 x 11 and 4-17% at 2^20 x 81, and four
// bf16 blocks an SM (as many as fit at 2^23 x 11) 1.4-4.3% against two. T
// comes from ops/spmv.py: product_tile (ProductLayout's bytes, mirrored
// there as product_stage_bytes: change both together); T = 0 (a vector
// window too wide for any tile, and f64 stripes) takes the direct kernel.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_pair_staged.cuh"

namespace {

constexpr int kProductThreads = 256;
constexpr int kProductStages = 2;  // tiles in shared memory, the one summed included
constexpr int kProductBatch = 4;   // diagonals whose loads a thread issues together
constexpr int kProductBlocks = 2;  // most blocks an SM of the persistent grid
static_assert(kProductStages >= 2 && kProductBatch % 4 == 0, "product shape");

// A stage: nd rows of L = T + V stripe elements (V = 16 bytes' worth) and
// the vector window (T + lo + hi floats and up to 3 in front, rounded up to
// 4); kProductStages of them, then two ints a diagonal (nd rounded up to 4
// each): the offsets in the direction taken and the rows' phases. T is a
// multiple of 16, so every part starts on the 16-byte grid.
struct ProductLayout {
  long long L, LX, stage, bytes;
  int nd4;
  __host__ __device__ ProductLayout(int nd, int lo, int hi, int T, int esize) {
    L = static_cast<long long>(T) + 16 / esize;
    LX = round_up(static_cast<long long>(T) + lo + hi + 3, 4);
    stage = static_cast<long long>(nd) * L * esize + LX * 4;
    nd4 = static_cast<int>(round_up(nd, 4));
    bytes = kProductStages * stage + 8LL * nd4;
  }
};

// The place in 16 bytes of diagonal d's element c0 + s_d (s_d = kk_d on the
// column side, else 0), from cb = tile_phase(ph, c0) and either s_d (Uniform:
// every row at row 0's phase ph) or the table entry pq (the phase of the
// row's element s_d).
template <int V, bool Uniform>
__device__ __forceinline__ int tile_phase(int ph, long long c0) {
  return static_cast<int>(((Uniform ? ph : 0) + c0) & (V - 1));
}
template <int V, bool Uniform>
__device__ __forceinline__ int piece_shift(int cb, int kk, int pq, int column) {
  return (cb + (Uniform ? (column ? kk : 0) : pq)) & (V - 1);
}

// Stage the tile of outputs [c0, c0 + T) into `buf` (no commit). [lim_lo,
// lim_hi): the stripe allocation's elements relative to rows.
template <typename S, bool Uniform>
__device__ __forceinline__ void product_stage(unsigned char* buf, const ProductLayout& lay,
                                              const S* __restrict__ rows, long long stride,
                                              long long lim_lo, long long lim_hi, int ph,
                                              const int* kk, const int* pq,
                                              const float* __restrict__ vec, int nd,
                                              long long dim_out, long long dim_in, int lo,
                                              int hi, int T, long long c0, int column) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(dim_out - c0 < T ? dim_out - c0 : T);
  const int P = static_cast<int>(lay.L / V);  // 16-byte pieces a row holds
  const int cb = tile_phase<V, Uniform>(ph, c0);
  S* const st = reinterpret_cast<S*>(buf);
  for (int e = threadIdx.x; e < nd * P; e += blockDim.x) {
    const int d = e / P, q = (e - d * P) * V;
    const int sh = piece_shift<V, Uniform>(cb, kk[d], Uniform ? 0 : pq[d], column);
    if (q < sh + len) {
      const long long g = d * stride + c0 + (column ? kk[d] : 0) - sh + q;
      if (g + V > lim_lo && g < lim_hi) cp_async16(st + d * lay.L + q, rows + g);
    }
  }
  float* const xs = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S));
  const long long xa = c0 - lo > 0 ? c0 - lo : 0;
  const long long xb = c0 + len + hi < dim_in ? c0 + len + hi : dim_in;
  if (xa < xb) {
    const int shx = static_cast<int>(xa & 3);
    for (int q = threadIdx.x * 4; q < shx + (xb - xa); q += blockDim.x * 4) {
      cp_async16(xs + q, vec + xa - shx + q);
    }
  }
}

// Sum the staged tile [c0, c0 + T) into out: R outputs a thread,
// kProductThreads apart, from +0, the diagonals in offset order.
template <typename S, int R, bool Uniform>
__device__ __forceinline__ void product_sum(const unsigned char* buf, const ProductLayout& lay,
                                            int ph, const int* kk, const int* pq, int nd,
                                            float* __restrict__ out, long long dim_out,
                                            long long dim_in, int lo, int hi, int T,
                                            long long c0, int column) {
  constexpr int V = 16 / sizeof(S);
  constexpr int kS = kProductThreads;
  constexpr int B = kProductBatch;
  const S* const st = reinterpret_cast<const S*>(buf);
  const float* const xs = reinterpret_cast<const float*>(buf + nd * lay.L * sizeof(S));
  const long long xa = c0 - lo > 0 ? c0 - lo : 0;
  const int cb = tile_phase<V, Uniform>(ph, c0);
  const int nb = nd / B * B;  // diagonals taken in whole batches
  for (int g = 0; g < T; g += kS * R) {
    const int t0 = g + threadIdx.x;  // this thread's outputs c0 + t0 + kS q
    const long long i0 = c0 + t0;
    const float* const xb = xs + (xa & 3) + (i0 - xa);  // vec[i0 + kS q + k] at xb[kS q + k]
    float acc[R];
    bool ok[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      ok[q] = t0 + q * kS < T && i0 + q * kS < dim_out;
      acc[q] = 0.0f;
    }
    if (ok[R - 1] && i0 >= lo && i0 + (R - 1) * kS + hi < dim_in) {
      for (int d = 0; d < nb; d += B) {
        int kq[B], pp[B];
#pragma unroll
        for (int b = 0; b < B; b += 4) {
          const int4 k4 = *reinterpret_cast<const int4*>(kk + d + b);
          kq[b] = k4.x, kq[b + 1] = k4.y, kq[b + 2] = k4.z, kq[b + 3] = k4.w;
          if (!Uniform) {
            const int4 p4 = *reinterpret_cast<const int4*>(pq + d + b);
            pp[b] = p4.x, pp[b + 1] = p4.y, pp[b + 2] = p4.z, pp[b + 3] = p4.w;
          } else {
            pp[b] = pp[b + 1] = pp[b + 2] = pp[b + 3] = 0;
          }
        }
        float sv[R][B], xv[R][B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const S* sd = st + (d + b) * lay.L + t0 +
                        piece_shift<V, Uniform>(cb, kq[b], pp[b], column);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            sv[q][b] = lds(sd + q * kS);
            xv[q][b] = xb[q * kS + kq[b]];
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int b = 0; b < B; ++b) acc[q] += sv[q][b] * xv[q][b];
        }
      }
      for (int d = nb; d < nd; ++d) {
        const int k = kk[d];
        const S* sd = st + d * lay.L + t0 +
                      piece_shift<V, Uniform>(cb, k, Uniform ? 0 : pq[d], column);
#pragma unroll
        for (int q = 0; q < R; ++q) acc[q] += lds(sd + q * kS) * xb[q * kS + k];
      }
    } else {
      for (int d = 0; d < nd; ++d) {
        const int k = kk[d];
        const S* sd = st + d * lay.L + t0 +
                      piece_shift<V, Uniform>(cb, k, Uniform ? 0 : pq[d], column);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const long long src = i0 + q * kS + k;
          if (ok[q] && src >= 0 && src < dim_in) acc[q] += lds(sd + q * kS) * xb[q * kS + k];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (ok[q]) out[i0 + q * kS] = acc[q];
    }
  }
}

// lo, hi: the halos of the direction taken. Each iteration waits for its
// tile's copies, synchronises (so every thread has also left the tile
// before, whose stage the next copies reuse), stages the tile
// kProductStages - 1 ahead and sums its own: one barrier a tile.
template <typename S, int R, bool Uniform>
__global__ void __launch_bounds__(kProductThreads) dia_product_staged_kernel(
    const S* __restrict__ rows, long long stride, long long lim_lo, long long lim_hi,
    const float* __restrict__ vec, float* __restrict__ out, const int* __restrict__ offsets,
    int nd, long long dim_out, long long dim_in, int lo, int hi, int T, long long tiles,
    int column) {
  constexpr int V = 16 / sizeof(S);
  extern __shared__ __align__(16) unsigned char smem[];
  const ProductLayout lay(nd, lo, hi, T, sizeof(S));
  int* const kk = reinterpret_cast<int*>(smem + kProductStages * lay.stage);
  int* const pq = kk + lay.nd4;
  const unsigned long long r0 = reinterpret_cast<uintptr_t>(rows) / sizeof(S);
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    const int k = __ldg(offsets + d);
    kk[d] = column ? -k : k;
    const long long s = column ? -k : 0;  // the row index of output 0
    pq[d] = static_cast<int>((r0 + static_cast<unsigned long long>(d) * stride +
                              static_cast<unsigned long long>(s)) & (V - 1));
  }
  const int ph = static_cast<int>(r0 & (V - 1));
  const long long grid = gridDim.x;
  __syncthreads();  // kk, pq
#pragma unroll
  for (int s = 0; s < kProductStages - 1; ++s) {
    const long long tile = blockIdx.x + s * grid;
    if (tile < tiles) {
      product_stage<S, Uniform>(smem + s * lay.stage, lay, rows, stride, lim_lo, lim_hi, ph,
                                kk, pq, vec, nd, dim_out, dim_in, lo, hi, T, tile * T, column);
    }
    cp_async_commit();
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    cp_async_wait_group<kProductStages - 2>();  // this tile's copies
    __syncthreads();
    const long long ahead = tile + (kProductStages - 1) * grid;
    if (ahead < tiles) {
      product_stage<S, Uniform>(smem + (it + kProductStages - 1) % kProductStages * lay.stage,
                                lay, rows, stride, lim_lo, lim_hi, ph, kk, pq, vec, nd, dim_out,
                                dim_in, lo, hi, T, ahead * T, column);
    }
    cp_async_commit();
    product_sum<S, R, Uniform>(smem + it % kProductStages * lay.stage, lay, ph, kk, pq, nd, out,
                               dim_out, dim_in, lo, hi, T, tile * T, column);
  }
  cp_async_wait_group<0>();  // the empty groups of the last steps
}

template <typename S, int R, bool Uniform>
int launch_product_tiles(const S* rows, long long stride, long long lim_lo, long long lim_hi,
                         const float* vec, float* out, const int* offsets, int nd,
                         long long dim_out, long long dim_in, int lo, int hi, int T, int column,
                         cudaStream_t stream) {
  const ProductLayout lay(nd, lo, hi, T, sizeof(S));
  auto kernel = dia_product_staged_kernel<S, R, Uniform>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kProductThreads, lay.bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (per_sm > kProductBlocks) per_sm = kProductBlocks;
  const long long tiles = (dim_out + T - 1) / T;
  const long long slots = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(tiles < slots ? tiles : slots), kProductThreads, lay.bytes,
           stream>>>(rows, stride, lim_lo, lim_hi, vec, out, offsets, nd, dim_out, dim_in, lo,
                     hi, T, tiles, column);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, bool Uniform>
int launch_product_rows(const S* rows, long long stride, long long lim_lo, long long lim_hi,
                        const float* vec, float* out, const int* offsets, int nd,
                        long long dim_out, long long dim_in, int lo, int hi, int T, int column,
                        cudaStream_t stream) {
  if (T >= 4 * kProductThreads) {
    return launch_product_tiles<S, 4, Uniform>(rows, stride, lim_lo, lim_hi, vec, out, offsets,
                                               nd, dim_out, dim_in, lo, hi, T, column, stream);
  }
  if (T >= 2 * kProductThreads) {
    return launch_product_tiles<S, 2, Uniform>(rows, stride, lim_lo, lim_hi, vec, out, offsets,
                                               nd, dim_out, dim_in, lo, hi, T, column, stream);
  }
  return launch_product_tiles<S, 1, Uniform>(rows, stride, lim_lo, lim_hi, vec, out, offsets,
                                             nd, dim_out, dim_in, lo, hi, T, column, stream);
}

// The staged product in tiles of T on stripes of `count` elements (16-byte
// aligned) whose row r of diagonal d sits at stripes[base + d * stride + r];
// lo = max(0, -k_min), hi = max(0, k_max) of the offsets given (the column
// side swaps them); vec 16-byte aligned.
template <typename S>
int launch_product_staged(const void* stripes, long long count, long long stride,
                          long long base, const void* vec, void* out, const void* offsets,
                          int nd, long long dim_out, long long dim_in, int column, int lo, int hi,
                          int T, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(S);
  if (T < 16 || T % 16 || lo < 0 || hi < 0 || stride < 0 || base < 0 || !aligned16(stripes) ||
      !aligned16(vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim_out == 0) return 0;
  const int lo_ = column ? hi : lo, hi_ = column ? lo : hi;  // this direction's halos
  const S* rows = static_cast<const S*>(stripes) + base;
  const auto* vp = static_cast<const float*>(vec);
  auto* op = static_cast<float*>(out);
  const auto* off = static_cast<const int*>(offsets);
  if (stride % V == 0) {  // every row at row 0's 16-byte phase
    return launch_product_rows<S, true>(rows, stride, -base, count - base, vp, op, off, nd,
                                        dim_out, dim_in, lo_, hi_, T, column, stream);
  }
  return launch_product_rows<S, false>(rows, stride, -base, count - base, vp, op, off, nd,
                                       dim_out, dim_in, lo_, hi_, T, column, stream);
}

}  // namespace
