// The staged DIA product for Hopper (sm_90a), shared by both stripe layouts:
//     out[i] = sum_d rows[d * stride + r_d(i)] * vec[i + kk_d],  0 <= i < dim_out,
// the vector index masked to [0, dim_in), in f32 from f32 or bf16 stripes.
// csrc/dia_packed.cu (dia_matvec) and csrc/dia_shared.cu (dia_product_shared)
// include it; it replaces, with them, the TPU kernels dia_matvec and
// dia_product_shared (lsqr_tpu/ops/pallas_spmv.py).
//
// The same kernel, instantiated with a half-step (Step != kPlain), is the
// staged route of the fused half-step's two variants, dia_fused_halfstep_v2
// and _v3 (csrc/dia_packed.cu), forward on packed rows (data, or tdata with
// offsets -k):
//     out[i] = -c2 y[i] + sum_d rows[d * stride + i] * (vec[i + k_d] c1),
// out in O (f32, or bf16 rounded to nearest even), and the sum of the
// unrounded f32 out[i] squared. Every half-step part sits behind
// `if constexpr`, so the plain product's instantiations take none of it.
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
//
// The half-step adds to a stage y's T rows (so it stages what row 3's
// dia_axpy_staged_kernel stages, on the packed layout) and starts each sum
// at (-c2) y[i], then adds stripe * (vec * c1) in offset order: the direct
// kernel's expression and order (csrc/dia_packed.cu: axpy_row), so out has
// its bits. The sum of squares takes one partial a tile, in slot `tile` of
// `partial` (tiles = ceil(dim_out / T) slots, whatever the grid): each
// thread adds its outputs' squares in order, each warp folds its lanes in a
// fixed tree (__shfl_down_sync), and after the next tile's barrier thread 0
// adds the tile's warp sums in warp order (no barrier of its own). A slot
// a tile, not a block, keeps the bits independent of the grid (blocks an
// SM, the card's SM count). kPartials stops there (v3: the wrapper adds the
// slots); kTicketed (v2) then takes an integer ticket after __threadfence,
// and the last block adds the slots in slot order into ssq and resets the
// ticket. No float atomics: the same bits from run to run. T comes from
// ops/spmv.py: halfstep_tile (halfstep_stage_bytes mirrors the layout). On
// the H100 at 2^23 x 11 (tools/product_designs.py, PERF.md) it takes
// 0.100-0.104 ms in bf16 and 0.169-0.173 in f32 against the direct
// kernel's 0.194-0.197, 77-83% of its bound; three stages, one or three
// blocks an SM, 128 threads, a batch of 8, other tiles and one slot a block
// were none faster. In f32 where only one block an SM fits (61 and 81
// diagonals at 2^20) the direct kernel was the faster, so halfstep_tile
// gives f32 only tiles two blocks of which fit (up to 53 diagonals).

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
constexpr int kSlotBatch = 16;     // slots a thread of v2's last block loads together
static_assert(kProductStages >= 2 && kProductBatch % 4 == 0, "product shape");
constexpr int kProductWarps = kProductThreads / 32;

// What a staged launch computes: the product, or a half-step whose sum of
// squares stops at the per-tile slots (v3) or is added up by the last block
// (v2).
constexpr int kPlain = 0, kPartials = 1, kTicketed = 2;

// The half-step's operands (all null for the product): y (dim_out floats),
// the device scalars c1 and c2, the per-tile slots, and for kTicketed the
// ticket (0 on entry, left 0) and the result.
struct StepArgs {
  const float* y;
  const float* c1;
  const float* c2;
  float* partial;
  unsigned int* ticket;
  float* ssq;
};

// A stage: nd rows of L = T + V stripe elements (V = 16 bytes' worth) and
// the vector window (T + lo + hi floats and up to 3 in front, rounded up to
// 4), and for a half-step T floats of y; kProductStages of them, then two
// ints a diagonal (nd rounded up to 4 each): the offsets in the direction
// taken and the rows' phases; a half-step then keeps two tiles' warp sums
// (2 kProductWarps floats). T is a multiple of 16, so every part starts on
// the 16-byte grid.
struct ProductLayout {
  long long L, LX, stage, bytes;
  int nd4;
  __host__ __device__ ProductLayout(int nd, int lo, int hi, int T, int esize, bool step = false) {
    L = static_cast<long long>(T) + 16 / esize;
    LX = round_up(static_cast<long long>(T) + lo + hi + 3, 4);
    stage = static_cast<long long>(nd) * L * esize + LX * 4 + (step ? 4LL * T : 0LL);
    nd4 = static_cast<int>(round_up(nd, 4));
    bytes = kProductStages * stage + 8LL * nd4 + (step ? 8LL * kProductWarps : 0LL);
  }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v summed over the warp's lanes in a fixed tree; lane 0 holds the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// A tile's warp sums, in warp order.
__device__ __forceinline__ float warps_total(const float* w) {
  float t = w[0];
#pragma unroll
  for (int i = 1; i < kProductWarps; ++i) t += w[i];
  return t;
}

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
// lim_hi): the stripe allocation's elements relative to rows. A half-step
// also stages y's rows of the tile.
template <typename S, bool Uniform, bool Step = false>
__device__ __forceinline__ void product_stage(unsigned char* buf, const ProductLayout& lay,
                                              const S* __restrict__ rows, long long stride,
                                              long long lim_lo, long long lim_hi, int ph,
                                              const int* kk, const int* pq,
                                              const float* __restrict__ vec, int nd,
                                              long long dim_out, long long dim_in, int lo,
                                              int hi, int T, long long c0, int column,
                                              const float* __restrict__ y = nullptr) {
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
  if constexpr (Step) {
    float* const ys = xs + lay.LX;
    for (int q = threadIdx.x * 4; q < len; q += blockDim.x * 4) cp_async16(ys + q, y + c0 + q);
  }
}

// A vector element as the sum takes it: times c1 in a half-step.
template <bool Step>
__device__ __forceinline__ float scaled(float x, float c1) {
  if constexpr (Step) {
    return x * c1;
  } else {
    return x;
  }
}

// Sum the staged tile [c0, c0 + T) into out: R outputs a thread,
// kProductThreads apart, from +0 (a half-step: from (-c2) y), the diagonals
// in offset order. Returns the sum of this thread's outputs squared in a
// half-step (in the order it stores them), else 0.
template <typename S, int R, bool Uniform, typename O = float, bool Step = false>
__device__ __forceinline__ float product_sum(const unsigned char* buf, const ProductLayout& lay,
                                             int ph, const int* kk, const int* pq, int nd,
                                             O* __restrict__ out, long long dim_out,
                                             long long dim_in, int lo, int hi, int T,
                                             long long c0, int column, float c1 = 0.0f,
                                             float c2 = 0.0f) {
  constexpr int V = 16 / sizeof(S);
  constexpr int kS = kProductThreads;
  constexpr int B = kProductBatch;
  const S* const st = reinterpret_cast<const S*>(buf);
  const float* const xs = reinterpret_cast<const float*>(buf + nd * lay.L * sizeof(S));
  const float* const ys = xs + lay.LX;  // a half-step's y
  const long long xa = c0 - lo > 0 ? c0 - lo : 0;
  const int cb = tile_phase<V, Uniform>(ph, c0);
  const int nb = nd / B * B;  // diagonals taken in whole batches
  float ssq = 0.0f;
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
      if constexpr (Step) {
        if (ok[q]) acc[q] = (-c2) * ys[t0 + q * kS];
      }
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
          for (int b = 0; b < B; ++b) acc[q] += sv[q][b] * scaled<Step>(xv[q][b], c1);
        }
      }
      for (int d = nb; d < nd; ++d) {
        const int k = kk[d];
        const S* sd = st + d * lay.L + t0 +
                      piece_shift<V, Uniform>(cb, k, Uniform ? 0 : pq[d], column);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          acc[q] += lds(sd + q * kS) * scaled<Step>(xb[q * kS + k], c1);
        }
      }
    } else {
      for (int d = 0; d < nd; ++d) {
        const int k = kk[d];
        const S* sd = st + d * lay.L + t0 +
                      piece_shift<V, Uniform>(cb, k, Uniform ? 0 : pq[d], column);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const long long src = i0 + q * kS + k;
          if (ok[q] && src >= 0 && src < dim_in) {
            acc[q] += lds(sd + q * kS) * scaled<Step>(xb[q * kS + k], c1);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (ok[q]) {
        put(out + i0 + q * kS, acc[q]);
        if constexpr (Step) ssq += acc[q] * acc[q];
      }
    }
  }
  return ssq;
}

// lo, hi: the halos of the direction taken. Each iteration waits for its
// tile's copies, synchronises (so every thread has also left the tile
// before, whose stage the next copies reuse), stages the tile
// kProductStages - 1 ahead and sums its own: one barrier a tile. A
// half-step's thread 0 writes the tile before's slot after that barrier.
template <typename S, int R, bool Uniform, typename O = float, int Step = kPlain>
__global__ void __launch_bounds__(kProductThreads) dia_product_staged_kernel(
    const S* __restrict__ rows, long long stride, long long lim_lo, long long lim_hi,
    const float* __restrict__ vec, O* __restrict__ out, const int* __restrict__ offsets,
    int nd, long long dim_out, long long dim_in, int lo, int hi, int T, long long tiles,
    int column, StepArgs step) {
  constexpr int V = 16 / sizeof(S);
  constexpr bool kStep = Step != kPlain;
  extern __shared__ __align__(16) unsigned char smem[];
  const ProductLayout lay(nd, lo, hi, T, sizeof(S), kStep);
  int* const kk = reinterpret_cast<int*>(smem + kProductStages * lay.stage);
  int* const pq = kk + lay.nd4;
  float* const red = reinterpret_cast<float*>(pq + lay.nd4);  // a half-step's warp sums
  float c1 = 0.0f, c2 = 0.0f;
  if constexpr (kStep) {
    c1 = __ldg(step.c1);
    c2 = __ldg(step.c2);
  }
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
      product_stage<S, Uniform, kStep>(smem + s * lay.stage, lay, rows, stride, lim_lo, lim_hi,
                                       ph, kk, pq, vec, nd, dim_out, dim_in, lo, hi, T, tile * T,
                                       column, step.y);
    }
    cp_async_commit();
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    cp_async_wait_group<kProductStages - 2>();  // this tile's copies
    __syncthreads();
    if constexpr (kStep) {  // the tile before's warp sums are all in
      if (threadIdx.x == 0 && it > 0) {
        step.partial[tile - grid] = warps_total(red + (it - 1) % 2 * kProductWarps);
      }
    }
    const long long ahead = tile + (kProductStages - 1) * grid;
    if (ahead < tiles) {
      product_stage<S, Uniform, kStep>(
          smem + (it + kProductStages - 1) % kProductStages * lay.stage, lay, rows, stride,
          lim_lo, lim_hi, ph, kk, pq, vec, nd, dim_out, dim_in, lo, hi, T, ahead * T, column,
          step.y);
    }
    cp_async_commit();
    const float ssq = product_sum<S, R, Uniform, O, kStep>(
        smem + it % kProductStages * lay.stage, lay, ph, kk, pq, nd, out, dim_out, dim_in, lo,
        hi, T, tile * T, column, c1, c2);
    if constexpr (kStep) {
      const float w = warp_sum(ssq);
      if ((threadIdx.x & 31) == 0) red[it % 2 * kProductWarps + threadIdx.x / 32] = w;
    }
  }
  cp_async_wait_group<0>();  // the empty groups of the last steps
  if constexpr (kStep) {
    __syncthreads();  // the last tile's warp sums
    if (threadIdx.x == 0 && it > 0) {
      step.partial[blockIdx.x + (it - 1) * grid] = warps_total(red + (it - 1) % 2 * kProductWarps);
    }
  }
  if constexpr (Step == kTicketed) {
    __shared__ bool last;
    if (threadIdx.x == 0) {
      __threadfence();  // this block's slots are visible before the ticket counts them
      last = atomicAdd(step.ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    float acc = 0.0f;  // slots threadIdx.x + kProductThreads j, j = 0, 1, ... in order
    for (long long b0 = threadIdx.x; b0 < tiles; b0 += kSlotBatch * kProductThreads) {
      float p[kSlotBatch];
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {  // from L2: other blocks wrote the slots
        const long long b = b0 + static_cast<long long>(j) * kProductThreads;
        p[j] = b < tiles ? __ldcg(step.partial + b) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) acc += p[j];
    }
    const float w = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = w;
    __syncthreads();
    if (threadIdx.x == 0) {
      *step.ssq = warps_total(red);
      *step.ticket = 0u;  // ready for the next launch
    }
  }
}

template <typename S, int R, bool Uniform, typename O, int Step>
int launch_product_tiles(const S* rows, long long stride, long long lim_lo, long long lim_hi,
                         const float* vec, O* out, const int* offsets, int nd,
                         long long dim_out, long long dim_in, int lo, int hi, int T, int column,
                         StepArgs step, cudaStream_t stream) {
  const ProductLayout lay(nd, lo, hi, T, sizeof(S), Step != kPlain);
  auto kernel = dia_product_staged_kernel<S, R, Uniform, O, Step>;
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
                     hi, T, tiles, column, step);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, bool Uniform, typename O = float, int Step = kPlain>
int launch_product_rows(const S* rows, long long stride, long long lim_lo, long long lim_hi,
                        const float* vec, O* out, const int* offsets, int nd,
                        long long dim_out, long long dim_in, int lo, int hi, int T, int column,
                        cudaStream_t stream, StepArgs step = StepArgs{}) {
  if (T >= 4 * kProductThreads) {
    return launch_product_tiles<S, 4, Uniform, O, Step>(rows, stride, lim_lo, lim_hi, vec, out,
                                                        offsets, nd, dim_out, dim_in, lo, hi, T,
                                                        column, step, stream);
  }
  if (T >= 2 * kProductThreads) {
    return launch_product_tiles<S, 2, Uniform, O, Step>(rows, stride, lim_lo, lim_hi, vec, out,
                                                        offsets, nd, dim_out, dim_in, lo, hi, T,
                                                        column, step, stream);
  }
  return launch_product_tiles<S, 1, Uniform, O, Step>(rows, stride, lim_lo, lim_hi, vec, out,
                                                      offsets, nd, dim_out, dim_in, lo, hi, T,
                                                      column, step, stream);
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

// The staged half-step (Step kPartials or kTicketed) in tiles of T on packed
// rows (nd, dim_out), 16-byte aligned, forward: out (O) = A (vec c1) - c2 y
// and a sum of squares a tile into step.partial, which holds `slots` =
// ceil(dim_out / T) floats (kTicketed: step.ssq their sum); lo, hi of the
// offsets given; vec and y 16-byte aligned.
template <typename S, typename O, int Step>
int launch_halfstep_staged(const void* data, const void* vec, void* out, const void* offsets,
                           int nd, long long dim_out, long long dim_in, int lo, int hi, int T,
                           long long slots, StepArgs step, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(S);
  if (T < 16 || T % 16 || lo < 0 || hi < 0 || !aligned16(data) || !aligned16(vec) ||
      !aligned16(step.y) || slots != (dim_out + T - 1) / T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim_out == 0) return 0;
  const auto* rows = static_cast<const S*>(data);
  const auto* vp = static_cast<const float*>(vec);
  auto* op = static_cast<O*>(out);
  const auto* off = static_cast<const int*>(offsets);
  const long long count = nd * dim_out;
  if (dim_out % V == 0) {  // every row at row 0's 16-byte phase
    return launch_product_rows<S, true, O, Step>(rows, dim_out, 0, count, vp, op, off, nd, dim_out,
                                                 dim_in, lo, hi, T, 0, stream, step);
  }
  return launch_product_rows<S, false, O, Step>(rows, dim_out, 0, count, vp, op, off, nd, dim_out,
                                                dim_in, lo, hi, T, 0, stream, step);
}

}  // namespace
