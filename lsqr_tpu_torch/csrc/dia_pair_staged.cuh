// The staged DIA pair for Hopper (sm_90a), shared by both stripe layouts:
//     u = A (vec * c1) - c2 * y,     z = A' u
// in one pass over the stripes, f32 or bf16 (a storage format: vectors, c1,
// c2 and the sums are f32). csrc/dia_packed.cu (dia_pair) and
// csrc/dia_shared.cu (dia_pair_shared) include it.
//
// A layout is a row stride and a row base: diagonal d's element of row r
// (A[r, r + k_d]) sits at stripes[d * stride + base + r]:
//     packed (ops/structured.py: DIAOperator)    stride m,  base 0
//     shared (ops/spmv.py: dia_shared_geometry)  stride Lp, base H
// The kernel takes rows = stripes + base and the stride, and reads each
// row's place in 16 bytes from the address itself: a base added in the
// kernel's address arithmetic cost 4-5% of its time on the H100 (PERF.md).
// Both layouts hold zero where r + k_d lies outside [0, n). Only
// rows in [0, m) are read, so the shared layout's padding is never needed.
// Diagonals are summed in offset order per output element, -c2 * y first
// in u: the order of the one-thread-per-element kernels, so the results are
// the same bits.
//
// What bounds it on the H100: bytes (~2 flops per stripe element read, far
// below the card's ~20 flop/byte ridge): the stripes once, plus x, y, u, z.
//
// What the design does about it. It does not copy the TPU's carry scheme
// (z block t-1 written at grid step t needs grid steps in order; CUDA blocks
// run in none). It recomputes a one-sided halo: with lo = max(0, -k_min)
// and hi = max(0, k_max), the tile of indices [c0, c0 + T) computes u for
// rows [c0 - hi, c0 + T + lo), writes its own rows of u, and forms z for
// columns [c0, c0 + T) from that u. No atomics: deterministic. The stripe
// rows of a tile, its x window and its y rows are staged in shared memory
// with 16-byte cp.async copies, each range rounded out to 16 bytes (the
// edges masked by index), so both halves read the stripes from shared memory
// and each stripe byte leaves device memory once (plus the halo's
// (lo + hi)/T share). A persistent grid of as many blocks as fit the SMs
// walks the tiles, two stages deep: the next tile's copies are in flight
// while this one computes. Each thread sums four rows (columns) 256 apart
// side by side, so it reads each diagonal's offset once for four sums and
// neighbouring lanes read neighbouring shared words; u and z leave through
// shared memory, 16 bytes a thread. T = 1024 k - (lo + hi rounded up to 4)
// for the least k in 1, 2, 4, 8 whose two stages fit two blocks an SM (else
// one), with T >= lo + hi (pair_tile); where none fits, or a halo exceeds
// kPairMaxHalo, the wrappers take another route (ops/spmv.py).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPairThreads = 256;   // the staged pair's block
constexpr int kPairMaxHalo = 1024;  // largest lo or hi (H: shared) a pair takes

// A stripe element in shared memory, in f32.
__device__ __forceinline__ float lds(const float* p) { return *p; }
__device__ __forceinline__ float lds(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline long long round_up(long long v, long long q) {
  return (v + q - 1) / q * q;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The staged pair's shared memory for a tile of T: per stage the nd stripe
// rows (L elements each, L = span + 16 bytes' worth - 1 rounded up to 16
// bytes), the x window (span + lo + hi floats) and the y rows (span), each
// with up to 3 (bf16: 7) elements in front from the 16-byte rounding; two
// stages; then u for the span (U floats, placed so that the tile's own rows
// start on the 16-byte grid), z for the tile (T floats) and three ints a
// diagonal. span = T + lo + hi.
struct PairLayout {
  long long L, LX, LY, U, stage, bytes;
  __host__ __device__ PairLayout(int nd, int lo, int hi, int T, int esize) {
    const long long span = static_cast<long long>(T) + lo + hi;
    const long long v = 16 / esize;
    L = round_up(span + v - 1, v);
    LX = round_up(span + lo + hi + 3, 4);
    LY = round_up(span + 3, 4);
    U = round_up(span + 3, 4);
    stage = nd * L * esize + (LX + LY) * 4;
    bytes = 2 * stage + (U + T) * 4 + 3LL * nd * 4;
  }
};

// One tile's staging, into stage `buf`: the stripe rows [ra, rb) of every
// diagonal, x[xa, xb) and y[ra, rb), each copy starting at the 16-byte
// boundary at or before its first element (an element's place is its
// offset from that boundary); then one commit, also when nothing is copied.
// dmod[d] places element 0 of diagonal d's row in 16 bytes.
template <typename S>
__device__ __forceinline__ void stage_tile(unsigned char* buf, const PairLayout& lay,
                                           const S* __restrict__ rows, long long stride,
                                           const float* __restrict__ vec,
                                           const float* __restrict__ y, const int* dmod,
                                           int nd, long long m, long long n, int lo, int hi,
                                           int T, long long tile) {
  constexpr int V = 16 / sizeof(S);
  const long long c0 = tile * T;
  const long long ra = c0 - hi > 0 ? c0 - hi : 0;
  const long long rb = c0 + T + lo < m ? c0 + T + lo : m;
  if (ra < rb) {
    S* st = reinterpret_cast<S*>(buf);
    const int len = static_cast<int>(rb - ra);
    const int rmod = static_cast<int>(ra & (V - 1));
    for (int d = 0; d < nd; ++d) {
      const int sh = (dmod[d] + rmod) & (V - 1);
      const S* src = rows + d * stride + ra - sh;
      S* dst = st + d * lay.L;
      for (int q = threadIdx.x * V; q < sh + len; q += blockDim.x * V) {
        cp_async16(dst + q, src + q);
      }
    }
    float* ys = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S)) + lay.LX;
    const int shy = static_cast<int>(ra & 3);
    for (int q = threadIdx.x * 4; q < shy + len; q += blockDim.x * 4) {
      cp_async16(ys + q, y + ra - shy + q);
    }
    const long long xa = ra - lo > 0 ? ra - lo : 0;
    const long long xb = rb + hi < n ? rb + hi : n;
    if (xa < xb) {
      float* xs = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S));
      const int shx = static_cast<int>(xa & 3);
      for (int q = threadIdx.x * 4; q < shx + (xb - xa); q += blockDim.x * 4) {
        cp_async16(xs + q, vec + xa - shx + q);
      }
    }
  }
  cp_async_commit();
}

// The tiles [c0, c0 + T) of BOTH u (rows) and z (columns), c0 = tile * T,
// tile = blockIdx.x, + gridDim.x, ... over ceil(max(m, n) / T). Each pass
// over a tile's rows (columns) takes kGroup of them, four a thread
// kPairThreads apart (so neighbouring lanes read neighbouring shared words),
// each thread's four sums side by side over the diagonals.
template <typename S>
__global__ void __launch_bounds__(kPairThreads) dia_pair_kernel(
    const S* __restrict__ rows, long long stride, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ u, float* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n, int lo, int hi,
    int T, long long tiles) {
  constexpr int V = 16 / sizeof(S);
  constexpr int kStride = kPairThreads;
  constexpr int kGroup = 4 * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const PairLayout lay(nd, lo, hi, T, sizeof(S));
  const int span = T + lo + hi;
  float* const u_base = reinterpret_cast<float*>(smem + 2 * lay.stage);
  float* const u_s = u_base + ((4 - hi % 4) % 4);  // u_s + hi on the 16-byte grid
  float* const z_s = u_base + lay.U;
  int* const ks = reinterpret_cast<int*>(z_s + T);
  int* const dmod = ks + nd;    // where element 0 of diagonal d's row sits in 16 bytes
  int* const soff = dmod + nd;  // this tile's: where row ra of diagonal d sits
  const unsigned long long row0 = reinterpret_cast<uintptr_t>(rows) / sizeof(S);
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    ks[d] = __ldg(offsets + d);
    dmod[d] = static_cast<int>((row0 + d * stride) % V);
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int tid = threadIdx.x;
  __syncthreads();
  long long tile = blockIdx.x;
  int cur = 0;
  if (tile < tiles) {
    stage_tile(smem, lay, rows, stride, vec, y, dmod, nd, m, n, lo, hi, T, tile);
  }
  for (; tile < tiles; tile += gridDim.x, cur ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      stage_tile(smem + (cur ^ 1) * lay.stage, lay, rows, stride, vec, y, dmod, nd, m, n, lo,
                 hi, T, next);
    } else {
      cp_async_commit();
    }
    const long long c0 = tile * T;
    const long long ra = c0 - hi > 0 ? c0 - hi : 0;
    const long long xa = ra - lo > 0 ? ra - lo : 0;
    const int rmod = static_cast<int>(ra & (V - 1));
    for (int d = tid; d < nd; d += blockDim.x) {
      soff[d] = static_cast<int>(d * lay.L) + ((dmod[d] + rmod) & (V - 1));
    }
    cp_async_wait_one();  // this tile's copies (all groups but the newest)
    __syncthreads();
    const unsigned char* buf = smem + cur * lay.stage;
    const S* st = reinterpret_cast<const S*>(buf);
    const float* xs = reinterpret_cast<const float*>(buf + nd * lay.L * sizeof(S));
    const float* ys = xs + lay.LX;
    const int shx = static_cast<int>(xa & 3);
    const int shy = static_cast<int>(ra & 3);
    // 1. u for the tile's rows and its halo, -c2 y first, then the
    // diagonals in offset order, from the staged stripes, x and y; rows
    // whose whole band lies inside [0, n) skip the mask
    for (int g = 0; g < span; g += kGroup) {
      const long long r0 = c0 - hi + g + tid;  // this thread's rows r0 + kStride q
      const int i0 = static_cast<int>(r0 - ra);
      const int x0 = shx + static_cast<int>(r0 - xa);
      float acc[4];
      bool ok[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long r = r0 + q * kStride;
        ok[q] = g + q * kStride + tid < span && r >= 0 && r < m;
        acc[q] = ok[q] ? (-c2) * ys[shy + i0 + q * kStride] : 0.0f;
      }
      const long long r3 = r0 + 3 * kStride;
      if (ok[0] && ok[3] && r0 >= lo && r3 + hi < n) {
        for (int d = 0; d < nd; ++d) {
          const S* sd = st + soff[d] + i0;
          const float* xd = xs + x0 + ks[d];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += lds(sd + q * kStride) * (xd[q * kStride] * c1);
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int k = ks[d];
          const S* sd = st + soff[d] + i0;
          const float* xd = xs + x0 + k;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long c = r0 + q * kStride + k;
            if (ok[q] && c >= 0 && c < n) acc[q] += lds(sd + q * kStride) * (xd[q * kStride] * c1);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (g + q * kStride + tid < span) u_s[g + q * kStride + tid] = acc[q];
      }
    }
    __syncthreads();
    // 2. z[j] = sum_d A[j - k, j] * u[j - k] for the tile's columns (row
    // j - k sits at j - k - ra of the stage and j - c0 + hi - k of u_s);
    // columns whose rows all lie in [0, m) skip the mask
    for (int g = 0; g < T; g += kGroup) {
      const int t0 = g + tid;  // this thread's columns c0 + t0 + kStride q
      const long long j0 = c0 + t0;
      const int i0 = static_cast<int>(j0 - ra);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      bool ok[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ok[q] = t0 + q * kStride < T && j0 + q * kStride < n;
      const long long j3 = j0 + 3 * kStride;
      if (ok[3] && j0 >= hi && j3 + lo < m) {
        for (int d = 0; d < nd; ++d) {
          const int k = ks[d];
          const S* sd = st + soff[d] + i0 - k;
          const float* ud = u_s + t0 + hi - k;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += lds(sd + q * kStride) * ud[q * kStride];
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int k = ks[d];
          const S* sd = st + soff[d] + i0 - k;
          const float* ud = u_s + t0 + hi - k;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long r = j0 + q * kStride - k;
            if (ok[q] && r >= 0 && r < m) acc[q] += lds(sd + q * kStride) * ud[q * kStride];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (t0 + q * kStride < T) z_s[t0 + q * kStride] = acc[q];
      }
    }
    __syncthreads();
    // 3. the tile's own rows of u and its z, 16 bytes a thread. The next
    // tile's copies go to the other stage, and its first write to u_s
    // comes after its own wait and barrier: no barrier needed here
    for (int t = 4 * tid; t < T; t += 4 * blockDim.x) {
      const long long j = c0 + t;
      if (j + 3 < m) {
        *reinterpret_cast<float4*>(u + j) = *reinterpret_cast<const float4*>(u_s + hi + t);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q < m) u[j + q] = u_s[hi + t + q];
        }
      }
      if (j + 3 < n) {
        *reinterpret_cast<float4*>(z + j) = *reinterpret_cast<const float4*>(z_s + t);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q < n) z[j + q] = z_s[t + q];
        }
      }
    }
  }
}

// The staged pair's tile for nd diagonals, halos lo and hi and stripes of
// esize bytes on this card (either layout: the staged bytes are the same):
// T = 1024 k - (lo + hi rounded up to 4), so a tile's rows and halo make at
// most k passes of 1024, for the least k of 1, 2, 4 and 8 with T >= 256 and
// T >= lo + hi whose layout fits two blocks an SM, else one; 0 when none
// fits; -1 when the card's limits cannot be read.
inline int pair_tile(int nd, int lo, int hi, int esize) {
  int dev = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess) {
    return -1;
  }
  if (nd < 1 || lo < 0 || hi < 0 || lo > kPairMaxHalo || hi > kPairMaxHalo) return 0;
  const int halo = (lo + hi + 3) / 4 * 4;
  const long long budgets[2] = {per_sm / 2 - 1024, optin};  // the card keeps 1 KB a block
  for (long long budget : budgets) {
    for (int k = 1; k <= 8; k *= 2) {
      const int T = 4 * kPairThreads * k - halo;
      if (T >= 256 && T >= lo + hi && PairLayout(nd, lo, hi, T, esize).bytes <= budget) {
        return T;
      }
    }
  }
  return 0;
}

// Launch the staged pair on stripes of layout (stride, base) with tile T
// (from pair_tile); every pointer 16-byte aligned (the stripes' row 0 of
// diagonal 0, stripes + base, need not be).
template <typename S>
int launch_pair_staged(const void* stripes, long long stride, long long base,
                       const void* vec, const void* y, const void* c1, const void* c2,
                       void* u, void* z, const void* offsets, int nd, long long m,
                       long long n, int lo, int hi, int T, void* stream) {
  const PairLayout lay(nd, lo, hi, T, sizeof(S));
  if (lo < 0 || hi < 0 || lo > kPairMaxHalo || hi > kPairMaxHalo || T < 256 || T % 4 ||
      T < lo + hi || T + lo + hi > 8 * 4 * kPairThreads || stride < 0 || base < 0 ||
      !aligned16(stripes) || !aligned16(vec) || !aligned16(y) || !aligned16(u) ||
      !aligned16(z)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long dim = m > n ? m : n;
  if (dim == 0) return 0;
  auto kernel = dia_pair_kernel<S>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kPairThreads, lay.bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (dim + T - 1) / T;
  const long long grid = static_cast<long long>(per_sm) * sms < tiles
                             ? static_cast<long long>(per_sm) * sms : tiles;
  kernel<<<static_cast<unsigned>(grid), kPairThreads, lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(stripes) + base, stride, static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(u), static_cast<float*>(z),
      static_cast<const int*>(offsets), nd, m, n, lo, hi, T, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
