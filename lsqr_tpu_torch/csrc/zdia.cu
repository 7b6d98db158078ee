// The complex DIA pair for Hopper (sm_90a): both products of one complex
// bidiagonalization step on the JAX package's plane-split ZDIAOperator.
//
// Layout (ops/zdia.py: ZDIAOperator). Two real row-aligned stripe planes,
// no padding, one row of length m per diagonal:
//     A[i, i + k_d] = dr[d * m + i] + i * di[d * m + i],   0 <= i < m,
// zero where i + k_d lies outside [0, n). The complex vectors y (m,),
// win (n,), u (m,) and z (n,) are complex64, read and written as
// interleaved float2 (PyTorch's complex64 layout); c1 and c2 are real f32
// device scalars read through pointers. The kernel computes
//     u[i] = -c2 y[i] + sum_d A[i, i + k_d] (c1 win[i + k_d])
//     z[j] = sum_d conj(A[j - k_d, j]) u[j - k_d]
// with the diagonals in offset order, as (re, im) f32 pairs:
//     (a + ib)(x + iy) = (ax - by) + i(ay + bx)
//     (a - ib)(x + iy) = (ax + by) + i(ay - bx)
// The conjugation of the adjoint is a sign in that combination; no
// conjugated copy of A exists.
//
// Kernel and the TPU kernel it replaces (lsqr_tpu/ops/pallas_spmv.py):
//
// zdia_pair_kernel, zdia_forward_kernel, zdia_adjoint_kernel
//     <- zdia_pair / _zdia_pair_head, _zdia_pair_kernel_carry,
//        _zdia_pair_kernel
//
// What bounds it on the H100: bytes. 8 flops per stripe element pair read
// (8 bytes) against the card's ~20 flop/byte ridge: the floor is the two
// planes (nd * m * 8 bytes) plus y, win, u and z (8 bytes a complex
// element each). At m = n = 2^21 with 5 diagonals: 84 MB of planes and
// 67 MB of vectors, 0.045 ms at 3.35 TB/s.
//
// What the design does about it:
// * the TPU kernel's carry scratch and per-tile overlap-add exist because
//   its grid runs in order on one core; CUDA blocks run in none, so the
//   pair recomputes a one-sided halo, as the port's real pairs do
//   (csrc/dia_pair_staged.cuh): the tile of indices [c0, c0 + T) of u and
//   z forms u for rows [c0 - hi, c0 + T + lo) and z for its columns from
//   that u. Each u and z element is summed by one thread over the
//   diagonals in a fixed order: no atomics, the same bits from run to run;
// * it streams (zdia_pair_kernel): a persistent grid keeps two tiles in
//   shared memory, the next one's 16-byte cp.async copies (both planes'
//   rows, the win window, y) in flight while this one is summed, and both
//   halves read the stripes from shared memory (one block a tile with
//   scalar loads, the second half re-reading the stripe rows through L1/L2,
//   took 0.097 ms at 2^21 x 5 on the H100; this kernel 0.061: PERF.md);
// * halos above kMaxHalo, or bands no tile's stages fit (more than 25
//   diagonals at narrow halos), take two launches, chosen by the wrapper:
//   u alone (zdia_forward_kernel), then z from u in device memory
//   (zdia_adjoint_kernel), with the same expressions and order: the same
//   bits.

#include <cuda_runtime.h>

#include "dia_pair_staged.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalo = 1024;  // largest lo or hi of the one-pass pair

// (ur, ui) += A[r, r + k] (c1 w) for the stripe element a + ib and w = win[r + k]
__device__ __forceinline__ void add_row(float& ur, float& ui, float a, float b, float2 w,
                                        float c1) {
  const float xr = w.x * c1;
  const float xi = w.y * c1;
  ur = ur + a * xr - b * xi;
  ui = ui + a * xi + b * xr;
}

// acc += conj(A[r, r + k]) u for the stripe element a + ib and u = u[r]
__device__ __forceinline__ void add_conj(float2& acc, float a, float b, float2 u) {
  acc.x += a * u.x + b * u.y;
  acc.y += a * u.y - b * u.x;
}

// u[r] = -c2 y[r] + sum_d A[r, r + k_d] (c1 win[r + k_d]), 0 <= r < m
__device__ __forceinline__ float2 zdia_row(
    const float* __restrict__ dr, const float* __restrict__ di,
    const float2* __restrict__ win, const float2* __restrict__ y, float c1,
    float c2, const int* __restrict__ offsets, int nd, long long r,
    long long m, long long n) {
  const float2 yr = __ldg(y + r);
  float ur = (-c2) * yr.x;
  float ui = (-c2) * yr.y;
  for (int d = 0; d < nd; ++d) {
    const long long c = r + __ldg(offsets + d);
    if (c >= 0 && c < n) {
      add_row(ur, ui, __ldg(dr + d * m + r), __ldg(di + d * m + r), __ldg(win + c), c1);
    }
  }
  return make_float2(ur, ui);
}

// The one-pass pair: a persistent grid; block b walks the tiles b, b +
// grid, ... of T indices of BOTH u (rows) and z (columns), with kZStages
// tiles in shared memory, each staged by 16-byte cp.async copies while the
// ones before it are summed: both planes' rows [ra, rb) = [c0 - hi, c0 + T
// + lo) of every diagonal (clipped to [0, m); row d starts at 16-byte phase
// d m mod 4, so any m), win[ra - lo, rb + hi) and y[ra, rb). A tile
// forms u for its rows and halo into shared memory (its own rows also to
// u), then z for its columns from that u: the stripes are read from shared
// memory by both halves, and each stripe byte leaves device memory once
// plus the halo's (lo + hi) / T share. Each thread issues kZBatch
// diagonals' loads before it adds them, in offset order with zdia_row's
// and add_conj's expressions: the bits of the two-launch route. T comes
// from ops/spmv.py: zpair_tile (ZPairLayout's bytes, mirrored there as
// zpair_stage_bytes: change both together).
constexpr int kZStages = 2;       // tiles in shared memory, the one summed included
constexpr int kZBatch = 4;        // diagonals whose loads a thread issues together
static_assert(kZStages >= 2 && kZBatch % 4 == 0, "zpair shape");

// A stage: 2 nd plane rows of L floats (the span T + lo + hi and up to 3 in
// front, rounded up to 4; the real plane's rows, then the imaginary
// one's), win (span + lo + hi float2 and up to 1 in front, rounded up to 2)
// and y (span and up to 1, rounded up to 2); kZStages of them, then u for
// the span (U float2) and two ints a diagonal (its offset and its rows'
// 16-byte phase; nd rounded up to 4 each).
struct ZPairLayout {
  long long L, LX, LY, U, stage, bytes;
  __host__ __device__ ZPairLayout(int nd, int lo, int hi, int T) {
    const long long span = static_cast<long long>(T) + lo + hi;
    L = round_up(span + 3, 4);
    LX = round_up(span + lo + hi + 1, 2);
    LY = round_up(span + 1, 2);
    U = round_up(span, 2);
    stage = 2LL * nd * L * 4 + (LX + LY) * 8;
    bytes = kZStages * stage + U * 8 + 8 * round_up(nd, 4);
  }
};

// Stage tile [c0, c0 + T) into `buf` (no commit); dm[d]: the 16-byte
// phase of row 0 of diagonal d, d m mod 4 (both planes: they start on the
// 16-byte grid).
__device__ __forceinline__ void zpair_stage(unsigned char* buf, const ZPairLayout& lay,
                                            const float* __restrict__ dr,
                                            const float* __restrict__ di, const int* dm,
                                            const float2* __restrict__ win,
                                            const float2* __restrict__ y, int nd,
                                            long long m, long long n, int lo, int hi, int T,
                                            long long c0) {
  const long long ra = c0 - hi > 0 ? c0 - hi : 0;
  const long long rb = c0 + T + lo < m ? c0 + T + lo : m;
  if (ra >= rb) return;
  const int len = static_cast<int>(rb - ra);
  const int P = static_cast<int>(lay.L / 4);  // 16-byte pieces a row holds
  float* const st = reinterpret_cast<float*>(buf);
  for (int e = threadIdx.x; e < 2 * nd * P; e += blockDim.x) {
    const int row = e / P, q = (e - row * P) * 4;
    const int d = row < nd ? row : row - nd;
    const int sh = (dm[d] + static_cast<int>(ra & 3)) & 3;
    if (q < sh + len) {
      cp_async16(st + row * lay.L + q, (row < nd ? dr : di) + d * m + ra - sh + q);
    }
  }
  float2* const xs = reinterpret_cast<float2*>(buf + 2LL * nd * lay.L * 4);
  const long long xa = ra - lo > 0 ? ra - lo : 0;
  const long long xb = rb + hi < n ? rb + hi : n;
  if (xa < xb) {
    const int shx = static_cast<int>(xa & 1);
    for (int q = threadIdx.x * 2; q < shx + (xb - xa); q += blockDim.x * 2) {
      cp_async16(xs + q, win + xa - shx + q);
    }
  }
  float2* const ys = xs + lay.LX;
  const int shy = static_cast<int>(ra & 1);
  for (int q = threadIdx.x * 2; q < shy + len; q += blockDim.x * 2) {
    cp_async16(ys + q, y + ra - shy + q);
  }
}

// Sum the staged tile [c0, c0 + T): u for its rows and halo into u_s (its
// own rows also to u), then z for its columns. ks[d], dm[d]: the offsets
// and the rows' 16-byte phases (int4-aligned, nd rounded up to 4).
__device__ __forceinline__ void zpair_sum(const unsigned char* buf, const ZPairLayout& lay,
                                          float2* u_s, const int* ks, const int* dm, float c1,
                                          float c2, float2* __restrict__ u,
                                          float2* __restrict__ z, int nd, long long m,
                                          long long n, int lo, int hi, int T, long long c0) {
  constexpr int B = kZBatch;
  const int span = T + lo + hi;
  const int nb = nd / B * B;  // diagonals taken in whole batches
  const long long L = lay.L, Li = nd * lay.L;  // a row; the imaginary plane's first
  const float* const st = reinterpret_cast<const float*>(buf);
  const float2* const xs = reinterpret_cast<const float2*>(buf + 2LL * nd * lay.L * 4);
  const float2* const ys = xs + lay.LX;
  const long long ra = c0 - hi > 0 ? c0 - hi : 0;
  const long long xa = ra - lo > 0 ? ra - lo : 0;
  const int rm = static_cast<int>(ra & 3);
  // 1. u for rows [c0 - hi, c0 + T + lo): -c2 y, then the diagonals in
  // offset order (zero outside [0, m)); rows whose band lies inside [0, n)
  // skip the mask. Row r of diagonal d sits at d L + ((dm[d] + ra) & 3) +
  // r - ra of the real rows, + Li for the imaginary ones
  for (int t = threadIdx.x; t < span; t += kThreads) {
    const long long r = c0 - hi + t;
    float2 acc = make_float2(0.0f, 0.0f);
    if (r >= 0 && r < m) {
      const int i = static_cast<int>(r - ra);
      const float2 yv = ys[static_cast<int>(ra & 1) + i];
      float ur = (-c2) * yv.x;
      float ui = (-c2) * yv.y;
      const float2* const xr = xs + (xa & 1) + (r - xa);  // win[r + k] at xr[k]
      if (r >= lo && r + hi < n) {
        for (int d = 0; d < nb; d += B) {
          int kq[B], pq[B];
#pragma unroll
          for (int b = 0; b < B; b += 4) {
            const int4 k4 = *reinterpret_cast<const int4*>(ks + d + b);
            const int4 m4 = *reinterpret_cast<const int4*>(dm + d + b);
            kq[b] = k4.x, kq[b + 1] = k4.y, kq[b + 2] = k4.z, kq[b + 3] = k4.w;
            pq[b] = m4.x, pq[b + 1] = m4.y, pq[b + 2] = m4.z, pq[b + 3] = m4.w;
          }
          float a[B], bi[B];
          float2 w[B];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const long long p = (d + b) * L + ((pq[b] + rm) & 3) + i;
            a[b] = st[p];
            bi[b] = st[p + Li];
            w[b] = xr[kq[b]];
          }
#pragma unroll
          for (int b = 0; b < B; ++b) add_row(ur, ui, a[b], bi[b], w[b], c1);
        }
        for (int d = nb; d < nd; ++d) {
          const long long p = d * L + ((dm[d] + rm) & 3) + i;
          add_row(ur, ui, st[p], st[p + Li], xr[ks[d]], c1);
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int k = ks[d];
          const long long c = r + k;
          if (c >= 0 && c < n) {
            const long long p = d * L + ((dm[d] + rm) & 3) + i;
            add_row(ur, ui, st[p], st[p + Li], xr[k], c1);
          }
        }
      }
      acc = make_float2(ur, ui);
      if (t >= hi && t < hi + T) u[r] = acc;
    }
    u_s[t] = acc;
  }
  __syncthreads();
  // 2. z[j] = sum_d conj(A[j - k, j]) u[j - k] for the tile's columns (row
  // j - k at u_s[t + hi - k]: inside [0, span) since -lo <= k <= hi);
  // columns whose rows all lie in [0, m) skip the mask
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const long long j = c0 + t;
    if (j >= n) break;
    const int i = static_cast<int>(j - ra);
    const float2* const ub = u_s + t + hi;  // u[j - k] at ub[-k]
    float2 acc = make_float2(0.0f, 0.0f);
    if (j >= hi && j + lo < m) {
      for (int d = 0; d < nb; d += B) {
        int kq[B], pq[B];
#pragma unroll
        for (int b = 0; b < B; b += 4) {
          const int4 k4 = *reinterpret_cast<const int4*>(ks + d + b);
          const int4 m4 = *reinterpret_cast<const int4*>(dm + d + b);
          kq[b] = k4.x, kq[b + 1] = k4.y, kq[b + 2] = k4.z, kq[b + 3] = k4.w;
          pq[b] = m4.x, pq[b + 1] = m4.y, pq[b + 2] = m4.z, pq[b + 3] = m4.w;
        }
        float a[B], bi[B];
        float2 uv[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const long long p = (d + b) * L + ((pq[b] + rm) & 3) + i - kq[b];
          a[b] = st[p];
          bi[b] = st[p + Li];
          uv[b] = ub[-kq[b]];
        }
#pragma unroll
        for (int b = 0; b < B; ++b) add_conj(acc, a[b], bi[b], uv[b]);
      }
      for (int d = nb; d < nd; ++d) {
        const int k = ks[d];
        const long long p = d * L + ((dm[d] + rm) & 3) + i - k;
        add_conj(acc, st[p], st[p + Li], ub[-k]);
      }
    } else {
      for (int d = 0; d < nd; ++d) {
        const int k = ks[d];
        const long long rr = j - k;
        if (rr >= 0 && rr < m) {
          const long long p = d * L + ((dm[d] + rm) & 3) + i - k;
          add_conj(acc, st[p], st[p + Li], ub[-k]);
        }
      }
    }
    z[j] = acc;
  }
}

// Each iteration waits for its tile's copies, synchronises (so every
// thread has also left the tile before: its stage and u_s), stages the
// tile kZStages - 1 ahead and sums its own.
__global__ void __launch_bounds__(kThreads) zdia_pair_kernel(
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
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    ks[d] = __ldg(offsets + d);
    dm[d] = static_cast<int>(static_cast<unsigned long long>(d) * m & 3);
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long grid = gridDim.x;
  __syncthreads();  // ks, dm
#pragma unroll
  for (int s = 0; s < kZStages - 1; ++s) {
    const long long tile = blockIdx.x + s * grid;
    if (tile < tiles) {
      zpair_stage(smem + s * lay.stage, lay, dr, di, dm, win, y, nd, m, n, lo, hi, T,
                  tile * T);
    }
    cp_async_commit();
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    cp_async_wait_group<kZStages - 2>();  // this tile's copies
    __syncthreads();
    const long long ahead = tile + (kZStages - 1) * grid;
    if (ahead < tiles) {
      zpair_stage(smem + (it + kZStages - 1) % kZStages * lay.stage, lay, dr, di, dm, win, y,
                  nd, m, n, lo, hi, T, ahead * T);
    }
    cp_async_commit();
    zpair_sum(smem + it % kZStages * lay.stage, lay, u_s, ks, dm, c1, c2, u, z, nd, m, n, lo,
              hi, T, tile * T);
  }
}

// The wide-halo route, first launch: u alone, one thread per row.
__global__ void __launch_bounds__(kThreads) zdia_forward_kernel(
    const float* __restrict__ dr, const float* __restrict__ di,
    const float2* __restrict__ win, const float2* __restrict__ y,
    const float* __restrict__ c1p, const float* __restrict__ c2p,
    float2* __restrict__ u, const int* __restrict__ offsets, int nd,
    long long m, long long n) {
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < m; r += stride) {
    u[r] = zdia_row(dr, di, win, y, c1, c2, offsets, nd, r, m, n);
  }
}

// The wide-halo route, second launch: z = A^H u, one thread per column,
// u from device memory.
__global__ void __launch_bounds__(kThreads) zdia_adjoint_kernel(
    const float* __restrict__ dr, const float* __restrict__ di,
    const float2* __restrict__ u, float2* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int d = 0; d < nd; ++d) {
      const long long r = j - __ldg(offsets + d);
      if (r >= 0 && r < m) {
        add_conj(acc, __ldg(dr + d * m + r), __ldg(di + d * m + r), __ldg(u + r));
      }
    }
    z[j] = acc;
  }
}

inline unsigned grid_for(long long count) {
  long long g = (count + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned>(g < cap ? g : cap);
}

// The one-pass pair in tiles of T (zpair_tile); every pointer 16-byte
// aligned.
int launch_pair(const float* dr, const float* di, const float2* win, const float2* y,
                const float* c1, const float* c2, float2* u, float2* z, const int* offsets,
                int nd, long long m, long long n, int lo, int hi, int T, cudaStream_t stream) {
  if (lo > kMaxHalo || hi > kMaxHalo || T < 4 || !aligned16(dr) || !aligned16(di) ||
      !aligned16(win) || !aligned16(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long dim = m > n ? m : n;
  if (dim == 0) return 0;
  const ZPairLayout lay(nd, lo, hi, T);
  int err = static_cast<int>(cudaFuncSetAttribute(
      zdia_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, zdia_pair_kernel, kThreads, lay.bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (dim + T - 1) / T;
  const long long slots = static_cast<long long>(per_sm) * sms;
  zdia_pair_kernel<<<static_cast<unsigned>(tiles < slots ? tiles : slots), kThreads, lay.bytes,
                     stream>>>(dr, di, win, y, c1, c2, u, z, offsets, nd, m, n, lo, hi, T,
                               tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode 0: the one-pass pair in tiles of T (lo, hi <= kMaxHalo); 1: u
// alone; 2: z from u (T unused).
int lsqr_zdia_pair_f32(const void* dr, const void* di, const void* win,
                       const void* y, const void* c1, const void* c2, void* u,
                       void* z, const void* offsets, int nd, long long m,
                       long long n, int lo, int hi, int mode, int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pr = static_cast<const float*>(dr);
  const auto* pi = static_cast<const float*>(di);
  const auto* off = static_cast<const int*>(offsets);
  if (m < 0 || n < 0 || lo < 0 || hi < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    return launch_pair(pr, pi, static_cast<const float2*>(win), static_cast<const float2*>(y),
                       static_cast<const float*>(c1), static_cast<const float*>(c2),
                       static_cast<float2*>(u), static_cast<float2*>(z), off, nd, m, n, lo,
                       hi, T, s);
  } else if (mode == 1) {
    if (m == 0) return 0;
    zdia_forward_kernel<<<grid_for(m), kThreads, 0, s>>>(
        pr, pi, static_cast<const float2*>(win), static_cast<const float2*>(y),
        static_cast<const float*>(c1), static_cast<const float*>(c2),
        static_cast<float2*>(u), off, nd, m, n);
  } else if (mode == 2) {
    if (n == 0) return 0;
    zdia_adjoint_kernel<<<grid_for(n), kThreads, 0, s>>>(
        pr, pi, static_cast<const float2*>(u), static_cast<float2*>(z), off, nd, m, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
