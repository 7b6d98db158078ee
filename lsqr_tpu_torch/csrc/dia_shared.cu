// Shared-stripe DIA kernels for Hopper (sm_90a): the three products that
// carry the banded LSQR main path.
//
// Layout (ops/spmv.py: dia_shared_geometry). One flat, zero-padded stripe
// array serves both directions:
//     dp[d * Lp + H + i] = A[i, i + k_d]      for 0 <= i < m,
// zero everywhere else in [0, nd * Lp), with H = max |k_d|. So
//     forward  y[i] = sum_d dp[d*Lp + H + i]       * x[i + k_d]
//     adjoint  x[j] = sum_d dp[d*Lp + H + j - k_d] * y[j - k_d]
// Every stripe index above lies inside its row of dp for any output index,
// so stripe reads need no mask; the vector reads are masked by index
// (0 <= i + k < n forward, 0 <= j - k < m adjoint) instead of padding the
// vector on every call. Diagonals are summed in offset order per output
// element. c1 and c2 are device scalars read through pointers: the solver
// computes them on the device and must not wait for them on the host.
//
// Stripe storage: f32, f64 (the product only) or bf16. bf16 stripes are a
// storage format, as in the JAX package: vectors, c1, c2, the accumulation
// and the results stay f32.
//
// Kernels and the TPU kernels they replace (lsqr_tpu/ops/pallas_spmv.py):
//
// 1. dia_product_staged_kernel   <- dia_product_shared / _dia_shared_kernel
//    (dia_product_shared_kernel
//    where no tile fits, and f64)
//    y = A x or x = A' y: the staged product of csrc/dia_product_staged.cuh
//    on this layout (row stride Lp, row base H; every row at one 16-byte
//    phase); f64 products on the card take the direct kernel.
// 2. dia_axpy_staged_kernel      <- dia_product_shared_axpy /
//    (dia_shared_axpy_kernel where     _dia_shared_axpy_kernel
//    no tile fits)
//    (A or A')(vec * c1) - c2 * y: the pair=False half-step.
// 3. dia_pair_kernel (staged)    <- dia_pair_shared /
//    dia_pair_ring_kernel            _dia_pair_shared_kernel_carry
//    u = A(vec * c1) - c2 * y and z = A' u in one pass: the staged pair of
//    csrc/dia_pair_staged.cuh on this layout (row stride Lp, row base H),
//    or, where no staged tile fits (many diagonals), the ring kernel.
//
// What bounds them on the H100: bytes. Each does ~2 flops per stripe
// element it reads (4 bytes, 2 in bf16), far below the card's ~20 flop/byte
// ridge, so the floor is device-memory traffic: the stripes (nd * dim * 4
// bytes, half that in bf16) plus 2 (product), 3 (axpy) or 4 (pair) f32
// vectors. At m = n = 2^23 with 11 diagonals that is 369 MB of f32 stripes
// against 67-134 MB of vectors.
//
// What the design does about it:
// * the product streams as the half-step below does, without y (csrc/
//   dia_product_staged.cuh, tiles from ops/spmv.py: product_tile); where no
//   tile fits, and for f64, the direct kernel: one thread per output element
//   in a grid-stride loop; for each diagonal a warp reads 32 neighbouring dp
//   addresses and 32 neighbouring vector addresses, so every load is
//   coalesced and every stripe byte is read from device memory once per
//   product;
// * the half-step (row 3) streams: a persistent grid walks tiles of T
//   outputs and keeps two of them in shared memory, the next one's 16-byte
//   cp.async copies in flight while this one is summed (dia_axpy_staged_
//   kernel below). A tile stages each diagonal's T stripe elements (in the
//   adjoint each at a 16-byte phase of its own), the vector window and y,
//   and recomputes nothing, so each stripe byte crosses once and the
//   vector window's x is read from shared memory, not once per diagonal
//   through L1/L2 as the direct kernel (one thread an output, kept for
//   windows no tile fits) reads it. At 2^23 x 11 it takes 0.176 ms in f32
//   and 0.108 ms in bf16, against the direct kernel's 0.231 / 0.211 on the
//   H100 (PERF.md; tools/halfstep_designs.py times the designs);
// * the pair replaces the TPU's carry scheme (z block t-1 written at grid
//   step t, which needs grid steps in order) by halo recompute. Its main
//   route is the staged pair (csrc/dia_pair_staged.cuh): one-sided halos
//   lo = max(0, -k_min), hi = max(0, k_max) (not H on both sides), each
//   tile's stripe rows [c0 - hi, c0 + T + lo) staged in shared memory by
//   16-byte cp.async copies (in this layout they are one window of each
//   stripe row, whose 16-byte phase is H % V for every diagonal, since Lp
//   is a multiple of 1024), a persistent grid two stages deep. Where no
//   tile's two stages fit (many diagonals: at 81 the stripe rows of one
//   tile of 1024 are 358 KB in f32), the ring kernel below: each block
//   walks a long run of indices in chunks, copies each chunk's stripe rows
//   into a ring in shared memory and forms u for the chunk and then z for
//   the columns whose rows are all in the ring; several blocks share an
//   SM, so one block's copies overlap the others' sums, and each stripe
//   byte is read from device memory once (reading a tile's stripes twice,
//   for u and again for z, costs 0.23 ms at 2^20 x 81 in f32, above half
//   the bound, 0.21 ms). Both sum in the same order: the same bits. No
//   atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_pair_staged.cuh"
#include "dia_product_staged.cuh"

namespace {

constexpr int kThreads = 256;

inline unsigned grid_for(long long count) {
  long long g = (count + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned>(g < cap ? g : cap);
}

// A stripe element in the accumulation type (f32 for bf16 storage).
__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ double widen(const double* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// S: stripe storage type; V: vector, accumulation and result type.
template <typename S, typename V>
__global__ void dia_product_shared_kernel(
    const S* __restrict__ dp, const V* __restrict__ vec, V* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long Lp, int H,
    long long dim_out, long long dim_in, int adjoint) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < dim_out; i += stride) {
    V acc = V(0);
    for (int d = 0; d < nd; ++d) {
      const int k = __ldg(offsets + d);
      const long long src = adjoint ? i - k : i + k;
      if (src >= 0 && src < dim_in) {
        const long long s = d * Lp + H + (adjoint ? i - k : i);
        acc += widen(dp + s) * __ldg(vec + src);
      }
    }
    out[i] = acc;
  }
}

template <typename S>
__global__ void dia_shared_axpy_kernel(
    const S* __restrict__ dp, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long Lp, int H,
    long long dim_out, long long dim_in, int adjoint) {
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < dim_out; i += stride) {
    float acc = (-c2) * __ldg(y + i);
    for (int d = 0; d < nd; ++d) {
      const int k = __ldg(offsets + d);
      const long long src = adjoint ? i - k : i + k;
      if (src >= 0 && src < dim_in) {
        const long long s = d * Lp + H + (adjoint ? i - k : i);
        acc += widen(dp + s) * (__ldg(vec + src) * c1);
      }
    }
    out[i] = acc;
  }
}

// The staged half-step (row 3): out = (A or A')(vec * c1) - c2 * y on a
// persistent grid. Block b walks the tiles b, b + grid, ... of T outputs
// and keeps kAxpyStages of them in shared memory, each staged by 16-byte
// cp.async copies while the tiles before it are summed: every diagonal's T
// stripe elements (row indices c0 + s_d, s_d = 0 forward and -k_d in the
// adjoint, so each diagonal's piece has a 16-byte phase of its own there,
// read from its address), the vector window [c0 - lo', c0 + T + hi') and
// y's T rows. No halo is recomputed: a tile stages nd (T + V) stripe
// elements, V = 16 bytes' worth, for any band. Each thread sums R outputs
// kAxpyThreads apart side by side, -c2 y first and then the diagonals in
// offset order, issuing kAxpyBatch diagonals' loads before it adds them:
// the direct kernel's order and expressions, so the same bits. T comes
// from ops/spmv.py: axpy_tile (AxpyLayout's bytes, mirrored there as
// axpy_stage_bytes: change both together); T = 0 (a vector window too
// wide for any tile's stages) takes the direct kernel above.
constexpr int kAxpyThreads = 256;
constexpr int kAxpyStages = 2;       // tiles in shared memory, the one summed included
constexpr int kAxpyBatch = 4;        // diagonals whose loads a thread issues together
static_assert(kAxpyStages >= 2 && kAxpyBatch % 4 == 0, "axpy shape");

// A stage: nd rows of L = T + V stripe elements, the vector window (T +
// lo + hi floats and up to 3 in front, rounded up to 4) and T floats of y;
// kAxpyStages of them, then the sign-adjusted offsets (nd rounded up to 4
// ints). T is a multiple of 16, so every part starts on the 16-byte grid.
struct AxpyLayout {
  long long L, LX, stage, bytes;
  __host__ __device__ AxpyLayout(int nd, int lo, int hi, int T, int esize) {
    L = static_cast<long long>(T) + 16 / esize;
    LX = round_up(static_cast<long long>(T) + lo + hi + 3, 4);
    stage = static_cast<long long>(nd) * L * esize + (LX + T) * 4;
    bytes = kAxpyStages * stage + 4 * round_up(nd, 4);
  }
};

// Stage the tile of outputs [c0, c0 + T) into `buf` (no commit). kk[d]: the
// offset in the direction taken (k_d forward, -k_d adjoint); the vector
// index of output i on diagonal d is i + kk[d], its stripe row i + s_d;
// lo, hi: the halos of that direction; ph: the 16-byte phase of row 0.
template <typename S>
__device__ __forceinline__ void axpy_stage(unsigned char* buf, const AxpyLayout& lay,
                                           const S* __restrict__ rows, long long stride,
                                           int ph, const float* __restrict__ vec,
                                           const float* __restrict__ y, const int* kk,
                                           int nd, long long dim_out, long long dim_in,
                                           int lo, int hi, int T, long long c0,
                                           int adjoint) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(dim_out - c0 < T ? dim_out - c0 : T);
  const int P = static_cast<int>(lay.L / V);  // 16-byte pieces a row holds
  S* const st = reinterpret_cast<S*>(buf);
  for (int e = threadIdx.x; e < nd * P; e += blockDim.x) {
    const int d = e / P, q = (e - d * P) * V;
    const long long s = c0 + (adjoint ? kk[d] : 0);
    const int sh = static_cast<int>((ph + s) & (V - 1));
    if (q < sh + len) cp_async16(st + d * lay.L + q, rows + d * stride + s - sh + q);
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
  float* const ys = xs + lay.LX;
  for (int q = threadIdx.x * 4; q < len; q += blockDim.x * 4) cp_async16(ys + q, y + c0 + q);
}

// Sum the staged tile [c0, c0 + T) into out: R outputs a thread,
// kAxpyThreads apart; those whose whole band lies inside [0, dim_in) skip
// the mask.
template <typename S, int R>
__device__ __forceinline__ void axpy_sum(const unsigned char* buf, const AxpyLayout& lay,
                                         int ph, const int* kk, int nd, float c1, float c2,
                                         float* __restrict__ out, long long dim_out,
                                         long long dim_in, int lo, int hi, int T,
                                         long long c0, int adjoint) {
  constexpr int V = 16 / sizeof(S);
  constexpr int kS = kAxpyThreads;
  constexpr int B = kAxpyBatch;
  const S* const st = reinterpret_cast<const S*>(buf);
  const float* const xs = reinterpret_cast<const float*>(buf + nd * lay.L * sizeof(S));
  const float* const ys = xs + lay.LX;
  const long long xa = c0 - lo > 0 ? c0 - lo : 0;
  const int sph = static_cast<int>((ph + c0) & (V - 1));  // row c0's phase
  const int nb = nd / B * B;  // diagonals taken in whole batches
  for (int g = 0; g < T; g += kS * R) {
    const int t0 = g + threadIdx.x;  // this thread's outputs c0 + t0 + kS q
    const long long i0 = c0 + t0;
    const float* const xb = xs + (xa & 3) + (i0 - xa);  // x[i0 + kS q + k] at xb[kS q + k]
    float acc[R];
    bool ok[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = t0 + q * kS;
      ok[q] = t < T && c0 + t < dim_out;
      acc[q] = ok[q] ? (-c2) * ys[t] : 0.0f;
    }
    if (ok[R - 1] && i0 >= lo && i0 + (R - 1) * kS + hi < dim_in) {
      for (int d = 0; d < nb; d += B) {
        int kq[B];
#pragma unroll
        for (int b = 0; b < B; b += 4) {
          const int4 k4 = *reinterpret_cast<const int4*>(kk + d + b);
          kq[b] = k4.x, kq[b + 1] = k4.y, kq[b + 2] = k4.z, kq[b + 3] = k4.w;
        }
        float sv[R][B], xv[R][B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const S* sd = st + (d + b) * lay.L + t0 + (adjoint ? (sph + kq[b]) & (V - 1) : sph);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            sv[q][b] = lds(sd + q * kS);
            xv[q][b] = xb[q * kS + kq[b]];
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int b = 0; b < B; ++b) acc[q] += sv[q][b] * (xv[q][b] * c1);
        }
      }
      for (int d = nb; d < nd; ++d) {
        const int k = kk[d];
        const S* sd = st + d * lay.L + t0 + (adjoint ? (sph + k) & (V - 1) : sph);
#pragma unroll
        for (int q = 0; q < R; ++q) acc[q] += lds(sd + q * kS) * (xb[q * kS + k] * c1);
      }
    } else {
      for (int d = 0; d < nd; ++d) {
        const int k = kk[d];
        const S* sd = st + d * lay.L + t0 + (adjoint ? (sph + k) & (V - 1) : sph);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const long long src = i0 + q * kS + k;
          if (ok[q] && src >= 0 && src < dim_in) {
            acc[q] += lds(sd + q * kS) * (xb[q * kS + k] * c1);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (ok[q]) out[i0 + q * kS] = acc[q];
    }
  }
}

// rows = dp + H; lo, hi: the halos of the direction taken. Each iteration
// waits for its tile's copies, synchronises (so every thread has also left
// the tile before, whose stage the next copies reuse), stages the tile
// kAxpyStages - 1 ahead and sums its own: one barrier a tile.
template <typename S, int R>
__global__ void __launch_bounds__(kAxpyThreads) dia_axpy_staged_kernel(
    const S* __restrict__ rows, long long stride, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long dim_out, long long dim_in, int lo,
    int hi, int T, long long tiles, int adjoint) {
  constexpr int V = 16 / sizeof(S);
  extern __shared__ __align__(16) unsigned char smem[];
  const AxpyLayout lay(nd, lo, hi, T, sizeof(S));
  int* const kk = reinterpret_cast<int*>(smem + kAxpyStages * lay.stage);
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    const int k = __ldg(offsets + d);
    kk[d] = adjoint ? -k : k;
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(rows) / sizeof(S)) % V);
  const long long grid = gridDim.x;
  __syncthreads();  // kk
#pragma unroll
  for (int s = 0; s < kAxpyStages - 1; ++s) {
    const long long tile = blockIdx.x + s * grid;
    if (tile < tiles) {
      axpy_stage(smem + s * lay.stage, lay, rows, stride, ph, vec, y, kk, nd, dim_out,
                 dim_in, lo, hi, T, tile * T, adjoint);
    }
    cp_async_commit();
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    cp_async_wait_group<kAxpyStages - 2>();  // this tile's copies
    __syncthreads();
    const long long ahead = tile + (kAxpyStages - 1) * grid;
    if (ahead < tiles) {
      axpy_stage(smem + (it + kAxpyStages - 1) % kAxpyStages * lay.stage, lay, rows, stride,
                 ph, vec, y, kk, nd, dim_out, dim_in, lo, hi, T, ahead * T, adjoint);
    }
    cp_async_commit();
    axpy_sum<S, R>(smem + it % kAxpyStages * lay.stage, lay, ph, kk, nd, c1, c2, out, dim_out,
                   dim_in, lo, hi, T, tile * T, adjoint);
  }
}

// The many-diagonal pair (the route counted as "unstaged": no staged
// tile's two stages fit). A persistent grid; block b owns the indices
// [a, b) of BOTH u (rows) and z (columns), whole chunks of kRingChunk, and
// walks its rows in steps: step k stages the stripe rows of chunk k +
// kRingAhead (rows [s0 + (k + kRingAhead) C, + C) of every diagonal) into
// a ring of W rows in shared memory with 16-byte cp.async copies, and the
// x window of chunk k, computes u for chunk k's rows from the rings (-c2 y
// first, then the diagonals in offset order) into a ring of u, and then z
// for the columns [c0 - lo, c0 + C - lo), whose rows j - k (in
// [c0 - lo - hi, c0 + C)) all sit in the rings: the lo + hi rows before
// the chunk stay there from the steps before. So each stripe byte crosses
// from device memory once (plus the lo + hi rows in front of a block's
// first index), and no halo is recomputed except there. W = (kRingAhead +
// 1) C + lo + hi, rounded up to 16 bytes' worth (RingLayout; ops/spmv.py:
// pair_ring_bytes mirrors it). Row r of every diagonal sits at 16-byte
// phase (ph + r) % V (Lp is a multiple of 1024), and s0 is on that grid, so
// a chunk's copies are aligned pieces of V rows, each at one place in the
// ring. The shape below was the fastest of those tools/pair_designs.py
// times (PERF.md): no chunk in flight and small blocks, so that several
// blocks share an SM (at 81 diagonals three in f32, six in bf16) and one
// block's copies overlap the others' sums; a deeper ring allows fewer
// blocks an SM and lost by 10-28%.
constexpr int kRingThreads = 128;
constexpr int kRingChunk = 128;  // C: rows a step adds (a multiple of kRingThreads)
constexpr int kRingAhead = 0;    // chunks in flight ahead of the one a step computes
constexpr int kRingBatch = 4;    // diagonals whose loads a thread issues together
static_assert(kRingChunk % kRingThreads == 0 && kRingBatch % 4 == 0, "ring shape");

// The ring's shared memory: nd rows of W stripe elements, u for W rows,
// a step's x window (C + lo + hi floats, rounded up to 4), then the
// offsets and the z places (nd rounded up to 4 ints each).
struct RingLayout {
  int W, LX, nd4;
  long long u_at, bytes;
  __host__ __device__ RingLayout(int nd, int lo, int hi, int esize) {
    const int v = 16 / esize;
    W = ((kRingAhead + 1) * kRingChunk + lo + hi + v - 1) / v * v;
    LX = (kRingChunk + lo + hi + 3) / 4 * 4;
    nd4 = (nd + 3) / 4 * 4;
    u_at = round_up(static_cast<long long>(nd) * W * esize, 16);
    bytes = u_at + 4LL * W + 4LL * LX + 8LL * nd4;
  }
};

__device__ __forceinline__ int wrap(int p, int W) { return p >= W ? p - W : p; }

// rows = dp + H (diagonal d's row r at rows[d * stride + r]); `units`
// chunks of kRingChunk cover max(m, n). Each thread takes R rows (columns)
// of a step, kRingThreads apart, their sums side by side, and issues the
// loads of kRingBatch diagonals before it adds them (in offset order).
template <typename S>
__global__ void __launch_bounds__(kRingThreads) dia_pair_ring_kernel(
    const S* __restrict__ rows, long long stride, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ u, float* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n, int lo, int hi,
    long long units) {
  constexpr int V = 16 / sizeof(S);
  constexpr int C = kRingChunk;
  constexpr int R = C / kRingThreads;
  constexpr int B = kRingBatch;
  constexpr int kPieces = C / V;  // 16-byte copies a chunk and diagonal
  extern __shared__ __align__(16) unsigned char smem[];
  const RingLayout lay(nd, lo, hi, sizeof(S));
  const int W = lay.W;
  S* const ring = reinterpret_cast<S*>(smem);
  float* const u_s = reinterpret_cast<float*>(smem + lay.u_at);
  float* const x_s = u_s + W;  // x[c0 - lo + e] at e
  int* const ks = reinterpret_cast<int*>(x_s + lay.LX);  // 16-byte aligned: W % 4 == 0
  int* const zoff = ks + lay.nd4;  // this step's: where row c0 - lo - k_d sits in the ring
  const int tid = threadIdx.x;
  const long long dim = m > n ? m : n;
  const long long a = static_cast<long long>(blockIdx.x) * units / gridDim.x * C;
  long long b = (static_cast<long long>(blockIdx.x) + 1) * units / gridDim.x * C;
  b = b < dim ? b : dim;
  if (a >= b) return;
  for (int d = tid; d < nd; d += kRingThreads) ks[d] = __ldg(offsets + d);
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(rows) / sizeof(S)) % V);
  const long long t0 = ph + a - hi;  // s0: at or below a - hi, on the 16-byte grid
  const long long s0 = (t0 >= 0 ? t0 / V : -((V - 1 - t0) / V)) * V - ph;
  const int steps = static_cast<int>((b + lo - s0 + C - 1) / C);
  const int nb = nd / B * B;  // diagonals taken in whole batches

  // chunk k's stripe rows in [0, m), to ring places (k C) mod W onwards
  auto stage = [&](int k) {
    const long long c0 = s0 + static_cast<long long>(k) * C;
    const int p0 = static_cast<int>(static_cast<long long>(k) * C % W);
    for (int e = tid; e < nd * kPieces; e += kRingThreads) {
      const int d = e / kPieces, q = (e % kPieces) * V;
      const long long r = c0 + q;
      if (r + V > 0 && r < m) {
        cp_async16(ring + static_cast<long long>(d) * W + wrap(p0 + q, W),
                   rows + d * stride + r);
      }
    }
    cp_async_commit();
  };

  __syncthreads();  // ks
  for (int k = 0; k < kRingAhead; ++k) {
    if (k < steps) stage(k);
    else cp_async_commit();
  }
  int p0 = 0;  // the ring place of this step's first row
  for (int k = 0; k < steps; ++k) {
    if (k + kRingAhead < steps) stage(k + kRingAhead);
    else cp_async_commit();
    const long long c0 = s0 + static_cast<long long>(k) * C;
    for (int e = tid; e < C + lo + hi; e += kRingThreads) {  // zero outside [0, n): never read
      const long long c = c0 - lo + e;
      x_s[e] = c >= 0 && c < n ? __ldg(vec + c) : 0.0f;
    }
    cp_async_wait_group<kRingAhead>();  // chunk k's copies
    __syncthreads();
    for (int d = tid; d < nd; d += kRingThreads) {
      const int p = p0 - lo - ks[d];
      zoff[d] = p < 0 ? p + W : p;
    }
    // 1. u for rows [c0, c0 + C): -c2 y, then the diagonals in offset
    // order; when all the thread's rows have their whole band inside
    // [0, n), without the mask
    {
      float acc[R];
      int p[R];
      bool ok[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long r = c0 + tid + i * kRingThreads;
        p[i] = wrap(p0 + tid + i * kRingThreads, W);
        ok[i] = r >= 0 && r < m;
        acc[i] = ok[i] ? (-c2) * __ldg(y + r) : 0.0f;
      }
      const long long r0 = c0 + tid, rl = r0 + (R - 1) * kRingThreads;
      const float* xr = x_s + lo + tid;  // x[r0 + k] at xr[k]
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
              sv[i][q] = lds(ring + (d + q) * W + p[i]);
              xv[i][q] = xr[i * kRingThreads + kk[q]];
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
            acc[i] += lds(ring + d * W + p[i]) * (xr[i * kRingThreads + kd] * c1);
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int kd = ks[d];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const long long c = r0 + i * kRingThreads + kd;
            if (ok[i] && c >= 0 && c < n)
              acc[i] += lds(ring + d * W + p[i]) * (xr[i * kRingThreads + kd] * c1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long r = r0 + i * kRingThreads;
        if (ok[i] && r >= a && r < b) u[r] = acc[i];
        u_s[p[i]] = acc[i];  // zero outside [0, m)
      }
    }
    __syncthreads();
    // 2. z[j] = sum_d A[j - k, j] * u[j - k] for the columns [c0 - lo,
    // c0 + C - lo) of [a, b); when all the thread's columns have their rows
    // inside [0, m), without the mask
    {
      const long long j0 = c0 - lo + tid, jl = j0 + (R - 1) * kRingThreads;
      float acc[R];
      bool ok[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long j = j0 + i * kRingThreads;
        ok[i] = j >= a && j < b && j < n;
        acc[i] = 0.0f;
      }
      if (ok[0] && ok[R - 1] && j0 >= hi && jl + lo < m) {
        for (int d = 0; d < nb; d += B) {
          int zz[B];
#pragma unroll
          for (int q = 0; q < B; q += 4) {
            const int4 z4 = *reinterpret_cast<const int4*>(zoff + d + q);
            zz[q] = z4.x, zz[q + 1] = z4.y, zz[q + 2] = z4.z, zz[q + 3] = z4.w;
          }
          float sv[R][B], uv[R][B];
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int q = 0; q < B; ++q) {
              const int pq = wrap(zz[q] + tid + i * kRingThreads, W);
              sv[i][q] = lds(ring + (d + q) * W + pq);
              uv[i][q] = u_s[pq];
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int q = 0; q < B; ++q) acc[i] += sv[i][q] * uv[i][q];
          }
        }
        for (int d = nb; d < nd; ++d) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int pq = wrap(zoff[d] + tid + i * kRingThreads, W);
            acc[i] += lds(ring + d * W + pq) * u_s[pq];
          }
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const int kd = ks[d];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const long long rr = j0 + i * kRingThreads - kd;
            const int pq = wrap(zoff[d] + tid + i * kRingThreads, W);
            if (ok[i] && rr >= 0 && rr < m) acc[i] += lds(ring + d * W + pq) * u_s[pq];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (ok[i]) z[j0 + i * kRingThreads] = acc[i];
      }
    }
    __syncthreads();  // before the next step restages ring places and rewrites u_s
    p0 = wrap(p0 + C, W);
  }
}

// The product: the staged kernel in tiles of T (ops/spmv.py: product_tile;
// lo = max(0, -k_min), hi = max(0, k_max), at most H; dp and vec 16-byte
// aligned; f32 and bf16 stripes), or the direct kernel where T is 0.
template <typename S, typename V>
int launch_product(const void* dp, const void* vec, void* out,
                   const void* offsets, int nd, long long Lp, int H,
                   long long dim_out, long long dim_in, int adjoint, int lo,
                   int hi, int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    dia_product_shared_kernel<S, V><<<grid_for(dim_out), kThreads, 0, s>>>(
        static_cast<const S*>(dp), static_cast<const V*>(vec),
        static_cast<V*>(out), static_cast<const int*>(offsets), nd, Lp, H,
        dim_out, dim_in, adjoint);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (sizeof(V) != 4) {
    return static_cast<int>(cudaErrorInvalidValue);  // f64 takes the direct kernel
  } else {
    if (lo > H || hi > H || Lp % 16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_product_staged<S>(dp, nd * Lp, Lp, H, vec, out, offsets, nd, dim_out,
                                    dim_in, adjoint, lo, hi, T, s);
  }
}

template <typename S, int R>
int launch_axpy_staged(const S* rows, long long Lp, const float* vec, const float* y,
                       const float* c1, const float* c2, float* out, const int* offsets,
                       int nd, long long dim_out, long long dim_in, int lo, int hi, int T,
                       int adjoint, cudaStream_t stream) {
  const AxpyLayout lay(nd, lo, hi, T, sizeof(S));
  auto kernel = dia_axpy_staged_kernel<S, R>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kAxpyThreads, lay.bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (dim_out + T - 1) / T;
  const long long slots = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(tiles < slots ? tiles : slots), kAxpyThreads, lay.bytes,
           stream>>>(rows, Lp, vec, y, c1, c2, out, offsets, nd, dim_out, dim_in, lo, hi, T,
                     tiles, adjoint);
  return static_cast<int>(cudaGetLastError());
}

// The half-step: the staged kernel in tiles of T (ops/spmv.py: axpy_tile;
// lo = max(0, -k_min), hi = max(0, k_max), at most H; dp, vec and y
// 16-byte aligned), or the direct kernel where T is 0.
template <typename S>
int launch_axpy(const void* dp, const void* vec, const void* y, const void* c1,
                const void* c2, void* out, const void* offsets, int nd,
                long long Lp, int H, long long dim_out, long long dim_in,
                int adjoint, int lo, int hi, int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    dia_shared_axpy_kernel<S><<<grid_for(dim_out), kThreads, 0, s>>>(
        static_cast<const S*>(dp), static_cast<const float*>(vec),
        static_cast<const float*>(y), static_cast<const float*>(c1),
        static_cast<const float*>(c2), static_cast<float*>(out),
        static_cast<const int*>(offsets), nd, Lp, H, dim_out, dim_in, adjoint);
    return static_cast<int>(cudaGetLastError());
  }
  if (T < 16 || T % 16 || lo < 0 || hi < 0 || lo > H || hi > H || Lp % 16 ||
      !aligned16(dp) || !aligned16(vec) || !aligned16(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim_out == 0) return 0;
  const int lo_ = adjoint ? hi : lo, hi_ = adjoint ? lo : hi;  // this direction's halos
  const auto* rows = static_cast<const S*>(dp) + H;
  const auto* vp = static_cast<const float*>(vec);
  const auto* yp = static_cast<const float*>(y);
  const auto* c1p = static_cast<const float*>(c1);
  const auto* c2p = static_cast<const float*>(c2);
  auto* op = static_cast<float*>(out);
  const auto* off = static_cast<const int*>(offsets);
  if (T >= 4 * kAxpyThreads) {
    return launch_axpy_staged<S, 4>(rows, Lp, vp, yp, c1p, c2p, op, off, nd, dim_out, dim_in,
                                    lo_, hi_, T, adjoint, s);
  }
  if (T >= 2 * kAxpyThreads) {
    return launch_axpy_staged<S, 2>(rows, Lp, vp, yp, c1p, c2p, op, off, nd, dim_out, dim_in,
                                    lo_, hi_, T, adjoint, s);
  }
  return launch_axpy_staged<S, 1>(rows, Lp, vp, yp, c1p, c2p, op, off, nd, dim_out, dim_in,
                                  lo_, hi_, T, adjoint, s);
}

// The ring pair on the shared layout: halos lo = max(0, -k_min) and
// hi = max(0, k_max), at most H; dp 16-byte aligned. A grid of as many
// blocks as fit the SMs, each owning whole chunks.
template <typename S>
int launch_pair_ring(const void* dp, const void* vec, const void* y, const void* c1,
                     const void* c2, void* u, void* z, const void* offsets, int nd,
                     long long Lp, int H, long long m, long long n, int lo, int hi,
                     void* stream) {
  if (H < 0 || H > kPairMaxHalo || lo < 0 || hi < 0 || lo > H || hi > H || Lp % 16 ||
      !aligned16(dp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long dim = m > n ? m : n;
  if (dim == 0) return 0;
  const RingLayout lay(nd, lo, hi, sizeof(S));
  auto kernel = dia_pair_ring_kernel<S>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes)));
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kRingThreads, lay.bytes));
  }
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units = (dim + kRingChunk - 1) / kRingChunk;
  const long long slots = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(units < slots ? units : slots), kRingThreads, lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dp) + H, Lp, static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(u), static_cast<float*>(z),
      static_cast<const int*>(offsets), nd, m, n, lo, hi, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lsqr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define LSQR_PRODUCT(SUFFIX, S, V)                                              \
  int lsqr_dia_product_shared_##SUFFIX(                                         \
      const void* dp, const void* vec, void* out, const void* offsets, int nd,  \
      long long Lp, int H, long long dim_out, long long dim_in, int adjoint,    \
      int lo, int hi, int T, void* stream) {                                    \
    return launch_product<S, V>(dp, vec, out, offsets, nd, Lp, H, dim_out,      \
                                dim_in, adjoint, lo, hi, T, stream);            \
  }

#define LSQR_AXPY(SUFFIX, S)                                                    \
  int lsqr_dia_shared_axpy_##SUFFIX(                                            \
      const void* dp, const void* vec, const void* y, const void* c1,           \
      const void* c2, void* out, const void* offsets, int nd, long long Lp,     \
      int H, long long dim_out, long long dim_in, int adjoint, int lo, int hi,  \
      int T, void* stream) {                                                    \
    return launch_axpy<S>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H,          \
                          dim_out, dim_in, adjoint, lo, hi, T, stream);         \
  }

#define LSQR_PAIR(SUFFIX, S)                                                    \
  int lsqr_dia_pair_shared_##SUFFIX(                                            \
      const void* dp, const void* vec, const void* y, const void* c1,           \
      const void* c2, void* u, void* z, const void* offsets, int nd,            \
      long long Lp, int H, long long m, long long n, int lo, int hi,            \
      void* stream) {                                                           \
    return launch_pair_ring<S>(dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, \
                               n, lo, hi, stream);                              \
  }

// The staged pair on this layout: tile T from lsqr_dia_pair_tile_* (the
// staged bytes are those of the packed layout).
#define LSQR_PAIR_STAGED(SUFFIX, S)                                             \
  int lsqr_dia_pair_shared_staged_##SUFFIX(                                     \
      const void* dp, const void* vec, const void* y, const void* c1,           \
      const void* c2, void* u, void* z, const void* offsets, int nd,            \
      long long Lp, int H, long long m, long long n, int lo, int hi, int T,     \
      void* stream) {                                                           \
    if (lo > H || hi > H) return static_cast<int>(cudaErrorInvalidValue);      \
    return launch_pair_staged<S>(dp, Lp, H, vec, y, c1, c2, u, z, offsets, nd,  \
                                 m, n, lo, hi, T, stream);                      \
  }

LSQR_PRODUCT(f32, float, float)
LSQR_PRODUCT(f64, double, double)
LSQR_PRODUCT(bf16, __nv_bfloat16, float)
LSQR_AXPY(f32, float)
LSQR_AXPY(bf16, __nv_bfloat16)
LSQR_PAIR(f32, float)
LSQR_PAIR(bf16, __nv_bfloat16)
LSQR_PAIR_STAGED(f32, float)
LSQR_PAIR_STAGED(bf16, __nv_bfloat16)

#undef LSQR_PRODUCT
#undef LSQR_AXPY
#undef LSQR_PAIR
#undef LSQR_PAIR_STAGED

}  // extern "C"
