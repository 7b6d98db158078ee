// Packed-stripe DIA kernels for Hopper (sm_90a): the products of the
// JAX package's DIAOperator (the packed layout).
//
// Layout (ops/structured.py: DIAOperator). No padding: the stripes are
// row-aligned, one row of length m per diagonal,
//     data[d * m + i] = A[i, i + k_d]        for 0 <= i < m,
// zero where i + k_d lies outside [0, n). The adjoint either runs the
// forward kernel on the packed transpose (tdata, (nd, n), offsets -k_d) or
// reads data from the column side:
//     forward  y[i] = sum_d data[d*m + i]       * x[i + k_d],  0 <= i + k_d < n
//     column   z[j] = sum_d data[d*m + j - k_d] * u[j - k_d],  0 <= j - k_d < m
// Every stripe and vector read is masked by index. Diagonals are summed in
// offset order per output element; an axpy starts from -c2 * y. c1 and c2
// are device scalars read through pointers, so the solver never waits for
// them on the host.
//
// Stripe storage: f32, f64 (dia_matvec only) or bf16 (a storage format:
// vectors, c1, c2 and the accumulation stay f32). The results are f32,
// except that dia_matvec_axpy on bf16 stripes stores bf16 (the f32 sum
// rounded to nearest even, as the JAX kernel returns data.dtype), or f32
// through its _f32out launcher.
//
// Kernels and the TPU kernels they replace (lsqr_tpu/ops/pallas_spmv.py):
//
// 1. dia_matvec_kernel          <- dia_matvec / _dia_kernel
//    y = A x on data (or A' y on tdata); the column mode gives A' u from
//    data, for the pair's wide-halo route.
// 2. dia_matvec_axpy_kernel     <- dia_matvec_axpy / _dia_axpy_kernel
//    A (vec * c1) - c2 * y.
// 3. dia_fused_halfstep_kernel  <- dia_fused_halfstep / _dia_fused_kernel
//    as 2, plus ssq = sum(out^2), f32.
// 4. dia_pair_kernel            <- dia_pair / _dia_pair_kernel_carry,
//                                  _dia_pair_kernel
//    u = A(vec * c1) - c2 * y and z = A' u in one pass over data.
// 5. dia_fused_halfstep_v2_kernel <- dia_fused_halfstep_v2 /
//                                    _dia_axpy_ssq_kernel
//    as 3, f32 or bf16 stripes, out in the stripes' dtype; ssq reduced in
//    the launch as 3 does (the TPU kernel accumulates it across its grid in
//    one SMEM scalar or one revisited VMEM block).
// 6. dia_fused_halfstep_v3_kernel <- dia_fused_halfstep_v3 /
//                                    _dia_axpy_ssq_rows_kernel
//    as 5, but each block writes its partial sum to a slot of its own and
//    the wrapper adds the slots (the TPU kernel writes one partial per grid
//    step to rows of its own): no ticket, no block reads another's slot.
//
// Kernels 2, 3, 5 and 6 share one row helper (axpy_row), so they sum each
// row in the same order.
//
// What bounds them on the H100: bytes. ~2 flops per stripe element read
// (4 bytes, 2 in bf16) is far below the card's ~20 flop/byte ridge, so the
// floor is device-memory traffic: the stripes (nd * dim * 4 bytes) plus 2
// (product), 3 (axpy, fused half-step) or 4 (pair) f32 vectors. At
// m = n = 2^23 with 11 diagonals: 369 MB of f32 stripes, 34 MB per vector.
//
// What the design does about it:
// * one thread per output element in a grid-stride loop: for each diagonal
//   a warp reads 32 neighbouring stripe and vector addresses, so every load
//   is coalesced and each stripe byte comes from device memory once;
// * the fused half-step's norm is reduced in the same pass, without float
//   atomics: each block writes its partial sum to a scratch slot, and the
//   last block to finish (an integer ticket after __threadfence) sums the
//   slots in a fixed order and resets the ticket. The result does not
//   depend on block timing. The grid is capped at kReduceBlocks so that
//   sum stays short. v3 leaves that sum to the wrapper (one more small
//   launch, torch.sum over at most kReduceBlocks floats, also in a fixed
//   order); the norm is of the f32 sums, before a bf16 out is rounded;
// * the pair (kernel 4) does not copy the TPU's carry scheme (z block t-1
//   written at grid step t needs grid steps in order; CUDA blocks run in
//   none). It recomputes a one-sided halo: with lo = max(0, -k_min) and
//   hi = max(0, k_max), the tile of indices [c0, c0 + T) computes u for
//   rows [c0 - hi, c0 + T + lo), writes its own rows of u, and forms z for
//   columns [c0, c0 + T) from that u. No atomics: deterministic. The
//   stripe rows of a tile, its x window and its y rows are staged in
//   shared memory with 16-byte cp.async copies, each range rounded out to
//   16 bytes (the edges masked by index as before), so both halves read
//   the stripes from shared memory and each stripe byte leaves device
//   memory once (plus the halo's (lo + hi)/T share). A persistent grid of
//   as many blocks as fit the SMs walks the tiles, two stages deep: the
//   next tile's copies are in flight while this one computes. Each thread
//   sums four rows (columns) 256 apart side by side, so it reads each
//   diagonal's offset once for four sums and neighbouring lanes read
//   neighbouring shared words; u and z leave through shared memory, 16
//   bytes a thread. T = 1024 k - (lo + hi rounded up to 4) for the least k
//   in 1, 2, 4, 8 whose two stages fit two blocks an SM (else one), with
//   T >= lo + hi (pair_tile); where none fits, or a halo exceeds
//   kPairMaxHalo, the wrapper takes two launches (kernel 2, then kernel
//   1's column mode).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairThreads = 256;    // the pair's block
constexpr int kPairMaxHalo = 1024;   // largest lo or hi the pair accepts
constexpr int kReduceBlocks = 1024;  // grid cap of the fused half-step

inline unsigned grid_for(long long count) {
  long long g = (count + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned>(g < cap ? g : cap);
}

// The grid of the fused half-steps: one block per kThreads rows, at most
// `slots` and kReduceBlocks blocks (0 when there is nothing to do).
inline unsigned reduce_grid(long long dim_out, int slots) {
  if (dim_out <= 0 || slots <= 0) return 0u;
  long long blocks = (dim_out + kThreads - 1) / kThreads;
  if (blocks > slots) blocks = slots;
  if (blocks > kReduceBlocks) blocks = kReduceBlocks;
  return static_cast<unsigned>(blocks);
}

// A stripe element in the accumulation type (f32 for bf16 storage).
__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ double widen(const double* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// S: stripe storage type; V: vector, accumulation and result type. The
// stripe rows have length dim_out (forward) or dim_in (column mode).
template <typename S, typename V>
__global__ void dia_matvec_kernel(
    const S* __restrict__ data, const V* __restrict__ vec, V* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long dim_out,
    long long dim_in, int column) {
  const long long row_len = column ? dim_in : dim_out;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < dim_out; i += stride) {
    V acc = V(0);
    for (int d = 0; d < nd; ++d) {
      const int k = __ldg(offsets + d);
      const long long src = column ? i - k : i + k;
      if (src >= 0 && src < dim_in) {
        acc += widen(data + d * row_len + (column ? src : i)) * __ldg(vec + src);
      }
    }
    out[i] = acc;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Row i of A (vec * c1) - c2 * y, in f32, the diagonals in offset order.
template <typename S>
__device__ __forceinline__ float axpy_row(
    const S* __restrict__ data, const float* __restrict__ vec,
    const float* __restrict__ y, float c1, float c2,
    const int* __restrict__ offsets, int nd, long long i, long long dim_out,
    long long dim_in) {
  float acc = (-c2) * __ldg(y + i);
  for (int d = 0; d < nd; ++d) {
    const int k = __ldg(offsets + d);
    const long long src = i + k;
    if (src >= 0 && src < dim_in) {
      acc += widen(data + d * dim_out + i) * (__ldg(vec + src) * c1);
    }
  }
  return acc;
}

// O: result type (f32, or bf16 for bf16 stripes).
template <typename S, typename O>
__global__ void dia_matvec_axpy_kernel(
    const S* __restrict__ data, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, O* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long dim_out,
    long long dim_in) {
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < dim_out; i += stride) {
    store(out + i, axpy_row(data, vec, y, c1, c2, offsets, nd, i, dim_out, dim_in));
  }
}

// Sum of v over the block, in a fixed tree order. Every thread of the
// block must call it; red holds kThreads floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// This block's part of A (vec * c1) - c2 * y into out (grid-stride), and
// the block's sum of the f32 rows squared (every thread gets it).
template <typename S, typename O>
__device__ __forceinline__ float axpy_ssq_block(
    const S* __restrict__ data, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, O* __restrict__ out,
    const int* __restrict__ offsets, int nd, long long dim_out,
    long long dim_in, float* red) {
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float local = 0.0f;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < dim_out; i += stride) {
    const float acc = axpy_row(data, vec, y, c1, c2, offsets, nd, i, dim_out, dim_in);
    store(out + i, acc);
    local += acc * acc;
  }
  return block_sum(local, red);
}

// The body of kernels 3 and 5: the partial sums in slots, and the last
// block (by an integer ticket) sums them in slot order.
template <typename S, typename O>
__device__ __forceinline__ void fused_halfstep_ticketed(
    const S* __restrict__ data, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, O* __restrict__ out,
    float* __restrict__ partial, unsigned int* __restrict__ ticket,
    float* __restrict__ ssq, const int* __restrict__ offsets, int nd,
    long long dim_out, long long dim_in) {
  __shared__ float red[kThreads];
  __shared__ bool last;
  const float block_total = axpy_ssq_block(data, vec, y, c1p, c2p, out, offsets,
                                           nd, dim_out, dim_in, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = block_total;
    __threadfence();  // the slot is visible before the ticket counts it
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float acc = 0.0f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    acc += __ldcg(partial + b);  // from L2: other blocks wrote the slots
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    *ssq = total;
    *ticket = 0u;  // ready for the next launch
  }
}

#define LSQR_TICKETED_PARAMS                                                    \
  const S *__restrict__ data, const float *__restrict__ vec,                    \
      const float *__restrict__ y, const float *__restrict__ c1p,               \
      const float *__restrict__ c2p, O *__restrict__ out,                       \
      float *__restrict__ partial, unsigned int *__restrict__ ticket,           \
      float *__restrict__ ssq, const int *__restrict__ offsets, int nd,         \
      long long dim_out, long long dim_in
#define LSQR_TICKETED_ARGS                                                      \
  data, vec, y, c1p, c2p, out, partial, ticket, ssq, offsets, nd, dim_out, dim_in

// Kernel 3 (f32 stripes and out).
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads) dia_fused_halfstep_kernel(
    LSQR_TICKETED_PARAMS) {
  fused_halfstep_ticketed(LSQR_TICKETED_ARGS);
}

// Kernel 5 (f32 or bf16 stripes, out in the stripes' dtype).
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads) dia_fused_halfstep_v2_kernel(
    LSQR_TICKETED_PARAMS) {
  fused_halfstep_ticketed(LSQR_TICKETED_ARGS);
}

#undef LSQR_TICKETED_PARAMS
#undef LSQR_TICKETED_ARGS

// Kernel 6: each block's partial sum to its own slot, nothing more.
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads) dia_fused_halfstep_v3_kernel(
    const S* __restrict__ data, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, O* __restrict__ out,
    float* __restrict__ partial, const int* __restrict__ offsets, int nd,
    long long dim_out, long long dim_in) {
  __shared__ float red[kThreads];
  const float block_total = axpy_ssq_block(data, vec, y, c1p, c2p, out, offsets,
                                           nd, dim_out, dim_in, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = block_total;
}

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

__host__ __device__ inline long long round_up(long long v, long long q) {
  return (v + q - 1) / q * q;
}

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
template <typename S>
__device__ __forceinline__ void stage_tile(unsigned char* buf, const PairLayout& lay,
                                           const S* __restrict__ data,
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
      const S* src = data + d * m + ra - sh;
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

// Kernel 4: the tiles [c0, c0 + T) of BOTH u (rows) and z (columns), c0 =
// tile * T, tile = blockIdx.x, + gridDim.x, ... over ceil(max(m, n) / T).
// Each pass over a tile's rows (columns) takes kGroup of them, four a
// thread kPairThreads apart (so neighbouring lanes read neighbouring shared
// words), each thread's four sums side by side over the diagonals.
template <typename S>
__global__ void __launch_bounds__(kPairThreads) dia_pair_kernel(
    const S* __restrict__ data, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ u,
    float* __restrict__ z, const int* __restrict__ offsets, int nd,
    long long m, long long n, int lo, int hi, int T, long long tiles) {
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
  int* const dmod = ks + nd;   // (d * m) % V: the stripe row's place in 16 bytes
  int* const soff = dmod + nd;  // this tile's: where row ra of diagonal d sits
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    ks[d] = __ldg(offsets + d);
    dmod[d] = static_cast<int>(d * m % V);
  }
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int tid = threadIdx.x;
  __syncthreads();
  long long tile = blockIdx.x;
  int cur = 0;
  if (tile < tiles) stage_tile(smem, lay, data, vec, y, dmod, nd, m, n, lo, hi, T, tile);
  for (; tile < tiles; tile += gridDim.x, cur ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      stage_tile(smem + (cur ^ 1) * lay.stage, lay, data, vec, y, dmod, nd, m, n, lo, hi, T,
                 next);
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
    // 2. z[j] = sum_d data[d, j - k] * u[j - k] for the tile's columns (row
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
// esize bytes on this card: T = 1024 k - (lo + hi rounded up to 4), so a
// tile's rows and halo make at most k passes of 1024, for the least k of
// 1, 2, 4 and 8 with T >= 256 and T >= lo + hi whose layout fits two
// blocks an SM, else one; 0 when none fits (the wrapper then takes two
// launches).
int pair_tile(int nd, int lo, int hi, int esize) {
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename S, typename V>
int launch_matvec(const void* data, const void* vec, void* out,
                  const void* offsets, int nd, long long dim_out,
                  long long dim_in, int column, void* stream) {
  dia_matvec_kernel<S, V>
      <<<grid_for(dim_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const S*>(data), static_cast<const V*>(vec),
          static_cast<V*>(out), static_cast<const int*>(offsets), nd, dim_out,
          dim_in, column);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename O>
int launch_matvec_axpy(const void* data, const void* vec, const void* y,
                       const void* c1, const void* c2, void* out,
                       const void* offsets, int nd, long long dim_out,
                       long long dim_in, void* stream) {
  dia_matvec_axpy_kernel<S, O>
      <<<grid_for(dim_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const S*>(data), static_cast<const float*>(vec),
          static_cast<const float*>(y), static_cast<const float*>(c1),
          static_cast<const float*>(c2), static_cast<O*>(out),
          static_cast<const int*>(offsets), nd, dim_out, dim_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_pair(const void* data, const void* vec, const void* y,
                const void* c1, const void* c2, void* u, void* z,
                const void* offsets, int nd, long long m, long long n, int lo,
                int hi, int T, void* stream) {
  const PairLayout lay(nd, lo, hi, T, sizeof(S));
  if (lo < 0 || hi < 0 || lo > kPairMaxHalo || hi > kPairMaxHalo || T < 256 || T % 4 ||
      T < lo + hi || T + lo + hi > 8 * 4 * kPairThreads || !aligned16(data) ||
      !aligned16(vec) || !aligned16(y) || !aligned16(u) || !aligned16(z)) {
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
      static_cast<const S*>(data), static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(u),
      static_cast<float*>(z), static_cast<const int*>(offsets), nd, m, n, lo,
      hi, T, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define LSQR_MATVEC(SUFFIX, S, V)                                               \
  int lsqr_dia_matvec_##SUFFIX(const void* data, const void* vec, void* out,    \
                               const void* offsets, int nd, long long dim_out,  \
                               long long dim_in, int column, void* stream) {    \
    return launch_matvec<S, V>(data, vec, out, offsets, nd, dim_out, dim_in,    \
                               column, stream);                                 \
  }

#define LSQR_MATVEC_AXPY(SUFFIX, S, O)                                          \
  int lsqr_dia_matvec_axpy_##SUFFIX(                                            \
      const void* data, const void* vec, const void* y, const void* c1,         \
      const void* c2, void* out, const void* offsets, int nd,                   \
      long long dim_out, long long dim_in, void* stream) {                      \
    return launch_matvec_axpy<S, O>(data, vec, y, c1, c2, out, offsets, nd,     \
                                    dim_out, dim_in, stream);                   \
  }

#define LSQR_PAIR(SUFFIX, S)                                                    \
  int lsqr_dia_pair_##SUFFIX(const void* data, const void* vec, const void* y,  \
                             const void* c1, const void* c2, void* u, void* z,  \
                             const void* offsets, int nd, long long m,          \
                             long long n, int lo, int hi, int T,                \
                             void* stream) {                                    \
    return launch_pair<S>(data, vec, y, c1, c2, u, z, offsets, nd, m, n, lo,    \
                          hi, T, stream);                                       \
  }                                                                             \
  int lsqr_dia_pair_tile_##SUFFIX(int nd, int lo, int hi) {                     \
    return pair_tile(nd, lo, hi, sizeof(S));                                    \
  }

LSQR_MATVEC(f32, float, float)
LSQR_MATVEC(f64, double, double)
LSQR_MATVEC(bf16, __nv_bfloat16, float)
LSQR_MATVEC_AXPY(f32, float, float)
LSQR_MATVEC_AXPY(bf16, __nv_bfloat16, __nv_bfloat16)
LSQR_MATVEC_AXPY(bf16_f32out, __nv_bfloat16, float)
LSQR_PAIR(f32, float)
LSQR_PAIR(bf16, __nv_bfloat16)

#undef LSQR_MATVEC
#undef LSQR_MATVEC_AXPY
#undef LSQR_PAIR

// partial holds at least `slots` floats; the grid is min(blocks needed,
// slots, kReduceBlocks). With a ticket (kernels 3 and 5) it is 0 on entry and
// the kernel leaves it 0; without one (kernel 6) the caller adds partial's
// first min(blocks needed, slots, kReduceBlocks) slots, which the wrapper
// sizes to exactly that.
#define LSQR_FUSED(NAME, KERNEL, S, O)                                          \
  int NAME(const void* data, const void* vec, const void* y, const void* c1,    \
           const void* c2, void* out, void* partial, void* ticket, void* ssq,   \
           const void* offsets, int nd, long long dim_out, long long dim_in,    \
           int slots, void* stream) {                                           \
    const unsigned blocks = reduce_grid(dim_out, slots);                        \
    if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);            \
    KERNEL<S, O><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(  \
            static_cast<const S*>(data), static_cast<const float*>(vec),        \
            static_cast<const float*>(y), static_cast<const float*>(c1),        \
            static_cast<const float*>(c2), static_cast<O*>(out),                \
            static_cast<float*>(partial), static_cast<unsigned int*>(ticket),   \
            static_cast<float*>(ssq), static_cast<const int*>(offsets), nd,     \
            dim_out, dim_in);                                                   \
    return static_cast<int>(cudaGetLastError());                                \
  }

#define LSQR_FUSED_V3(SUFFIX, S, O)                                             \
  int lsqr_dia_fused_halfstep_v3_##SUFFIX(                                      \
      const void* data, const void* vec, const void* y, const void* c1,         \
      const void* c2, void* out, void* partial, const void* offsets, int nd,    \
      long long dim_out, long long dim_in, int slots, void* stream) {           \
    const unsigned blocks = reduce_grid(dim_out, slots);                        \
    if (blocks == 0 || static_cast<long long>(blocks) != slots) {               \
      return static_cast<int>(cudaErrorInvalidValue);                           \
    }                                                                           \
    dia_fused_halfstep_v3_kernel<S, O>                                          \
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(           \
            static_cast<const S*>(data), static_cast<const float*>(vec),        \
            static_cast<const float*>(y), static_cast<const float*>(c1),        \
            static_cast<const float*>(c2), static_cast<O*>(out),                \
            static_cast<float*>(partial), static_cast<const int*>(offsets), nd, \
            dim_out, dim_in);                                                   \
    return static_cast<int>(cudaGetLastError());                                \
  }

LSQR_FUSED(lsqr_dia_fused_halfstep_f32, dia_fused_halfstep_kernel, float, float)
LSQR_FUSED(lsqr_dia_fused_halfstep_v2_f32, dia_fused_halfstep_v2_kernel, float, float)
LSQR_FUSED(lsqr_dia_fused_halfstep_v2_bf16, dia_fused_halfstep_v2_kernel, __nv_bfloat16,
           __nv_bfloat16)
LSQR_FUSED_V3(f32, float, float)
LSQR_FUSED_V3(bf16, __nv_bfloat16, __nv_bfloat16)

#undef LSQR_FUSED
#undef LSQR_FUSED_V3

}  // extern "C"
