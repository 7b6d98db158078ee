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
// 1. dia_product_shared_kernel   <- dia_product_shared / _dia_shared_kernel
//    y = A x or x = A' y (f64 products on the card come here).
// 2. dia_shared_axpy_kernel      <- dia_product_shared_axpy /
//                                   _dia_shared_axpy_kernel
//    (A or A')(vec * c1) - c2 * y: the pair=False half-step.
// 3. dia_pair_kernel (staged)    <- dia_pair_shared /
//    dia_pair_shared_kernel          _dia_pair_shared_kernel_carry
//    u = A(vec * c1) - c2 * y and z = A' u in one pass: the staged pair of
//    csrc/dia_pair_staged.cuh on this layout (row stride Lp, row base H),
//    or, where no staged tile fits (many diagonals), the unstaged kernel.
//
// What bounds them on the H100: bytes. Each does ~2 flops per stripe
// element it reads (4 bytes, 2 in bf16), far below the card's ~20 flop/byte
// ridge, so the floor is device-memory traffic: the stripes (nd * dim * 4
// bytes, half that in bf16) plus 2 (product), 3 (axpy) or 4 (pair) f32
// vectors. At m = n = 2^23 with 11 diagonals that is 369 MB of f32 stripes
// against 67-134 MB of vectors.
//
// What the design does about it:
// * one thread per output element in a grid-stride loop; for each diagonal
//   a warp reads 32 neighbouring dp addresses and 32 neighbouring vector
//   addresses, so every load is coalesced and every stripe byte is read
//   from device memory once per product;
// * the pair replaces the TPU's carry scheme (z block t-1 written at grid
//   step t, which needs grid steps in order) by halo recompute. Its main
//   route is the staged pair (csrc/dia_pair_staged.cuh): one-sided halos
//   lo = max(0, -k_min), hi = max(0, k_max) (not H on both sides), each
//   tile's stripe rows [c0 - hi, c0 + T + lo) staged in shared memory by
//   16-byte cp.async copies (in this layout they are one window of each
//   stripe row, whose 16-byte phase is H % V for every diagonal, since Lp
//   is a multiple of 1024), a persistent grid two stages deep. Where no
//   tile's two stages fit (many diagonals), the unstaged kernel below: a
//   block owning indices [r0, r0 + T) computes u for rows
//   [r0 - H, r0 + T + H) into shared memory, writes its own rows of u,
//   synchronises, and forms z for its columns from shared u, reading the
//   stripes again (from L1/L2). Both sum in the same order: the same bits.
//   No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_pair_staged.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairTile = 1024;  // T: output indices one unstaged pair block owns

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

// The unstaged pair. One block owns indices [r0, r0 + kPairTile) of BOTH u
// (rows) and z (columns); the grid covers max(m, n). Dynamic shared memory
// holds u for rows [r0 - H, r0 + kPairTile + H), zero outside [0, m).
template <typename S>
__global__ void dia_pair_shared_kernel(
    const S* __restrict__ dp, const float* __restrict__ vec,
    const float* __restrict__ y, const float* __restrict__ c1p,
    const float* __restrict__ c2p, float* __restrict__ u,
    float* __restrict__ z, const int* __restrict__ offsets, int nd,
    long long Lp, int H, long long m, long long n) {
  extern __shared__ float u_s[];
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long r0 = static_cast<long long>(blockIdx.x) * kPairTile;
  const int span = kPairTile + 2 * H;

  // 1-2. u for the tile and its halo; the tile's own rows go to u.
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long long r = r0 - H + t;
    float acc = 0.0f;
    if (r >= 0 && r < m) {
      acc = (-c2) * __ldg(y + r);
      for (int d = 0; d < nd; ++d) {
        const int k = __ldg(offsets + d);
        const long long c = r + k;
        if (c >= 0 && c < n) {
          acc += widen(dp + d * Lp + H + r) * (__ldg(vec + c) * c1);
        }
      }
      if (t >= H && t < H + kPairTile) u[r] = acc;
    }
    u_s[t] = acc;
  }
  // 3.
  __syncthreads();
  // 4. z[j] = sum_d dp[d*Lp + H + j - k] * u[j - k]; row j - k sits at
  // t + H - k in u_s, inside [0, span) for every |k| <= H. Stripe rows
  // outside [0, m) are zero padding, and so is u_s there.
  for (int t = threadIdx.x; t < kPairTile; t += blockDim.x) {
    const long long j = r0 + t;
    if (j >= n) break;
    float acc = 0.0f;
    for (int d = 0; d < nd; ++d) {
      const int k = __ldg(offsets + d);
      acc += widen(dp + d * Lp + H + j - k) * u_s[t + H - k];
    }
    z[j] = acc;
  }
}

template <typename S, typename V>
int launch_product(const void* dp, const void* vec, void* out,
                   const void* offsets, int nd, long long Lp, int H,
                   long long dim_out, long long dim_in, int adjoint,
                   void* stream) {
  dia_product_shared_kernel<S, V>
      <<<grid_for(dim_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const S*>(dp), static_cast<const V*>(vec),
          static_cast<V*>(out), static_cast<const int*>(offsets), nd, Lp, H,
          dim_out, dim_in, adjoint);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_axpy(const void* dp, const void* vec, const void* y, const void* c1,
                const void* c2, void* out, const void* offsets, int nd,
                long long Lp, int H, long long dim_out, long long dim_in,
                int adjoint, void* stream) {
  dia_shared_axpy_kernel<S>
      <<<grid_for(dim_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const S*>(dp), static_cast<const float*>(vec),
          static_cast<const float*>(y), static_cast<const float*>(c1),
          static_cast<const float*>(c2), static_cast<float*>(out),
          static_cast<const int*>(offsets), nd, Lp, H, dim_out, dim_in,
          adjoint);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_pair(const void* dp, const void* vec, const void* y, const void* c1,
                const void* c2, void* u, void* z, const void* offsets, int nd,
                long long Lp, int H, long long m, long long n, void* stream) {
  if (H < 0 || H > kPairMaxHalo) return static_cast<int>(cudaErrorInvalidValue);
  const long long dim = m > n ? m : n;
  const unsigned blocks = static_cast<unsigned>((dim + kPairTile - 1) / kPairTile);
  const size_t smem = sizeof(float) * static_cast<size_t>(kPairTile + 2 * H);
  dia_pair_shared_kernel<S><<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dp), static_cast<const float*>(vec),
      static_cast<const float*>(y), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<float*>(u),
      static_cast<float*>(z), static_cast<const int*>(offsets), nd, Lp, H, m,
      n);
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
      void* stream) {                                                           \
    return launch_product<S, V>(dp, vec, out, offsets, nd, Lp, H, dim_out,      \
                                dim_in, adjoint, stream);                       \
  }

#define LSQR_AXPY(SUFFIX, S)                                                    \
  int lsqr_dia_shared_axpy_##SUFFIX(                                            \
      const void* dp, const void* vec, const void* y, const void* c1,           \
      const void* c2, void* out, const void* offsets, int nd, long long Lp,     \
      int H, long long dim_out, long long dim_in, int adjoint, void* stream) {  \
    return launch_axpy<S>(dp, vec, y, c1, c2, out, offsets, nd, Lp, H,          \
                          dim_out, dim_in, adjoint, stream);                    \
  }

#define LSQR_PAIR(SUFFIX, S)                                                    \
  int lsqr_dia_pair_shared_##SUFFIX(                                            \
      const void* dp, const void* vec, const void* y, const void* c1,           \
      const void* c2, void* u, void* z, const void* offsets, int nd,            \
      long long Lp, int H, long long m, long long n, void* stream) {            \
    return launch_pair<S>(dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n,   \
                          stream);                                              \
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
