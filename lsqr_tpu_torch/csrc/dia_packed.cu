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
// 1. dia_product_staged_kernel  <- dia_matvec / _dia_kernel
//    (dia_matvec_kernel where
//    no tile fits, and for f64)
//    y = A x on data (or A' y on tdata); the column mode gives A' u from
//    data, for the pair's wide-halo route: the staged product of
//    csrc/dia_product_staged.cuh on this layout (row stride m, or n for
//    tdata; row base 0).
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
// * the product (kernel 1) streams: a persistent grid stages tiles of T
//   outputs (each diagonal's stripe piece at its own 16-byte phase where m
//   is not a multiple of 16 bytes' worth, and the vector window) in shared
//   memory by cp.async, two stages deep (csrc/dia_product_staged.cuh); T
//   from ops/spmv.py: product_tile. Where T is 0 (a vector window too wide
//   for any tile) and for f64 stripes, the direct kernel below;
// * the others run one thread per output element in a grid-stride loop: for
//   each diagonal a warp reads 32 neighbouring stripe and vector addresses,
//   so every load is coalesced and each stripe byte comes from device
//   memory once;
// * the fused half-step's norm is reduced in the same pass, without float
//   atomics: each block writes its partial sum to a scratch slot, and the
//   last block to finish (an integer ticket after __threadfence) sums the
//   slots in a fixed order and resets the ticket. The result does not
//   depend on block timing. The grid is capped at kReduceBlocks so that
//   sum stays short. v3 leaves that sum to the wrapper (one more small
//   launch, torch.sum over at most kReduceBlocks floats, also in a fixed
//   order); the norm is of the f32 sums, before a bf16 out is rounded;
// * the pair (kernel 4) is the staged pair of csrc/dia_pair_staged.cuh on
//   the packed layout (row stride m, row base 0): one-sided halos
//   recomputed, each tile's stripe rows, x window and y rows staged in
//   shared memory by cp.async, a persistent grid two stages deep; where no
//   tile fits (pair_tile), or a halo exceeds kPairMaxHalo, the wrapper takes
//   two launches (kernel 2, then kernel 1's column mode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_pair_staged.cuh"
#include "dia_product_staged.cuh"

namespace {

constexpr int kThreads = 256;
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

// The product: the staged kernel in tiles of T (ops/spmv.py: product_tile;
// lo = max(0, -k_min), hi = max(0, k_max) of these offsets; data and vec
// 16-byte aligned; f32 and bf16 stripes), or the direct kernel where T is 0.
template <typename S, typename V>
int launch_matvec(const void* data, const void* vec, void* out,
                  const void* offsets, int nd, long long dim_out,
                  long long dim_in, int column, int lo, int hi, int T,
                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    dia_matvec_kernel<S, V><<<grid_for(dim_out), kThreads, 0, s>>>(
        static_cast<const S*>(data), static_cast<const V*>(vec),
        static_cast<V*>(out), static_cast<const int*>(offsets), nd, dim_out,
        dim_in, column);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (sizeof(V) != 4) {
    return static_cast<int>(cudaErrorInvalidValue);  // f64 takes the direct kernel
  } else {
    const long long row_len = column ? dim_in : dim_out;
    return launch_product_staged<S>(data, nd * row_len, row_len, 0, vec, out, offsets, nd,
                                    dim_out, dim_in, column, lo, hi, T, s);
  }
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


}  // namespace

extern "C" {

#define LSQR_MATVEC(SUFFIX, S, V)                                               \
  int lsqr_dia_matvec_##SUFFIX(const void* data, const void* vec, void* out,    \
                               const void* offsets, int nd, long long dim_out,  \
                               long long dim_in, int column, int lo, int hi,    \
                               int T, void* stream) {                           \
    return launch_matvec<S, V>(data, vec, out, offsets, nd, dim_out, dim_in,    \
                               column, lo, hi, T, stream);                      \
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
    return launch_pair_staged<S>(data, m, 0, vec, y, c1, c2, u, z, offsets, nd, \
                                 m, n, lo, hi, T, stream);                      \
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
