// BlockELL products for Hopper (sm_90a): dense (bh, bw) blocks in ELL
// layout (ops/structured.py: BlockELLOperator).
//
// Layout (the JAX package's). blocks (mb, kb, bh, bw) f32, row-major, kb
// blocks per block row (zero blocks pad the short rows); bcols (mb, kb)
// int32 block columns. Block (r, j) covers rows [r*bh, (r+1)*bh) and columns
// [bcols[r,j]*bw, +bw); x is padded to nb*bw, y and u to mb*bh. The adjoint
// takes the transpose packing (tblocks, tbrows) through the same kernels.
//
// Kernels and the TPU kernels they replace (lsqr_tpu/ops/pallas_spmv.py):
//
// 1. block_ell_rows_kernel   <- block_ell_matvec / _block_ell_kernel, and
//                               block_ell_matvec_windowed /
//                               _block_ell_win_kernel
//    y_r = sum_j blocks[r,j] @ x[bcols[r,j]]: each warp streams kRows
//    rows of a block at once straight into registers (one 16-byte load a
//    lane and row, all issued before the products), x segments through
//    __ldg from L1/L2. Both TPU kernels compute this function; the
//    windowed one staged x windows in VMEM, a TPU answer: here x (at most
//    a few MB) lives in L2, and both wrappers launch this kernel through
//    one entry point. Staging the block stream instead, through a ring of
//    bulk asynchronous copies (cp.async.bulk on an mbarrier), lost at three
//    of the four packings the solves take and gained under 2% at the
//    fourth (tools/block_ell_designs.py, PERF.md).
// 2. block_ell_pair_kernel   <- block_ell_pair_windowed /
//                               _block_ell_pair_kernel
//    u_r = sum_j blocks[r,j] @ (x[bcols[r,j]] * c1) - c2 * y_r and the
//    per-block adjoint partials zp[r,j] = blocks[r,j]' @ u_r, one CTA per
//    block row. When the row's blocks fit in shared memory (kb*bh*bw*4
//    bytes and the x segments and u, within 227 KB) they are copied there
//    once and serve both products; otherwise the transposed product reads
//    them a second time, from L2. The caller sums the zp rows by bcols.
//
// What bounds them on the H100: bytes. A matvec does 2 flops per stored
// value (4 bytes): the block stream is the floor (mb*kb*bh*bw*4 bytes, 403
// MB at m = n = 2^18 with 3 blocks per block row), plus x and y. No tensor
// cores: a matvec has no operand reuse for wgmma.
//
// What kernel 1 does about it: enough work units to fill the card and
// enough bytes in flight on each SM. A work unit (one CTA) is a slice of a
// block row's blocks: where mb block rows alone give too few CTAs (a tall
// matrix's transpose: 12 block rows of 164 blocks) the wrapper splits each
// row's kb blocks into S slices (ops/spmv_sparse.py: block_ell_plan; slice
// s covers [s*kb/S, (s+1)*kb/S)), each unit writes its partial y slice to
// scratch, and a second small pass adds a row's S partials in slice order.
// Where S = 1 a unit writes y itself. Sums are in f32, in a fixed order,
// with no atomics: the same bits in every run. Kernel 2 streams its blocks
// with __ldcs (evict-first, so x stays in L2). c1 and c2 are device scalars
// read through pointers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Rows a warp streams at once: 4 was the fastest of 2, 4 and 8 at every
// packing the solves take (tools/block_ell_designs.py)
constexpr int kRows = 4;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_k a[VEC*q + k] * b[VEC*q + k] * scale, a streamed from device memory.
template <int VEC>
__device__ __forceinline__ float dot_stream(const float* a, const float* b, int q,
                                            float scale);

template <>
__device__ __forceinline__ float dot_stream<4>(const float* a, const float* b,
                                               int q, float scale) {
  const float4 av = __ldcs(reinterpret_cast<const float4*>(a) + q);
  const float4 bv = reinterpret_cast<const float4*>(b)[q];
  return av.x * (bv.x * scale) + av.y * (bv.y * scale) + av.z * (bv.z * scale) +
         av.w * (bv.w * scale);
}

template <>
__device__ __forceinline__ float dot_stream<1>(const float* a, const float* b,
                                               int q, float scale) {
  return __ldcs(a + q) * (b[q] * scale);
}

// The same, a from shared memory (16-byte reads: no bank conflicts).
template <int VEC>
__device__ __forceinline__ float dot_shared(const float* a, const float* b, int q,
                                            float scale);

template <>
__device__ __forceinline__ float dot_shared<4>(const float* a, const float* b,
                                               int q, float scale) {
  const float4 av = reinterpret_cast<const float4*>(a)[q];
  const float4 bv = reinterpret_cast<const float4*>(b)[q];
  return av.x * (bv.x * scale) + av.y * (bv.y * scale) + av.z * (bv.z * scale) +
         av.w * (bv.w * scale);
}

template <>
__device__ __forceinline__ float dot_shared<1>(const float* a, const float* b,
                                               int q, float scale) {
  return a[q] * (b[q] * scale);
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Work units: slice s of block row r, blocks [j0, j1)
// ---------------------------------------------------------------------------

struct Unit {
  long long r;
  int s, j0, j1;
};

__device__ __forceinline__ Unit unit_of(int kb, int S) {
  Unit u;
  u.r = blockIdx.x / S;
  u.s = static_cast<int>(blockIdx.x % S);
  u.j0 = static_cast<int>(static_cast<long long>(u.s) * kb / S);
  u.j1 = static_cast<int>(static_cast<long long>(u.s + 1) * kb / S);
  return u;
}

// out[r*bh + i] = sum_s partial[(r*S + s)*bh + i], s = 0, 1, ..., S-1 in
// that order: the row's slices added in a fixed order
__global__ void __launch_bounds__(kThreads) sum_slices_kernel(
    const float* __restrict__ partial, float* __restrict__ out, long long len, int bh,
    int S) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= len) return;
  const long long r = e / bh;
  const float* p = partial + r * S * bh + (e - r * bh);
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += p[static_cast<long long>(s) * bh];
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// 1. the products: kRows rows a warp, straight into registers
// ---------------------------------------------------------------------------

// The unit's y slice, to out + (r*S + s)*bh (y itself where S = 1).
template <int VEC, int R>
__global__ void __launch_bounds__(kThreads) block_ell_rows_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, float* __restrict__ out, int kb, int bh, int bw, int S) {
  const Unit u = unit_of(kb, S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / VEC;
  float* dst = out + (u.r * S + u.s) * bh;
  for (int i0 = warp * R; i0 < bh; i0 += kWarps * R) {
    float acc[R];
#pragma unroll
    for (int t = 0; t < R; ++t) acc[t] = 0.0f;
    for (int j = u.j0; j < u.j1; ++j) {
      const long long rj = u.r * kb + j;
      const float* b0 = blocks + (rj * bh + i0) * bw;
      const float* xs = x + static_cast<long long>(__ldg(bcols + rj)) * bw;
      for (int q = lane; q < nvec; q += 32) {
        if constexpr (VEC == 4) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(xs) + q);
          float4 av[R];
#pragma unroll
          for (int t = 0; t < R; ++t)
            av[t] = i0 + t < bh ? __ldcs(reinterpret_cast<const float4*>(b0 + t * bw) + q)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int t = 0; t < R; ++t)
            acc[t] += av[t].x * xv.x + av[t].y * xv.y + av[t].z * xv.z + av[t].w * xv.w;
        } else {
          const float xv = __ldg(xs + q);
          float av[R];
#pragma unroll
          for (int t = 0; t < R; ++t) av[t] = i0 + t < bh ? __ldcs(b0 + t * bw + q) : 0.0f;
#pragma unroll
          for (int t = 0; t < R; ++t) acc[t] += av[t] * xv;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const float v = warp_sum(acc[t]);
      if (lane == 0 && i0 + t < bh) dst[i0 + t] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. block_ell_pair_windowed: u and the per-block adjoint partials
// ---------------------------------------------------------------------------

template <int VEC, bool KEEP>
__global__ void __launch_bounds__(kThreads) block_ell_pair_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ c1p, const float* __restrict__ c2p,
    float* __restrict__ u, float* __restrict__ zp, int kb, int bh, int bw) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long r = blockIdx.x;
  const long long row_len = static_cast<long long>(kb) * bh * bw;
  const float* brow0 = blocks + r * row_len;
  float* sblk = smem;                               // KEEP: the row's blocks
  float* sx = smem + (KEEP ? row_len : 0);          // KEEP: its x segments
  float* su = sx + (KEEP ? kb * bw : 0);            // u_r
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / VEC;
  const float c1 = *c1p, c2 = *c2p;

  if constexpr (KEEP) {
    for (long long e = threadIdx.x; e < row_len / VEC; e += kThreads)
      cp_async<VEC>(sblk + e * VEC, brow0 + e * VEC);
    for (int e = threadIdx.x; e < kb * nvec; e += kThreads) {
      const int j = e / nvec, q = e - j * nvec;
      const long long c = __ldg(bcols + r * kb + j);
      cp_async<VEC>(sx + j * bw + q * VEC, x + c * bw + q * VEC);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // forward: u_r[i] = sum_j blocks[r,j][i, :] . (x_seg_j * c1) - c2 * y_r[i]
  for (int i = warp; i < bh; i += kWarps) {
    float acc = 0.0f;
    for (int j = 0; j < kb; ++j) {
      if constexpr (KEEP) {
        const float* brow = sblk + (static_cast<long long>(j) * bh + i) * bw;
        for (int q = lane; q < nvec; q += 32)
          acc += dot_shared<VEC>(brow, sx + j * bw, q, c1);
      } else {
        const float* brow = brow0 + (static_cast<long long>(j) * bh + i) * bw;
        const float* xs = x + static_cast<long long>(__ldg(bcols + r * kb + j)) * bw;
        for (int q = lane; q < nvec; q += 32) acc += dot_stream<VEC>(brow, xs, q, c1);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float ui = acc - c2 * y[r * bh + i];
      su[i] = ui;
      u[r * bh + i] = ui;
    }
  }
  __syncthreads();

  // adjoint partials: zp[r, j, c] = sum_i blocks[r,j][i, c] * u_r[i]; a
  // thread per (j, c), neighbouring threads on neighbouring columns
  for (int p = threadIdx.x; p < kb * bw; p += kThreads) {
    const int j = p / bw, c = p - j * bw;
    const float* col = (KEEP ? sblk : brow0) + static_cast<long long>(j) * bh * bw + c;
    float acc = 0.0f;
    for (int i = 0; i < bh; ++i) acc += col[static_cast<long long>(i) * bw] * su[i];
    zp[(r * kb + j) * bw + c] = acc;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int max_smem_attr(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The plan's units (one CTA each) write y, or with S > 1 their partial y
// slices to ``partial``, which the sum pass then adds into y in slice order.
// A packing without blocks gives y = 0.
int rows_product(const void* blocks, const void* bcols, const void* x, void* out,
                 void* partial, int mb, int kb, int bh, int bw, int S, cudaStream_t stream) {
  if (kb == 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(mb) * bh * sizeof(float), stream));
  const bool vec = bw % 4 == 0 && aligned16(blocks) && aligned16(x);
  auto kernel = vec ? block_ell_rows_kernel<4, kRows> : block_ell_rows_kernel<1, kRows>;
  kernel<<<static_cast<unsigned>(static_cast<long long>(mb) * S), kThreads, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(S > 1 ? partial : out), kb, bh, bw,
      S);
  int err = static_cast<int>(cudaGetLastError());
  if (err || S == 1) return err;
  const long long len = static_cast<long long>(mb) * bh;
  sum_slices_kernel<<<static_cast<unsigned>((len + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(static_cast<const float*>(partial), static_cast<float*>(out),
                                len, bh, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both products (ops/spmv_sparse.py: block_ell_matvec and
// block_ell_matvec_windowed). partial: mb*S*bh floats of scratch where
// S > 1 (else unused)
int lsqr_block_ell_matvec_f32(const void* blocks, const void* bcols, const void* x,
                              void* out, void* partial, int mb, int kb, int bh, int bw,
                              int S, void* stream) {
  return rows_product(blocks, bcols, x, out, partial, mb, kb, bh, bw, S,
                      static_cast<cudaStream_t>(stream));
}

int lsqr_block_ell_pair_f32(const void* blocks, const void* bcols, const void* x,
                            const void* y, const void* c1, const void* c2, void* u,
                            void* zp, int mb, int kb, int bh, int bw, int nb, int keep,
                            void* stream) {
  (void)nb;
  const bool vec = bw % 4 == 0 && aligned16(blocks) && aligned16(x);
  void (*kernel)(const float*, const int*, const float*, const float*, const float*,
                 const float*, float*, float*, int, int, int);
  if (keep) kernel = vec ? block_ell_pair_kernel<4, true> : block_ell_pair_kernel<1, true>;
  else kernel = vec ? block_ell_pair_kernel<4, false> : block_ell_pair_kernel<1, false>;
  const size_t smem = sizeof(float) *
      (keep ? static_cast<size_t>(kb) * bh * bw + static_cast<size_t>(kb) * bw + bh
            : static_cast<size_t>(bh));
  const int err = max_smem_attr(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  kernel<<<mb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<float*>(u), static_cast<float*>(zp), kb, bh, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
