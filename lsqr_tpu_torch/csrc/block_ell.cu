// BlockELL products for Hopper (sm_90a): dense (bh, bw) blocks in ELL
// layout (ops/structured.py: BlockELLOperator).
//
// Layout (the JAX package's). blocks (mb, kb, bh, bw) f32, row-major, kb
// blocks per block row (zero blocks pad the short rows); bcols (mb, kb)
// int32 block columns. Block (r, j) covers rows [r*bh, (r+1)*bh) and columns
// [bcols[r,j]*bw, +bw); x is padded to nb*bw, y and u to mb*bh.
//
// Kernels and the TPU kernels they replace (lsqr_tpu/ops/pallas_spmv.py):
//
// 1. block_ell_matvec_kernel   <- block_ell_matvec / _block_ell_kernel
//    y_r = sum_j blocks[r,j] @ x[bcols[r,j]]; one CTA per block row, the x
//    segments read from global memory (L1/L2).
// 2. block_ell_win_kernel      <- block_ell_matvec_windowed /
//                                 _block_ell_win_kernel
//    The same function in the TPU kernel's design: persistent CTAs walk
//    tiles of tr block rows, and each tile's tr*kb x segments are staged in
//    shared memory with cp.async, double-buffered, so the next tile's
//    copies fly while this one computes.
// 3. block_ell_pair_kernel     <- block_ell_pair_windowed /
//                                 _block_ell_pair_kernel
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
// What the designs do about it: the blocks are row-major, so a warp walks
// one block row along bw with 16-byte loads (lane l takes columns 4l..4l+3,
// 128 columns per warp step) and reduces with shuffles; every block byte
// comes from device memory once (streamed with __ldcs, evict-first, so x
// stays in L2). Sums are in f32, in a fixed order (no atomics):
// deterministic. c1 and c2 are device scalars read through pointers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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
// 1. block_ell_matvec: one CTA per block row, x from global memory
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(kThreads) block_ell_matvec_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, float* __restrict__ out, int kb, int bh, int bw) {
  const long long r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / VEC;
  for (int i = warp; i < bh; i += kWarps) {
    float acc = 0.0f;
    for (int j = 0; j < kb; ++j) {
      const long long c = __ldg(bcols + r * kb + j);
      const float* brow = blocks + ((r * kb + j) * bh + i) * bw;
      const float* xs = x + c * bw;
      for (int q = lane; q < nvec; q += 32) {
        if constexpr (VEC == 4) {
          const float4 av = __ldcs(reinterpret_cast<const float4*>(brow) + q);
          const float4 bv = __ldg(reinterpret_cast<const float4*>(xs) + q);
          acc += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
        } else {
          acc += __ldcs(brow + q) * __ldg(xs + q);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[r * bh + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. block_ell_matvec_windowed: tiles of tr block rows, x segments staged
//    in shared memory with cp.async, double-buffered across tiles
// ---------------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void stage_tile(float* buf, const int* __restrict__ bcols,
                                           const float* __restrict__ x, long long r0,
                                           int tr, int kb, int bw) {
  const int nvec = bw / VEC;
  const int count = tr * kb * nvec;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int rj = e / nvec, q = e - rj * nvec;  // rj = r_local * kb + j
    const long long c = __ldg(bcols + r0 * kb + rj);
    cp_async<VEC>(buf + rj * bw + q * VEC, x + c * bw + q * VEC);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) block_ell_win_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, float* __restrict__ out, int kb, int bh, int bw,
    int tr, int nt) {
  extern __shared__ float4 smem4[];
  float* bufs[2] = {reinterpret_cast<float*>(smem4),
                    reinterpret_cast<float*>(smem4) + tr * kb * bw};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / VEC;
  int t = blockIdx.x;
  if (t >= nt) return;
  stage_tile<VEC>(bufs[0], bcols, x, static_cast<long long>(t) * tr, tr, kb, bw);
  cp_async_commit();
  for (int s = 0; t < nt; t += gridDim.x, s ^= 1) {
    const int next = t + gridDim.x;
    if (next < nt)
      stage_tile<VEC>(bufs[s ^ 1], bcols, x, static_cast<long long>(next) * tr, tr, kb, bw);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>(); // every group but the newest: this tile's segments
    __syncthreads();
    const float* buf = bufs[s];
    const long long r0 = static_cast<long long>(t) * tr;
    for (int q0 = warp; q0 < tr * bh; q0 += kWarps) {
      const int rl = q0 / bh, i = q0 - rl * bh;
      const long long r = r0 + rl;
      float acc = 0.0f;
      for (int j = 0; j < kb; ++j) {
        const float* brow = blocks + ((r * kb + j) * bh + i) * bw;
        const float* xs = buf + (rl * kb + j) * bw;
        for (int q = lane; q < nvec; q += 32) acc += dot_stream<VEC>(brow, xs, q, 1.0f);
      }
      acc = warp_sum(acc);
      if (lane == 0) out[r * bh + i] = acc;
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// 3. block_ell_pair_windowed: u and the per-block adjoint partials
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

}  // namespace

extern "C" {

int lsqr_block_ell_matvec_f32(const void* blocks, const void* bcols, const void* x,
                              void* out, int mb, int kb, int bh, int bw, int nb,
                              void* stream) {
  (void)nb;
  const bool vec = bw % 4 == 0 && aligned16(blocks) && aligned16(x);
  auto kernel = vec ? block_ell_matvec_kernel<4> : block_ell_matvec_kernel<1>;
  kernel<<<mb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(out), kb, bh, bw);
  return static_cast<int>(cudaGetLastError());
}

int lsqr_block_ell_matvec_windowed_f32(const void* blocks, const void* bcols,
                                       const void* x, void* out, int mb, int kb,
                                       int bh, int bw, int nb, int tr, void* stream) {
  (void)nb;
  const bool vec = bw % 4 == 0 && aligned16(blocks) && aligned16(x);
  auto kernel = vec ? block_ell_win_kernel<4> : block_ell_win_kernel<1>;
  const size_t smem = 2ull * tr * kb * bw * sizeof(float);
  int err = max_smem_attr(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)))
    return err;
  const int nt = mb / tr;
  long long grid = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > nt) grid = nt;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(out), kb, bh, bw, tr, nt);
  return static_cast<int>(cudaGetLastError());
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
