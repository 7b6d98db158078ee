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
//    per-block adjoint partials zp[r,j] = blocks[r,j]' @ u_r. A cluster of
//    `ranks` CTAs (at most 8, the portable cluster size) per block row;
//    rank s holds the row's blocks [s*kb/ranks, (s+1)*kb/ranks) (one each
//    where kb <= 8). When a rank's blocks fit in shared memory (beside
//    their x segments, its partial u_r and u_r) it copies them there once,
//    in row chunks whose products start while the later chunks land, and
//    serves both products from that copy; otherwise the transposed product
//    reads them a second time, from L2. Each rank forms its partial u_r
//    from its own blocks; the ranks' partials are added in rank order
//    through distributed shared memory, so every rank holds the same u_r
//    and forms zp for its own blocks. The caller sums the zp rows by bcols
//    (ops/spmv_sparse.py: block_ell_pair_plan gives ranks and the rule).
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
// with no atomics: the same bits in every run. c1 and c2 are device
// scalars read through pointers.
//
// What kernel 2 does about it: one CTA holding a whole block row (198,656
// bytes at kb = 3 and 128 x 128) would be alone on its SM, its loads and
// products unable to overlap. A rank holds kb/ranks blocks (67 KB there):
// three CTAs an SM, one rank's copies in flight while another multiplies,
// and every block byte crosses from device memory once.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Rows a warp streams at once: 4 was the fastest of 2, 4 and 8 at every
// packing the solves take (tools/block_ell_designs.py)
constexpr int kRows = 4;
constexpr int kWarps = kThreads / 32;
// Row chunks a pair rank's copy is committed in: its forward product
// starts on the first chunk while the others land
constexpr int kPairChunks = 4;

namespace cg = cooperative_groups;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_k a[VEC*q + k] * b[VEC*q + k] * scale, a from device memory (kept in
// L2: the pair's transposed product reads it again)
template <int VEC>
__device__ __forceinline__ float dot_global(const float* a, const float* b, int q,
                                            float scale);

template <>
__device__ __forceinline__ float dot_global<4>(const float* a, const float* b,
                                               int q, float scale) {
  const float4 av = __ldg(reinterpret_cast<const float4*>(a) + q);
  const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + q);
  return av.x * (bv.x * scale) + av.y * (bv.y * scale) + av.z * (bv.z * scale) +
         av.w * (bv.w * scale);
}

template <>
__device__ __forceinline__ float dot_global<1>(const float* a, const float* b,
                                               int q, float scale) {
  return __ldg(a + q) * (__ldg(b + q) * scale);
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

// cp.async.wait_group with a count known at run time (< kPairChunks)
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<kPairChunks - 1>(); break;
  }
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

// Block row r = blockIdx.x / ranks, rank s = its place in the cluster.
// Shared memory, the same layout in every rank (G = ceil(kb / ranks)
// blocks at most): KEEP: G blocks and G x segments; then the rank's
// partial u_r and u_r (bh floats each).
template <int VEC, bool KEEP>
__global__ void __launch_bounds__(kThreads) block_ell_pair_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ c1p, const float* __restrict__ c2p,
    float* __restrict__ u, float* __restrict__ zp, int kb, int bh, int bw, int ranks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());
  const long long r = blockIdx.x / ranks;
  const int j0 = static_cast<int>(static_cast<long long>(s) * kb / ranks);
  const int nj = static_cast<int>(static_cast<long long>(s + 1) * kb / ranks) - j0;
  const int G = (kb + ranks - 1) / ranks;
  const long long blk = static_cast<long long>(bh) * bw;
  const float* brow0 = blocks + (r * kb + j0) * blk;  // the rank's first block
  float* sblk = smem;                                 // KEEP: the rank's blocks
  float* sx = smem + (KEEP ? G * blk : 0);            // KEEP: their x segments
  float* spart = sx + (KEEP ? G * bw : 0);            // the rank's partial u_r
  float* su = spart + bh;                             // u_r
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / VEC;
  const float c1 = *c1p, c2 = *c2p;

  if constexpr (KEEP) {  // chunk g: rows [g*bh/kPairChunks, (g+1)*bh/kPairChunks) of each block
    for (int g = 0; g < kPairChunks; ++g) {
      const int i0 = g * bh / kPairChunks, len = ((g + 1) * bh / kPairChunks - i0) * nvec;
      for (int e = threadIdx.x; e < nj * len; e += kThreads) {
        const int jj = e / len, q = e - jj * len;
        const long long off = jj * blk + static_cast<long long>(i0) * bw + q * VEC;
        cp_async<VEC>(sblk + off, brow0 + off);
      }
      if (g == 0) {
        for (int e = threadIdx.x; e < nj * nvec; e += kThreads) {
          const int jj = e / nvec, q = e - jj * nvec;
          const long long c = __ldg(bcols + r * kb + j0 + jj);
          cp_async<VEC>(sx + jj * bw + q * VEC, x + c * bw + q * VEC);
        }
      }
      cp_async_commit();
    }
  }

  // the rank's partial: spart[i] = sum over its blocks j of
  // blocks[r,j][i, :] . (x_seg_j * c1), chunk by chunk as the copies land
  for (int g = 0; g < kPairChunks; ++g) {
    const int i0 = g * bh / kPairChunks, i1 = (g + 1) * bh / kPairChunks;
    if constexpr (KEEP) {
      cp_async_wait_upto(kPairChunks - 1 - g);
      __syncthreads();
    }
    for (int i = i0 + warp; i < i1; i += kWarps) {
      float acc = 0.0f;
      for (int jj = 0; jj < nj; ++jj) {
        if constexpr (KEEP) {
          const float* brow = sblk + jj * blk + static_cast<long long>(i) * bw;
          for (int q = lane; q < nvec; q += 32) acc += dot_shared<VEC>(brow, sx + jj * bw, q, c1);
        } else {
          const float* brow = brow0 + jj * blk + static_cast<long long>(i) * bw;
          const float* xs = x + static_cast<long long>(__ldg(bcols + r * kb + j0 + jj)) * bw;
          for (int q = lane; q < nvec; q += 32) acc += dot_global<VEC>(brow, xs, q, c1);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) spart[i] = acc;
    }
  }
  cluster.sync();  // every rank's partial is in its shared memory

  // u_r[i] = the ranks' partials added in rank order - c2 * y_r[i], in
  // every rank; rank 0 writes u
  for (int i = threadIdx.x; i < bh; i += kThreads) {
    float acc = *cluster.map_shared_rank(spart + i, 0);
    for (int t = 1; t < ranks; ++t) acc += *cluster.map_shared_rank(spart + i, t);
    const float ui = acc - c2 * y[r * bh + i];
    su[i] = ui;
    if (s == 0) u[r * bh + i] = ui;
  }
  cluster.sync();  // no rank reads another's partial after this; su is complete

  // adjoint partials of the rank's blocks: zp[r, j, c] = sum_i
  // blocks[r,j][i, c] * u_r[i]; a thread per (j, c), neighbouring threads
  // on neighbouring columns
  for (int p = threadIdx.x; p < nj * bw; p += kThreads) {
    const int jj = p / bw, c = p - jj * bw;
    const float* col = (KEEP ? sblk : brow0) + jj * blk + c;
    float acc = 0.0f;
    for (int i = 0; i < bh; ++i) acc += col[static_cast<long long>(i) * bw] * su[i];
    zp[(r * kb + j0 + jj) * bw + c] = acc;
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

// The pair: a cluster of `ranks` (1 to 8, at most kb where kb > 0) CTAs
// per block row (ops/spmv_sparse.py: block_ell_pair_plan); keep: each
// rank holds its blocks in shared memory.
int lsqr_block_ell_pair_f32(const void* blocks, const void* bcols, const void* x,
                            const void* y, const void* c1, const void* c2, void* u,
                            void* zp, int mb, int kb, int bh, int bw, int ranks, int keep,
                            void* stream) {
  if (ranks < 1 || ranks > 8 || (kb > 0 && ranks > kb))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = bw % 4 == 0 && aligned16(blocks) && aligned16(x);
  void (*kernel)(const float*, const int*, const float*, const float*, const float*,
                 const float*, float*, float*, int, int, int, int);
  if (keep) kernel = vec ? block_ell_pair_kernel<4, true> : block_ell_pair_kernel<1, true>;
  else kernel = vec ? block_ell_pair_kernel<4, false> : block_ell_pair_kernel<1, false>;
  const size_t G = static_cast<size_t>((kb + ranks - 1) / ranks);
  const size_t smem = sizeof(float) *
      ((keep ? G * bh * bw + G * bw : 0) + 2 * static_cast<size_t>(bh));
  int err = max_smem_attr(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(mb) * ranks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<float*>(u), static_cast<float*>(zp), kb, bh, bw, ranks));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
