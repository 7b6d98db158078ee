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
//   its grid runs in order on one core; CUDA blocks run in none, so this
//   kernel does what the port's real pairs do (csrc/dia_packed.cu,
//   dia_pair_kernel): the block that owns indices [c0, c0 + T) of u and z
//   computes u for rows [c0 - hi, c0 + T + lo) into shared memory (its
//   own rows also to u), synchronises, and forms z for columns
//   [c0, c0 + T) from shared u. Each z[j] is summed by one thread over the
//   diagonals in a fixed order: no atomics, and the result is the same
//   from run to run. The second half re-reads the stripe rows the first
//   half just read, from L1/L2, so one pass over device memory serves both
//   products plus a (lo + hi)/T share of recomputed rows;
// * one thread per element, a warp reading 32 neighbouring stripe and
//   vector addresses (8-byte float2 loads for the vectors): coalesced;
// * halos above kMaxHalo take two launches, chosen by the wrapper: u alone
//   (zdia_forward_kernel), then z from u in device memory
//   (zdia_adjoint_kernel), as the real pairs' wide-halo route does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;     // T: indices of u and z one pair block owns
constexpr int kMaxHalo = 1024;  // largest lo or hi of the one-pass pair

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
      const float a = __ldg(dr + d * m + r);
      const float b = __ldg(di + d * m + r);
      const float2 w = __ldg(win + c);
      const float xr = w.x * c1;
      const float xi = w.y * c1;
      ur = ur + a * xr - b * xi;
      ui = ui + a * xi + b * xr;
    }
  }
  return make_float2(ur, ui);
}

// acc += conj(A[r, r + k]) u for the stripe element (d, r)
__device__ __forceinline__ void add_conj(float2& acc, const float* __restrict__ dr,
                                         const float* __restrict__ di, long long idx,
                                         float2 u) {
  const float a = __ldg(dr + idx);
  const float b = __ldg(di + idx);
  acc.x += a * u.x + b * u.y;
  acc.y += a * u.y - b * u.x;
}

// One block owns indices [c0, c0 + kTile) of BOTH u (rows) and z
// (columns); the grid covers max(m, n). Dynamic shared memory holds u for
// rows [c0 - hi, c0 + kTile + lo), zero outside [0, m).
__global__ void __launch_bounds__(kThreads) zdia_pair_kernel(
    const float* __restrict__ dr, const float* __restrict__ di,
    const float2* __restrict__ win, const float2* __restrict__ y,
    const float* __restrict__ c1p, const float* __restrict__ c2p,
    float2* __restrict__ u, float2* __restrict__ z,
    const int* __restrict__ offsets, int nd, long long m, long long n, int lo,
    int hi) {
  extern __shared__ float2 u_s[];
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const int span = kTile + lo + hi;

  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long long r = c0 - hi + t;
    float2 acc = make_float2(0.0f, 0.0f);
    if (r >= 0 && r < m) {
      acc = zdia_row(dr, di, win, y, c1, c2, offsets, nd, r, m, n);
      if (t >= hi && t < hi + kTile) u[r] = acc;
    }
    u_s[t] = acc;
  }
  __syncthreads();
  // z[j] from rows j - k, at t + hi - k in u_s: inside [0, span) since
  // -lo <= k <= hi
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const long long j = c0 + t;
    if (j >= n) break;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int d = 0; d < nd; ++d) {
      const int k = __ldg(offsets + d);
      const long long r = j - k;
      if (r >= 0 && r < m) add_conj(acc, dr, di, d * m + r, u_s[t + hi - k]);
    }
    z[j] = acc;
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
      if (r >= 0 && r < m) add_conj(acc, dr, di, d * m + r, __ldg(u + r));
    }
    z[j] = acc;
  }
}

inline unsigned grid_for(long long count) {
  long long g = (count + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned>(g < cap ? g : cap);
}

}  // namespace

extern "C" {

// mode 0: the one-pass pair (lo, hi <= kMaxHalo); 1: u alone; 2: z from u.
int lsqr_zdia_pair_f32(const void* dr, const void* di, const void* win,
                       const void* y, const void* c1, const void* c2, void* u,
                       void* z, const void* offsets, int nd, long long m,
                       long long n, int lo, int hi, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pr = static_cast<const float*>(dr);
  const auto* pi = static_cast<const float*>(di);
  const auto* off = static_cast<const int*>(offsets);
  if (m < 0 || n < 0 || lo < 0 || hi < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    if (lo > kMaxHalo || hi > kMaxHalo) return static_cast<int>(cudaErrorInvalidValue);
    const long long dim = m > n ? m : n;
    const unsigned blocks = static_cast<unsigned>((dim + kTile - 1) / kTile);
    const size_t smem = sizeof(float2) * static_cast<size_t>(kTile + lo + hi);
    if (blocks == 0) return 0;
    zdia_pair_kernel<<<blocks, kThreads, smem, s>>>(
        pr, pi, static_cast<const float2*>(win), static_cast<const float2*>(y),
        static_cast<const float*>(c1), static_cast<const float*>(c2),
        static_cast<float2*>(u), static_cast<float2*>(z), off, nd, m, n, lo, hi);
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
