// The JDIA product for Hopper (sm_90a): y = A x for a jittered-diagonal
// packing (ops/jdia.py: JDIAOperator). Both products of the operator launch
// it: the forward one on (data, eoff, base), the adjoint on the transpose
// packing (tdata, teoff, tbase), each with its own p_lo.
//
// Layout (the JAX package's, byte for byte). Rows come in tiles of tm; row
// i of slot s holds the value data[s * m_pad + i] (f32, zero where the slot
// is empty) of the entry in column
//     c = i + base[s * nt_p + i / tm] + JITTER - p_lo + eoff[s * m_pad + i]
// with eoff int8 in [-32, 32] and base the window-relative slot start
// P_lo + d - JITTER of the TPU kernel. The TPU kernel reads c + p_lo of a
// zero-padded copy of x; this one reads x[c] where 0 <= c < n and 0
// elsewhere, which is the same value without the copy. The slots are summed
// in slot order per row.
//
// Replaces lsqr_tpu/ops/pallas_spmv.py: jdia_matvec / _jdia_kernel.
//
// What bounds it on the H100: bytes. Each stored slot value costs 5 bytes
// (4 of data, 1 of eoff) and 2 flops, far below the card's ridge; x and y
// add 4 bytes per column and per row. At m = n = 2^22 with 16 slots:
// ~336 MB of slots, 17 MB per vector.
//
// What the design does about it: the TPU machinery (the double-buffered
// window DMA, aligned block reads, sublane rolls and the three-gather
// select) exists because Mosaic gathers only within one (8, 128) tile; the
// card gathers from any address, so none of it carries over. One thread per
// output row in a grid-stride loop: for each slot a warp reads 32
// neighbouring data and eoff entries (coalesced), and its x reads fall
// within +-32 of one diagonal, so they hit L1 and L2 and x comes from
// device memory about once per slot.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJitter = 32;

__global__ void __launch_bounds__(kThreads) jdia_matvec_kernel(
    const float* __restrict__ data, const int8_t* __restrict__ eoff,
    const int* __restrict__ base, const float* __restrict__ x,
    float* __restrict__ out, int ns, long long m_pad, int nt_p, long long m,
    long long n, int tm, int p_lo) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < m; i += stride) {
    const int t = static_cast<int>(i / tm);
    const long long shift = i + kJitter - p_lo;
    float acc = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const long long at = s * m_pad + i;
      const float v = __ldcs(data + at);
      const long long c = shift + __ldg(base + static_cast<long long>(s) * nt_p + t) +
                          static_cast<long long>(__ldcs(eoff + at));
      const float xv = (c >= 0 && c < n) ? __ldg(x + c) : 0.0f;
      acc += v * xv;
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

int lsqr_jdia_matvec_f32(const void* data, const void* eoff, const void* base,
                         const void* x, void* out, int ns, long long m_pad,
                         int nt_p, long long m, long long n, int tm, int p_lo,
                         void* stream) {
  long long grid = (m + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  if (grid > cap) grid = cap;
  jdia_matvec_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int8_t*>(eoff),
      static_cast<const int*>(base), static_cast<const float*>(x),
      static_cast<float*>(out), ns, m_pad, nt_p, m, n, tm, p_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
