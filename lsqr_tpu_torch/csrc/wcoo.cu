// The WCOO products for Hopper (sm_90a): general sparsity with n <= 4096
// (ops/wcoo.py: WCOOOperator, and the hot panel of ops/rwcoo.py).
//
// Replaces lsqr_tpu/ops/pallas_wcoo.py: _call via wcoo_forward,
// wcoo_adjoint and wcoo_pair (_wcoo_kernel).
//
// forward:  u = A(x) c1 - c2 y over the row-sorted copy (vals_r, col_r, gpe);
// adjoint:  z = A' u over the column-sorted copy (vals, idx = col | rowl<<12):
//           two kernels, the blocks' partial z (scratch of blocks x n
//           floats), then their sum in block order; z is bit-identical from
//           run to run;
// pair:     the forward into the padded u, then the adjoint of that u. The
//           TPU kernel fused them to read each chunk's u from VMEM; here u
//           comes back from L2, and each copy of the entries is read once
//           either way, so a fused kernel would save a launch and no bytes.
// The kernels and what bounds them are described in chunked_coo.cuh.

#include "chunked_coo.cuh"

namespace cc = lsqr_chunked_coo;

extern "C" {

int lsqr_wcoo_forward_f32(const void* vals_r, const void* col_r, const void* gpe,
                          const void* x, int n, const void* y, long long y_len,
                          const void* c1, const void* c2, void* u, long long m_pad,
                          int emax, void* stream) {
  return static_cast<int>(cc::launch_forward<false>(
      vals_r, col_r, gpe, nullptr, 0, x, n, y, y_len, c1, c2, u, m_pad, emax,
      static_cast<cudaStream_t>(stream)));
}

int lsqr_wcoo_adjoint_f32(const void* vals, const void* idx, const void* u, long long u_len,
                          void* partials, int blocks, void* z, int n, long long slots,
                          int emax, void* stream) {
  return static_cast<int>(cc::launch_adjoint_partial<12>(
      vals, idx, u, u_len, partials, blocks, z, n, slots, emax,
      static_cast<cudaStream_t>(stream)));
}

int lsqr_wcoo_pair_f32(const void* vals_r, const void* col_r, const void* gpe,
                       const void* vals, const void* idx, const void* x, int n,
                       const void* y, long long y_len, const void* c1, const void* c2,
                       void* u, void* partials, int blocks, void* z, long long m_pad, int emax,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cc::launch_forward<false>(vals_r, col_r, gpe, nullptr, 0, x, n, y,
                                                    y_len, c1, c2, u, m_pad, emax, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = m_pad / cc::kChunkRows * emax;
  return static_cast<int>(cc::launch_adjoint_partial<12>(vals, idx, u, m_pad, partials,
                                                         blocks, z, n, slots, emax, s));
}

}  // extern "C"
