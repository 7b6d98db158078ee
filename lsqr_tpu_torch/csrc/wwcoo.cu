// The WWCOO products for Hopper (sm_90a): general sparsity with
// n <= 262,144 on per-chunk compacted columns (ops/wwcoo.py: WWCOOOperator,
// and the cold stream of ops/rwcoo.py).
//
// Replaces lsqr_tpu/ops/pallas_wwcoo.py: _call via wwcoo_forward,
// wwcoo_adjoint and wwcoo_pair (_wwcoo_kernel).
//
// Each chunk stores its columns compacted: col_r holds a position in the
// chunk's sorted column list colmap (d_pad entries, padded with n_pad, which
// is out of range and masked). The forward reads x[colmap[t, col_r]]. The
// adjoint's column-sorted copy keeps the JAX package's vals, and in place of
// its rowl plane reads cidx = colc | rowl << 18 (unsigned), colc the compacted
// column of the slot: the column-sorted col_r of each subtile, which the host
// derives once from col_r (ops/wwcoo.py: column_index). The TPU kernel
// recovered colc from its emission tables ep; those, zexp and the work lists
// of compaction, gather, emission and expansion are not kept.
//
// pair: the forward into the padded u, then the adjoint of that u (two
// kernels, as in csrc/wcoo.cu). The kernels and what bounds them are
// described in chunked_coo.cuh.

#include "chunked_coo.cuh"

namespace cc = lsqr_chunked_coo;

extern "C" {

int lsqr_wwcoo_forward_f32(const void* vals_r, const void* col_r, const void* gpe,
                           const void* colmap, int d_pad, const void* x, int n,
                           const void* y, long long y_len, const void* c1, const void* c2,
                           void* u, long long m_pad, int emax, void* stream) {
  return static_cast<int>(cc::launch_forward<true>(
      vals_r, col_r, gpe, colmap, d_pad, x, n, y, y_len, c1, c2, u, m_pad, emax,
      static_cast<cudaStream_t>(stream)));
}

int lsqr_wwcoo_adjoint_f32(const void* vals, const void* cidx, const void* colmap, int d_pad,
                           const void* u, long long u_len, void* z, int n, long long slots,
                           int emax, void* stream) {
  return static_cast<int>(cc::launch_adjoint_atomic<18>(
      vals, cidx, colmap, d_pad, u, u_len, z, n, slots, emax,
      static_cast<cudaStream_t>(stream)));
}

int lsqr_wwcoo_pair_f32(const void* vals_r, const void* col_r, const void* gpe,
                        const void* vals, const void* cidx, const void* colmap, int d_pad,
                        const void* x, int n, const void* y, long long y_len,
                        const void* c1, const void* c2, void* u, void* z, long long m_pad,
                        int emax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cc::launch_forward<true>(vals_r, col_r, gpe, colmap, d_pad, x, n,
                                                   y, y_len, c1, c2, u, m_pad, emax, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = m_pad / cc::kChunkRows * emax;
  return static_cast<int>(cc::launch_adjoint_atomic<18>(vals, cidx, colmap, d_pad, u, m_pad, z,
                                                          n, slots, emax, s));
}

}  // extern "C"
