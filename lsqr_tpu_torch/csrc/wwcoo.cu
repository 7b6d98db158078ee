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
// recovered colc from its emission tables ep; those and the work lists of
// compaction, gather, emission and expansion are not kept, and zexp only in
// the compact form below.
//
// The adjoint follows the TPU kernel's order without its tables: each
// chunk's runs are compacted into a zc per (chunk, split) in shared memory
// (partials, scratch the wrapper allocates by lsqr_wwcoo_adjoint_plan),
// then each column's zc entries are expanded into z in chunk order through
// the inverse of colmap (zptr, zsrc; ops/wwcoo.py: column_lists), the
// port's compact form of the TPU kernel's zexp tables. No float atomics: z
// is bit-identical from run to run.
//
// pair: the forward into the padded u, then the adjoint of that u (as in
// csrc/wcoo.cu). The kernels and what bounds them are described in
// chunked_coo.cuh.

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

// plan (4 ints out): groups, window size, windows, splits (chunked_coo.cuh)
int lsqr_wwcoo_adjoint_plan(int d_pad, int eb, long long nc, int* plan) {
  return static_cast<int>(cc::compact_plan(d_pad, eb, nc, plan));
}

int lsqr_wwcoo_adjoint_f32(const void* vals, const void* cidx, int d_pad, const void* zptr,
                           const void* zsrc, const void* u, long long u_len,
                           void* partials, int groups, int wsize, int windows, int splits,
                           void* z, int n, long long slots, int emax, void* stream) {
  return static_cast<int>(cc::launch_adjoint_compact<18>(
      vals, cidx, zptr, zsrc, d_pad, u, u_len, partials, groups, wsize, windows, splits, z, n,
      slots, emax, static_cast<cudaStream_t>(stream)));
}

int lsqr_wwcoo_pair_f32(const void* vals_r, const void* col_r, const void* gpe,
                        const void* vals, const void* cidx, const void* colmap, int d_pad,
                        const void* zptr, const void* zsrc, const void* x, int n,
                        const void* y, long long y_len, const void* c1, const void* c2,
                        void* u, void* partials, int groups, int wsize, int windows,
                        int splits, void* z, long long m_pad, int emax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cc::launch_forward<true>(vals_r, col_r, gpe, colmap, d_pad, x, n,
                                                   y, y_len, c1, c2, u, m_pad, emax, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = m_pad / cc::kChunkRows * emax;
  return static_cast<int>(cc::launch_adjoint_compact<18>(vals, cidx, zptr, zsrc, d_pad, u,
                                                          m_pad, partials, groups, wsize,
                                                          windows, splits, z, n, slots, emax,
                                                          s));
}

}  // extern "C"
