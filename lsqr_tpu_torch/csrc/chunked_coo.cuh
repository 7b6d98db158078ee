// The two products of the chunked COO layouts (WCOO and WWCOO) for Hopper
// (sm_90a); csrc/wcoo.cu and csrc/wwcoo.cu instantiate them.
//
// Layout (the JAX package's, byte for byte; ops/wcoo.py, ops/wwcoo.py). The
// rows come in chunks of CR = 16384; chunk t holds its entries in slots
// [t * emax, (t + 1) * emax), emax a multiple of 1024, twice:
//   row-sorted:    vals_r (f32) and col_r (int32: the column, or for WWCOO
//                  its position in the chunk's sorted column list colmap);
//                  gpe[t * CR + r] is the last slot of rows <= r (-1 before
//                  the first entry), capped at the chunk's last entry, so
//                  row r owns the slots (gpe[r - 1], gpe[r]] and the zero
//                  padding behind the last entry belongs to no row;
//   column-sorted: vals (f32) and idx = col | rowlocal << kShift, sorted by
//                  column within each 1024-slot subtile (WCOO: the column,
//                  kShift = 12; WWCOO: the colmap position, kShift = 18,
//                  unsigned). Padding slots hold 0.
//
// forward (the row-sorted copy): u[t*CR + r] = c1 * sum vals_r[e] x[col(e)]
//   over the row's slots - c2 * y[t*CR + r] (y read as 0 past y_len). This is
//   plain CSR: one thread per padded row, slots in order.
// adjoint (the column-sorted copy): z[col(e)] += vals[e] * u[t*CR + row(e)]
//   over every slot. One warp per 128-slot tile, four slots per lane (one
//   16-byte load of each plane). Equal columns sit next to each other, so
//   each lane sums its runs, a segmented shuffle scan joins the runs that
//   cross lanes, and one float atomic per (tile, column) run adds the sum to
//   z. The order of the atomics varies from run to run, so the last bits of
//   z do too.
//
// What the TPU kernels did and these do not (ops/pallas_wcoo.py,
// ops/pallas_wwcoo.py): Mosaic gathers only within a 128-lane row, so there
// the forward gathered x by an n/128-way crossbar select and reduced rows as
// boundary differences of MXU prefix sums at the gpe/bnb windows, and the
// adjoint gathered u through ku window rows and emitted z densely through the
// per-subtile column table ep (WWCOO: through compaction, emission and
// expansion work lists). The card gathers from any address and adds with
// atomics, so those tables (ep, ugb, bnb, zexp, the work lists) are not read
// here; the host keeps them.
//
// What bounds both on the H100: bytes. Each slot costs 8 bytes per copy and
// 2 flops; the vectors add 4 bytes per row and per column. The forward reads
// only the real slots of the row-sorted copy and gpe; the adjoint streams
// the column-sorted copy and its atomics land in L2 (z is at most 1 MB).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lsqr_chunked_coo {

constexpr int kChunkRows = 16384;  // CR
constexpr int kThreads = 256;
constexpr int kTile = 128;  // slots per warp in the adjoint: 32 lanes x 4
constexpr unsigned kFull = 0xffffffffu;

template <bool kColmap>
__global__ void __launch_bounds__(kThreads) rows_forward(
    const float* __restrict__ vals_r, const int* __restrict__ col_r,
    const int* __restrict__ gpe, const int* __restrict__ colmap, int d_pad,
    const float* __restrict__ x, int n, const float* __restrict__ y, long long y_len,
    const float* __restrict__ c1p, const float* __restrict__ c2p, float* __restrict__ u,
    long long m_pad, int emax) {
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long gr = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       gr < m_pad; gr += stride) {
    const long long t = gr / kChunkRows;
    const int r = static_cast<int>(gr - t * kChunkRows);
    const int* g = gpe + t * kChunkRows;
    const int hi = __ldg(g + r);
    const int lo = r ? __ldg(g + r - 1) + 1 : 0;
    const float* v = vals_r + t * emax;
    const int* c = col_r + t * emax;
    const int* cm = colmap + t * d_pad;
    float acc = 0.0f;
    for (int e = lo; e <= hi; ++e) {
      int col = __ldg(c + e);
      if (kColmap) col = __ldg(cm + col);
      const float xv = (col >= 0 && col < n) ? __ldg(x + col) : 0.0f;
      acc = fmaf(__ldg(v + e), xv, acc);
    }
    const float yv = gr < y_len ? __ldg(y + gr) : 0.0f;
    u[gr] = c1 * acc - c2 * yv;
  }
}

template <bool kColmap>
__device__ __forceinline__ void emit(float* __restrict__ z, const int* __restrict__ cm,
                                     int col, float s, int n) {
  if (kColmap) col = __ldg(cm + col);
  if (s != 0.0f && col >= 0 && col < n) atomicAdd(z + col, s);
}

template <bool kColmap, int kShift>
__global__ void __launch_bounds__(kThreads) cols_adjoint(
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const int* __restrict__ colmap, int d_pad, const float* __restrict__ u,
    long long u_len, float* __restrict__ z, int n, long long tiles, int emax) {
  constexpr unsigned kMask = (1u << kShift) - 1u;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  // w is the same in every lane of a warp, so the shuffles below see all 32
  for (long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       w < tiles; w += nwarps) {
    const long long s0 = w * kTile;
    const long long t = s0 / emax;  // a tile lies in one chunk: 128 | emax
    const float4 v4 = __ldcs(reinterpret_cast<const float4*>(vals + s0) + lane);
    const uint4 i4 = __ldcs(reinterpret_cast<const uint4*>(idx + s0) + lane);
    const float* ut = u + t * kChunkRows;
    const long long rows_left = u_len - t * kChunkRows;
    const int* cm = colmap + t * d_pad;
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    const unsigned ii[4] = {i4.x, i4.y, i4.z, i4.w};
    int col[4];
    float p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      col[k] = static_cast<int>(ii[k] & kMask);
      const long long row = ii[k] >> kShift;
      p[k] = row < rows_left ? vv[k] * __ldg(ut + row) : 0.0f;
    }
    // the lane's runs: the first (head), the middle ones (added here: their
    // column occurs in no other lane of a sorted tile) and the last (tail)
    float head = 0.0f, cur = p[0];
    int runs = 1;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      if (col[k] == col[k - 1]) {
        cur += p[k];
      } else {
        if (runs == 1) {
          head = cur;
        } else {
          emit<kColmap>(z, cm, col[k - 1], cur, n);
        }
        ++runs;
        cur = p[k];
      }
    }
    const bool single = runs == 1;
    const float tail = cur;
    // a lane whose head continues its left neighbour's tail joins it: a
    // segmented inclusive scan of the tails, where a lane that is one run
    // continuing the neighbour's run does not start a segment
    const int prev_cl = __shfl_up_sync(kFull, col[3], 1);
    const bool cont = lane > 0 && col[0] == prev_cl;
    float carry = tail;
    int start = !(single && cont);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float oc = __shfl_up_sync(kFull, carry, d);
      const int os = __shfl_up_sync(kFull, start, d);
      if (lane >= d) {
        if (!start) carry += oc;
        start |= os;
      }
    }
    const float carry_prev = __shfl_up_sync(kFull, carry, 1);
    const int next_cont = __shfl_down_sync(kFull, static_cast<int>(cont), 1);
    if (!single) emit<kColmap>(z, cm, col[0], head + (cont ? carry_prev : 0.0f), n);
    if (lane == 31 || !next_cont) emit<kColmap>(z, cm, col[3], carry, n);
  }
}

inline unsigned grid_for(long long work, long long per_block) {
  long long grid = (work + per_block - 1) / per_block;
  const long long cap = 1LL << 20;  // the grid-stride loops cover the rest
  if (grid > cap) grid = cap;
  return static_cast<unsigned>(grid < 1 ? 1 : grid);
}

template <bool kColmap>
cudaError_t launch_forward(const void* vals_r, const void* col_r, const void* gpe,
                           const void* colmap, int d_pad, const void* x, int n,
                           const void* y, long long y_len, const void* c1, const void* c2,
                           void* u, long long m_pad, int emax, cudaStream_t stream) {
  rows_forward<kColmap><<<grid_for(m_pad, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(vals_r), static_cast<const int*>(col_r),
      static_cast<const int*>(gpe), static_cast<const int*>(colmap), d_pad,
      static_cast<const float*>(x), n, static_cast<const float*>(y), y_len,
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<float*>(u),
      m_pad, emax);
  return cudaGetLastError();
}

// z is zeroed here, on the stream, before the atomics add into it
template <bool kColmap, int kShift>
cudaError_t launch_adjoint(const void* vals, const void* idx, const void* colmap, int d_pad,
                           const void* u, long long u_len, void* z, int n, long long slots,
                           int emax, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(z, 0, static_cast<size_t>(n) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const long long tiles = slots / kTile;
  cols_adjoint<kColmap, kShift><<<grid_for(tiles, kThreads / 32), kThreads, 0, stream>>>(
      static_cast<const float*>(vals), static_cast<const unsigned*>(idx),
      static_cast<const int*>(colmap), d_pad, static_cast<const float*>(u), u_len,
      static_cast<float*>(z), n, tiles, emax);
  return cudaGetLastError();
}

}  // namespace lsqr_chunked_coo
