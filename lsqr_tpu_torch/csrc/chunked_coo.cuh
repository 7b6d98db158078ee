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
//                  unsigned). Padding slots hold 0 (value 0, column 0) and
//                  are sorted in with the rest, so every subtile is sorted.
//
// forward (the row-sorted copy): u[t*CR + r] = c1 * sum vals_r[e] x[col(e)]
//   over the row's slots - c2 * y[t*CR + r] (y read as 0 past y_len). One
//   warp per 32 rows, one row per lane. Where the warp's rows own fewer
//   than kScanSlots = 64 slots (a WWCOO cold stream, under one slot a row),
//   the warp walks them in steps of 32, lane l taking a step's slot l, so
//   the loads coalesce and the colmap and x gathers are in flight together;
//   the first slots of the rows that start in the step become a bit mask (an
//   OR-reduction), a segmented shuffle scan sums each row's slots, and each
//   row's lane adds the sum at its last slot. Longer runs (WCOO, ~5 slots a
//   row): each lane walks its own row's slots in order. That split measured
//   faster on both layouts than a threshold of 32 or 128, or than four slots
//   a lane from 16-byte loads with the same scan (PERF.md). Either way each
//   row's sum has a fixed order: u needs no atomics.
// adjoint (the column-sorted copy): z[col(e)] += vals[e] * u[t*CR + row(e)]
//   over every slot. One warp per 128-slot tile, four slots per lane (one
//   16-byte load of each plane). Equal columns sit next to each other, so
//   each lane sums its runs, a segmented shuffle scan joins the runs that
//   cross lanes, and each (tile, column) run is emitted once.
//   WCOO (n <= 4096, deterministic): a block of 8 warps takes the 8 tiles of
//   one subtile at a time, over a fixed contiguous range of subtiles, and
//   adds into its own z in shared memory (n floats, at most 16 KB). Within
//   a subtile a column is one run, so the runs of different warps hit
//   different columns, except that a warp's first run may continue the
//   previous warp's last: each warp sets its first run aside, and after a
//   barrier one thread adds the eight in warp order. The block writes its z
//   to partials[block]; a second kernel adds the partials of each column in
//   block order. The grid depends on the shape and the card's SM count only,
//   so every sum has the same order in every run: z is bit-identical from
//   run to run, with no float atomic and no memset.
//   WWCOO (colmap positions up to 2^18; deterministic): the TPU kernel's
//   order, compaction then expansion. Compaction: block (t, w, s) takes
//   chunk t's subtiles [s * eb / S, (s + 1) * eb / S) and adds the runs
//   whose position lies in window w into a zc of its own in shared memory,
//   with the same hand-off of each warp's first run; G groups of 8 warps
//   take G subtiles at once into G zc, added in group order at the end,
//   and the block writes its window to partials[(t * S + s) * d_pad + pos].
//   While a step adds one subtile's runs, the next subtile's u gathers and
//   the loads of the one after are in flight. Where d_pad floats fit one
//   block's shared memory there is one window (G = up to 4); else windows
//   of what fits, G = 1, and a warp loads only the tiles whose sorted
//   positions meet its window. Expansion: 8 lanes add the partials of
//   column c, read through the host-built inverse of colmap (zptr, zsrc:
//   the (t, pos) of each column, t ascending), lane l the entries l, l + 8,
//   ... in order, joined in a fixed tree, and write z[c]. The plan (G,
//   windows, S) depends on the shape and the card only, so z is
//   bit-identical from run to run, with no float atomic and no memset.
// WWCOO pair (pair_chunks, plans of one window and one split whose chunk's
//   u fits in shared memory beside the G zc: pair_one_pass): one block a
//   chunk runs the forward of its rows and then its compaction, u staying
//   in shared memory in between, with the same per-row and per-zc
//   arithmetic as rows_forward and cols_compact; the expansion is a second
//   launch. Other plans run rows_forward, cols_compact, expand_columns.
//
// What the TPU kernels did and these do not (ops/pallas_wcoo.py,
// ops/pallas_wwcoo.py): Mosaic gathers only within a 128-lane row, so there
// the forward gathered x by an n/128-way crossbar select and reduced rows as
// boundary differences of MXU prefix sums at the gpe/bnb windows, and the
// adjoint gathered u through ku window rows and emitted z densely through the
// per-subtile column table ep (WWCOO: through compaction, emission and
// expansion work lists), adding each chunk's z in grid order. The card
// gathers from any address, so those tables (ep, ugb, bnb, zexp, the work
// lists) are not read here; the host keeps them, and WWCOO's zexp only as
// the per-column lists zptr/zsrc.
//
// What bounds both on the H100: bytes. Each slot costs 8 bytes per copy and
// 2 flops; the vectors add 4 bytes per row and per column. The forward reads
// only the real slots of the row-sorted copy and gpe; the adjoint streams
// the column-sorted copy. The WCOO partials (blocks x n floats) and the
// WWCOO ones (nc x S x d_pad floats) are scratch that stays mostly in the
// 50 MB L2; WWCOO's expansion gathers one partial per (chunk, column) pair
// of each split through the inverse list (4 bytes a pair).

#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace lsqr_chunked_coo {

constexpr int kChunkRows = 16384;  // CR
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // slots a warp takes at once: 32 lanes x 4
constexpr int kSubtile = kWarps * kTile;  // 1024: a block's step in the WCOO adjoint
constexpr int kSumSegments = 32;  // the partials' sum: 32 columns x 32 block ranges
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanSlots = 64;  // the forward: warps of fewer slots take scan_rows
constexpr int kMaxGroups = 4;  // WWCOO compaction: at most 4 groups of 8 warps a block
constexpr int kExpandThreads = 256;  // WWCOO expansion: a block of 32 columns x 8 lanes

// One step of scan_rows after its loads: p is lane l's product of slot
// s0 + l (0 past the warp's last slot). The first slots of the rows that
// start in the step become a bit mask (an OR-reduction), a segmented shuffle
// scan sums each row's slots in the step, and each row's lane adds the sum
// at its last slot in the step to acc, its row's sum of slots [lo, hi].
__device__ __forceinline__ float scan_step(float acc, float p, int lo, int hi, int s0,
                                           int lane) {
  const bool has = lo <= hi && lo < s0 + 32 && hi >= s0;
  // a lane with a row's first slot starts a segment, as lane 0 does
  const unsigned heads = __reduce_or_sync(kFull, has && lo >= s0 ? 1u << (lo - s0) : 0u) | 1u;
  const int first = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, p, d);
    if (lane - d >= first) p += o;
  }
  const int last = (hi < s0 + 31 ? hi : s0 + 31) - s0;
  const float part = __shfl_sync(kFull, p, has ? last : 0);
  if (has) acc += part;
  return acc;
}

// The rows of a warp whose slots [w_lo, w_hi] are few, in steps of 32 from
// s_begin: lane l takes slot s0 + l, then scan_step. Returns this lane's
// row sum (acc plus the steps' sums), slots [lo, hi].
template <bool kColmap>
__device__ __forceinline__ float scan_rows(const float* __restrict__ v,
                                           const int* __restrict__ c,
                                           const int* __restrict__ cm,
                                           const float* __restrict__ x, int n, int lo, int hi,
                                           int s_begin, int w_hi, int lane, float acc) {
  for (int s0 = s_begin; s0 <= w_hi; s0 += 32) {
    const int sl = s0 + lane;
    float p = 0.0f;
    if (sl <= w_hi) {
      int col = __ldg(c + sl);
      if (kColmap) col = __ldg(cm + col);
      p = (col >= 0 && col < n) ? __ldg(v + sl) * __ldg(x + col) : 0.0f;
    }
    acc = scan_step(acc, p, lo, hi, s0, lane);
  }
  return acc;
}

// The walk of a warp with many slots: each lane adds its row's slots in order.
template <bool kColmap>
__device__ __forceinline__ float walk_row(const float* __restrict__ v,
                                          const int* __restrict__ c,
                                          const int* __restrict__ cm,
                                          const float* __restrict__ x, int n, int lo, int hi) {
  float acc = 0.0f;
  for (int e = lo; e <= hi; ++e) {
    int col = __ldg(c + e);
    if (kColmap) col = __ldg(cm + col);
    const float xv = (col >= 0 && col < n) ? __ldg(x + col) : 0.0f;
    acc = fmaf(__ldg(v + e), xv, acc);
  }
  return acc;
}

// A row's output from its sum and its y entry (one expression for every
// kernel, so each rounds u alike).
__device__ __forceinline__ float row_out(float c1, float acc, float c2, float yv) {
  return c1 * acc - c2 * yv;
}

template <bool kColmap>
__global__ void __launch_bounds__(kThreads) rows_forward(
    const float* __restrict__ vals_r, const int* __restrict__ col_r,
    const int* __restrict__ gpe, const int* __restrict__ colmap, int d_pad,
    const float* __restrict__ x, int n, const float* __restrict__ y, long long y_len,
    const float* __restrict__ c1p, const float* __restrict__ c2p, float* __restrict__ u,
    long long m_pad, int emax) {
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int lane = threadIdx.x & 31;
  const long long warps = m_pad / 32;  // 32 | CR: a warp's rows lie in one chunk
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  // w is the same in every lane of a warp, so the shuffles below see all 32
  for (long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       w < warps; w += nwarps) {
    const long long gr = w * 32 + lane;
    const long long t = gr / kChunkRows;
    const int r = static_cast<int>(gr - t * kChunkRows);
    const int* g = gpe + t * kChunkRows;
    const int hi = __ldg(g + r);
    int before = __shfl_up_sync(kFull, hi, 1);
    if (lane == 0) before = r ? __ldg(g + r - 1) : -1;
    const int lo = before + 1;  // the row's slots: [lo, hi], none when lo > hi
    // the warp's slots [w_lo, w_hi]; w_lo is the first non-empty row's first
    const int w_lo = __shfl_sync(kFull, lo, 0);
    const int w_hi = __shfl_sync(kFull, hi, 31);
    const float* v = vals_r + t * emax;
    const int* c = col_r + t * emax;
    const int* cm = colmap + t * d_pad;
    // few slots (a WWCOO cold stream): one slot a lane; more: each lane
    // walks its row's slots in order
    const float acc = w_hi - w_lo < kScanSlots
                          ? scan_rows<kColmap>(v, c, cm, x, n, lo, hi, w_lo, w_hi, lane, 0.0f)
                          : walk_row<kColmap>(v, c, cm, x, n, lo, hi);
    const float yv = gr < y_len ? __ldg(y + gr) : 0.0f;
    u[gr] = row_out(c1, acc, c2, yv);
  }
}

// Where the adjoint reads a chunk's u: through the read-only path (u
// written by an earlier kernel) or from shared memory (the pair).
struct RowsLdg {
  const float* __restrict__ u;
  __device__ __forceinline__ float operator()(long long r) const { return __ldg(u + r); }
};
struct RowsShared {
  const float* u;
  __device__ __forceinline__ float operator()(long long r) const { return u[r]; }
};

// This lane's four products of a tile, vals[e] * u[row(e)] (ut reads the
// chunk's u, 0 past its rows_left rows).
template <int kShift, class Rows>
__device__ __forceinline__ float4 tile_products(float4 v4, uint4 i4, Rows ut,
                                                long long rows_left) {
  const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
  const unsigned ii[4] = {i4.x, i4.y, i4.z, i4.w};
  float p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long row = ii[k] >> kShift;
    p[k] = row < rows_left ? vv[k] * ut(row) : 0.0f;
  }
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The runs of one warp's 128-slot tile, from this lane's four products p4
// and index words i4: emit(col, sum) once per (tile, column) run, col the
// stored column (WWCOO: the colmap position).
template <int kShift, class Emit>
__device__ __forceinline__ void tile_runs(float4 p4, uint4 i4, int lane, Emit emit) {
  constexpr unsigned kMask = (1u << kShift) - 1u;
  const float p[4] = {p4.x, p4.y, p4.z, p4.w};
  const unsigned ii[4] = {i4.x, i4.y, i4.z, i4.w};
  int col[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) col[k] = static_cast<int>(ii[k] & kMask);
  // the lane's runs: the first (head), the middle ones (emitted here: their
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
        emit(col[k - 1], cur);
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
  if (!single) emit(col[0], head + (cont ? carry_prev : 0.0f));
  if (lane == 31 || !next_cont) emit(col[3], carry);
}

// WCOO: block b adds the subtiles [b * S / G, (b + 1) * S / G) into its z in
// shared memory and writes it to partials[b * n, (b + 1) * n)
template <int kShift>
__global__ void __launch_bounds__(kThreads) cols_adjoint_partial(
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const float* __restrict__ u, long long u_len, float* __restrict__ partials, int n,
    long long subtiles, int emax) {
  extern __shared__ float zs[];
  __shared__ int first_col[kWarps];
  __shared__ float first_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < n; c += kThreads) zs[c] = 0.0f;
  const long long j0 = subtiles * blockIdx.x / gridDim.x;
  const long long j1 = subtiles * (blockIdx.x + 1) / gridDim.x;
  const float4* v4p = reinterpret_cast<const float4*>(vals + warp * kTile) + lane;
  const uint4* i4p = reinterpret_cast<const uint4*>(idx + warp * kTile) + lane;
  constexpr int kStep = kSubtile / 4;  // float4s per subtile
  float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint4 i4 = make_uint4(0u, 0u, 0u, 0u);
  if (j0 < j1) {
    v4 = __ldcs(v4p + j0 * kStep);
    i4 = __ldcs(i4p + j0 * kStep);
  }
  __syncthreads();
  for (long long j = j0; j < j1; ++j) {
    const float4 cv = v4;
    const uint4 ci = i4;
    if (j + 1 < j1) {  // the next subtile's loads in flight during this one
      v4 = __ldcs(v4p + (j + 1) * kStep);
      i4 = __ldcs(i4p + (j + 1) * kStep);
    }
    const long long t = j * kSubtile / emax;  // a subtile lies in one chunk
    const int c0 = __shfl_sync(kFull, static_cast<int>(ci.x & ((1u << kShift) - 1u)), 0);
    tile_runs<kShift>(tile_products<kShift>(cv, ci, RowsLdg{u + t * kChunkRows},
                                            u_len - t * kChunkRows),
                      ci, lane, [&](int col, float s) {
                        if (col == c0) {  // the tile's first run
                          first_col[warp] = col;
                          first_sum[warp] = s;
                        } else if (col < n) {
                          zs[col] += s;
                        }
                      });
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < kWarps; ++k) {
        if (first_col[k] < n) zs[first_col[k]] += first_sum[k];
      }
    }
    __syncthreads();
  }
  float* out = partials + static_cast<long long>(blockIdx.x) * n;
  for (int c = threadIdx.x; c < n; c += kThreads) out[c] = zs[c];
}

// z[c] = the sum of partials[b * n + c] over the blocks b: 32 columns per
// block, kSegments ranges of blocks each summed in order, then the ranges
// in order (a template only so that the header defines it in each source)
template <int kSegments>
__global__ void __launch_bounds__(32 * kSegments) sum_partials(
    const float* __restrict__ partials, int blocks, float* __restrict__ z, int n) {
  __shared__ float seg[kSegments][33];
  const int cx = threadIdx.x & 31;
  const int sy = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cx;
  const int b0 = blocks * sy / kSegments;
  const int b1 = blocks * (sy + 1) / kSegments;
  float acc = 0.0f;
  if (c < n) {
    for (int b = b0; b < b1; ++b) acc += __ldcs(partials + static_cast<long long>(b) * n + c);
  }
  seg[sy][cx] = acc;
  __syncthreads();
  if (sy == 0 && c < n) {
    float s = seg[0][cx];
    for (int k = 1; k < kSegments; ++k) s += seg[k][cx];
    z[c] = s;
  }
}

// WWCOO compaction of chunk t for position window [p0, p0 + width) and the
// subtiles [j0, j1) of split s into partials[(t * splits + s) * d_pad + p0
// ..): G = blockDim.x / 256 groups of 8 warps, group g taking the subtiles
// j0 + g, j0 + g + G, ... in lockstep into zs[g * wsize, (g + 1) * wsize),
// added in group order at the end. ut reads the chunk's u (rows_left rows),
// which must be visible to the whole block when this starts, or with
// kInPass (the pair: u written by this block's forward, xc in the zc's
// room) after its first barrier: each warp's first loads go out before
// it, and the zc are zeroed after it.
template <int kShift, bool kInPass, class Rows>
__device__ __forceinline__ void compact_chunk(
    const float* __restrict__ vals, const unsigned* __restrict__ idx, Rows ut,
    long long rows_left, float* __restrict__ partials, int d_pad, float* zs, int* first_col,
    float* first_sum, long long t, int p0, int width, int wsize, int windows, int s,
    int splits, int j0, int j1, int eb) {
  constexpr unsigned kMask = (1u << kShift) - 1u;
  const int groups = blockDim.x / kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / kWarps;
  auto zero = [&] {
    for (int k = threadIdx.x; k < groups * wsize; k += blockDim.x) zs[k] = 0.0f;
  };
  if (!kInPass) zero();
  float* z = zs + group * wsize;
  // the warp's tile of subtile j: loaded when its positions meet the window
  const long long tile0 = t * eb * kSubtile + (warp % kWarps) * kTile;
  auto fetch = [&](int j, float4& v4, uint4& i4) {
    if (j >= j1) return false;
    const long long s0 = tile0 + static_cast<long long>(j) * kSubtile;
    if (windows > 1) {  // the tile is sorted: its positions are [lo, hi]
      const int lo = static_cast<int>(__ldg(idx + s0) & kMask);
      const int hi = static_cast<int>(__ldg(idx + s0 + kTile - 1) & kMask);
      if (hi < p0 || lo >= p0 + width) return false;
    }
    v4 = __ldcs(reinterpret_cast<const float4*>(vals + s0) + lane);
    i4 = __ldcs(reinterpret_cast<const uint4*>(idx + s0) + lane);
    return true;
  };
  // a step adds subtile j's runs while the next subtile's u gathers and the
  // loads of the one after are in flight
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 v4 = zero4, v4n = zero4;
  uint4 i4 = make_uint4(0u, 0u, 0u, 0u), i4n = i4;
  int j = j0 + group;
  bool have = fetch(j, v4, i4);
  bool have_n = fetch(j + groups, v4n, i4n);
  __syncthreads();
  if (kInPass) {  // every warp's forward is done with xc
    zero();
    __syncthreads();
  }
  float4 p4 = have ? tile_products<kShift>(v4, i4, ut, rows_left) : zero4;
  const int steps = (j1 - j0 + groups - 1) / groups;
  for (int i = 0; i < steps; ++i, j += groups) {
    const float4 cp = p4;
    const uint4 ci = i4;
    const bool cur = have;
    p4 = have_n ? tile_products<kShift>(v4n, i4n, ut, rows_left) : zero4;
    i4 = i4n;
    have = have_n;
    have_n = fetch(j + 2 * groups, v4n, i4n);
    if (cur) {
      const int c0 = __shfl_sync(kFull, static_cast<int>(ci.x & kMask), 0);
      tile_runs<kShift>(cp, ci, lane, [&](int pos, float sum) {
        const unsigned q = static_cast<unsigned>(pos - p0);
        if (pos == c0) {  // the tile's first run
          first_col[warp] = pos;
          first_sum[warp] = sum;
        } else if (q < static_cast<unsigned>(width)) {
          z[q] += sum;
        }
      });
    } else if (lane == 0) {
      first_col[warp] = -1;
    }
    __syncthreads();
    if (threadIdx.x % kThreads == 0) {  // each group's first runs, in warp order
      for (int k = group * kWarps; k < (group + 1) * kWarps; ++k) {
        const unsigned q = static_cast<unsigned>(first_col[k] - p0);
        if (first_col[k] >= 0 && q < static_cast<unsigned>(width)) z[q] += first_sum[k];
      }
    }
    __syncthreads();
  }
  float* out = partials + (t * splits + s) * static_cast<long long>(d_pad) + p0;
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    float acc = zs[q];
    for (int g = 1; g < groups; ++g) acc += zs[g * wsize + q];
    out[q] = acc;
  }
}

// WWCOO compaction: block (t, w, s) of chunk t, position window w
// [w * wsize, w * wsize + width) and subtile split s (compact_chunk)
template <int kShift>
__global__ void __launch_bounds__(kThreads * kMaxGroups) cols_compact(
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const float* __restrict__ u, long long u_len, float* __restrict__ partials, int d_pad,
    int wsize, int windows, int splits, int eb) {
  extern __shared__ float zs[];
  __shared__ int first_col[kWarps * kMaxGroups];
  __shared__ float first_sum[kWarps * kMaxGroups];
  const long long b = blockIdx.x;
  const long long t = b / (static_cast<long long>(windows) * splits);
  const int p0 = static_cast<int>(b / splits % windows) * wsize;
  const int s = static_cast<int>(b % splits);
  compact_chunk<kShift, false>(vals, idx, RowsLdg{u + t * kChunkRows},
                               u_len - t * kChunkRows, partials, d_pad, zs, first_col,
                               first_sum, t, p0, min(wsize, d_pad - p0), wsize, windows, s,
                               splits, static_cast<int>(static_cast<long long>(eb) * s / splits),
                               static_cast<int>(static_cast<long long>(eb) * (s + 1) / splits),
                               eb);
}

// WWCOO expansion: z[c] = the partials of column c; zsrc[zptr[c] ..
// zptr[c + 1]) holds t * d_pad + pos of each chunk t that has column c at
// position pos, t ascending. kLanes lanes take a column: lane l adds list
// entries l, l + kLanes, ... (each entry's splits in order), then the lanes'
// sums join in a fixed tree, so a warm column's chain of loads is kLanes
// times shorter and the order stays the same in every run.
template <int kLanes>
__global__ void __launch_bounds__(kExpandThreads) expand_columns(
    const float* __restrict__ partials, const int* __restrict__ zptr,
    const int* __restrict__ zsrc, int d_pad, int splits, float* __restrict__ z, int n) {
  const long long gt = static_cast<long long>(blockIdx.x) * kExpandThreads + threadIdx.x;
  const long long c = gt / kLanes;
  const int l = static_cast<int>(gt % kLanes);
  float acc = 0.0f;
  if (c < n) {
    const int k1 = __ldg(zptr + c + 1);
#pragma unroll 4
    for (int k = __ldg(zptr + c) + l; k < k1; k += kLanes) {
      const int f = __ldg(zsrc + k);
      const long long tt = f / d_pad;
      const float* p = partials + tt * splits * d_pad + (f - tt * d_pad);
      // through L1: neighbouring columns' positions in a chunk share lines
      for (int sp = 0; sp < splits; ++sp) acc += __ldg(p + static_cast<long long>(sp) * d_pad);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o, kLanes);
  if (l == 0 && c < n) z[c] = acc;
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

// The WWCOO compaction's shared memory besides zs (first_col, first_sum)
constexpr int kCompactStatic = 2 * 4 * kWarps * kMaxGroups;

// The WWCOO adjoint's plan for chunks of eb subtiles and d_pad positions on
// this card: plan = {G, wsize, windows, S}. One window where d_pad floats
// fit a block's shared memory, with as many groups (at most 4) as fit
// there too; else windows of what fits and G = 1. S splits each chunk's
// subtiles where nc x windows blocks would not fill the card's SMs (at
// most one split per G subtiles, and a split streams at least the partial
// bytes it writes). The partials hold nc x S x d_pad floats.
inline cudaError_t compact_plan(int d_pad, int eb, long long nc, int* plan) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (d_pad < 1 || eb < 1 || nc < 1) return cudaErrorInvalidValue;
  const int floats = (optin - kCompactStatic) / 4;
  int groups = 1, wsize = d_pad, windows = 1;
  if (d_pad <= floats) {
    groups = std::min(kMaxGroups, floats / d_pad);
  } else {
    wsize = floats & ~127;
    windows = (d_pad + wsize - 1) / wsize;
  }
  const int block_smem = groups * wsize * 4 + kCompactStatic + 1024;  // the card keeps 1 KB
  const int resident = std::max(1, std::min(2048 / (kThreads * groups), per_sm / block_smem)) * sms;
  // at most one split per G subtiles, and none that writes more partial
  // bytes (4 * wsize) than it streams (8 KB a subtile)
  const long long most = std::min<long long>((eb + groups - 1) / groups,
                                             std::max<long long>(1, 2048LL * eb / wsize));
  long long splits = resident / (nc * windows);
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  plan[0] = groups;
  plan[1] = wsize;
  plan[2] = windows;
  plan[3] = static_cast<int>(splits);
  return cudaSuccess;
}

// The dynamic shared memory each kernel has opted in to, 48 KB (what a
// launch takes without the opt-in) until then. Internal linkage: another
// library of these kernels loaded in the same process keeps its own (a
// static local of an inline function would be one object for both).
namespace {
template <int kShift>
size_t compact_opted = 48 * 1024;
template <int kShift>
size_t pair_opted = 48 * 1024;
template <int kShift>
int pair_static = -1;  // the pair kernel's static shared memory, once read
}  // namespace

// WWCOO: the compaction into partials (nc x S x d_pad floats), then the
// expansion; every entry of z is written
template <int kShift>
cudaError_t launch_adjoint_compact(const void* vals, const void* idx, const void* zptr,
                                   const void* zsrc, int d_pad, const void* u, long long u_len,
                                   void* partials, int groups, int wsize, int windows,
                                   int splits, void* z, int n, long long slots, int emax,
                                   cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const long long nc = slots / emax;
  const int eb = emax / kSubtile;
  const size_t smem = static_cast<size_t>(groups) * wsize * sizeof(float);
  if (groups < 1 || groups > kMaxGroups || wsize < 1 || windows < 1 || splits < 1 ||
      splits > eb || static_cast<long long>(wsize) * windows < d_pad ||
      nc * d_pad >= (1LL << 31) || d_pad > (1 << kShift)) {
    return cudaErrorInvalidValue;
  }
  if (smem > compact_opted<kShift>) {
    const cudaError_t err = cudaFuncSetAttribute(
        cols_compact<kShift>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    compact_opted<kShift> = smem;
  }
  cols_compact<kShift><<<static_cast<unsigned>(nc * windows * splits), kThreads * groups, smem,
                         stream>>>(
      static_cast<const float*>(vals), static_cast<const unsigned*>(idx),
      static_cast<const float*>(u), u_len, static_cast<float*>(partials), d_pad, wsize, windows,
      splits, eb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kLanes = 8;
  expand_columns<kLanes><<<static_cast<unsigned>((static_cast<long long>(n) * kLanes +
                                                   kExpandThreads - 1) / kExpandThreads),
                           kExpandThreads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<const int*>(zptr),
      static_cast<const int*>(zsrc), d_pad, splits, static_cast<float*>(z), n);
  return cudaGetLastError();
}

// The WWCOO pair in one pass over each chunk's entries (pair_chunks), for
// plans of one window and one split whose chunk's u fits beside the G zc
// (pair_one_pass). Block t takes chunk t:
//   1. copies the chunk's x by position into the zc's room, xc[pos] =
//      x[colmap[t, pos]], in one pass with every load in flight;
//   2. computes the chunk's 16384 rows of u as rows_forward does (the same
//      32 rows a warp, scan_rows or the walk, the same rounding), its warps
//      taking the chunk's 512 row groups in turn, kPairBatch at a time, the
//      next batch's row ends in flight (pair_forward); the first step's
//      products read x from xc, the rarer steps (a warp of 32 to 63 slots,
//      or the walk) gather as rows_forward does. u goes to memory and to
//      shared memory, beside the zc;
//   3. compacts the chunk's subtiles into its zc as cols_compact does
//      (compact_chunk: the same G groups and order): each warp's first two
//      subtile loads go out as its own forward ends, then a block barrier,
//      the zc zeroed, a second barrier; its u gathers from shared memory,
//      and it writes the chunk's partials.
// Then the expansion (expand_columns, the same lanes and tree) as a second
// launch. u, the partials and z are the bits of rows_forward, cols_compact
// and expand_columns on the same inputs.
// Why so: the G = 4 zc take 160 KB of shared memory, so a block (32 warps)
// is alone on its SM, and the zc squeeze L1, where rows_forward's colmap
// and x gathers hit: the first one-pass design, gathering as rows_forward
// does, spent as long on its forward as rows_forward with 64 warps an SM
// (u in shared memory, 224 KB, slower still); xc takes two dependent
// gathers off each row group, and the pipeline one global latency. On
// RWCOO's cold stream (H100) the pass takes ~5.6 us to launch and stage,
// ~20 us for the forward and ~12 us for the compaction, the expansion
// ~11 us (tools/wwcoo_pair_designs.py, PERF.md); the compaction's first
// loads under the forward's tail took ~0.6 us off. The other designs that
// tool times as patches of this source measured slower: a grid-wide
// barrier before an in-kernel expansion (a cooperative grid), L2
// prefetches of the column-sorted copy (before the staging, or of each
// warp's tiles as its forward ends), more or fewer groups a batch, no
// pipeline or a deeper one, and an expansion launched early (programmatic
// dependent launch). No block holds a second chunk whose forward could
// overlap a compaction: at the cold stream's 128 chunks each SM has one.
constexpr int kPairBatch = 2;  // row groups a warp of the pair's forward sums at once

// The pair's forward of chunk t (rows row0 = t * CR ..): warp w of nwarps
// takes the row groups w, w + nwarps, ..., kPairBatch at a time, the row
// ends (and y) of the next batch in flight while a batch is summed. xc
// holds x[colmap[pos]] for the chunk's cnt positions in range (colmap is
// sorted, its padding last), so the first step's products read x from
// shared memory by position: the same values as x[colmap[col_r]], where a
// position past cnt gives 0 as an out-of-range column does.
__device__ __forceinline__ void pair_forward(
    const float* __restrict__ v, const int* __restrict__ c, const int* __restrict__ g,
    const int* __restrict__ cm, const float* __restrict__ x, int n, const float* xc, int cnt,
    const float* __restrict__ y, long long y_len, float c1, float c2, float* __restrict__ ut,
    float* us, long long row0) {
  constexpr int kGroups = kChunkRows / 32;
  constexpr int B = kPairBatch;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int step = nwarps * B;
  struct Ends {  // a batch's row ends (lane 0 also the row before its first) and y
    int hi[B], lo[B];
    float yv[B];
  };
  struct Slots {  // a batch's rows' and warps' slots, and the first step's loads
    int lo[B], w_lo[B], w_hi[B], pos[B];
    float vv[B];
  };
  auto load_ends = [&](int k0, Ends& e) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = k0 + b * nwarps;  // the same in every lane
      const int r = k * 32 + lane;
      e.hi[b] = k < kGroups ? __ldg(g + r) : -1;
      e.lo[b] = k < kGroups && lane == 0 && r ? __ldg(g + r - 1) : -1;
      e.yv[b] = k < kGroups && row0 + r < y_len ? __ldg(y + row0 + r) : 0.0f;
    }
  };
  auto load_slots = [&](const Ends& e, Slots& sl) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int before = __shfl_up_sync(kFull, e.hi[b], 1);
      sl.lo[b] = (lane == 0 ? e.lo[b] : before) + 1;  // the row's slots: [lo, hi]
      sl.w_lo[b] = __shfl_sync(kFull, sl.lo[b], 0);
      sl.w_hi[b] = __shfl_sync(kFull, e.hi[b], 31);
      const int s0 = sl.w_lo[b] + lane;  // the first step of scan_rows: slot s0
      sl.pos[b] = s0 <= sl.w_hi[b] ? __ldg(c + s0) : 0;
      sl.vv[b] = s0 <= sl.w_hi[b] ? __ldg(v + s0) : 0.0f;
    }
  };
  auto finish = [&](int k0, const Ends& e, const Slots& sl) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = k0 + b * nwarps;
      if (k >= kGroups) continue;  // warp-uniform
      float p = 0.0f;
      if (sl.w_lo[b] + lane <= sl.w_hi[b]) {
        p = sl.pos[b] < cnt ? sl.vv[b] * xc[sl.pos[b]] : 0.0f;
      }
      float acc = 0.0f;
      if (sl.w_hi[b] - sl.w_lo[b] >= kScanSlots) {
        acc = walk_row<true>(v, c, cm, x, n, sl.lo[b], e.hi[b]);
      } else if (sl.w_lo[b] <= sl.w_hi[b]) {
        acc = scan_step(acc, p, sl.lo[b], e.hi[b], sl.w_lo[b], lane);
        acc = scan_rows<true>(v, c, cm, x, n, sl.lo[b], e.hi[b], sl.w_lo[b] + 32, sl.w_hi[b],
                              lane, acc);
      }
      const int r = k * 32 + lane;
      const float out = row_out(c1, acc, c2, e.yv[b]);
      ut[r] = out;
      us[r] = out;
    }
  };
  Ends next;
  load_ends(threadIdx.x >> 5, next);
  for (int k0 = threadIdx.x >> 5; k0 < kGroups; k0 += step) {
    const Ends e = next;
    load_ends(k0 + step, next);
    Slots sl;
    load_slots(e, sl);
    finish(k0, e, sl);
  }
}

template <int kShift>
__global__ void __launch_bounds__(kThreads * kMaxGroups) pair_chunks(
    const float* __restrict__ vals_r, const int* __restrict__ col_r,
    const int* __restrict__ gpe, const float* __restrict__ vals,
    const unsigned* __restrict__ idx, const int* __restrict__ colmap, int d_pad,
    const float* __restrict__ x, int n, const float* __restrict__ y, long long y_len,
    const float* __restrict__ c1p, const float* __restrict__ c2p, float* __restrict__ u,
    float* __restrict__ partials, long long u_len, int eb) {
  extern __shared__ float zs[];  // G zc of d_pad floats, then the chunk's u
  __shared__ int first_col[kWarps * kMaxGroups];
  __shared__ float first_sum[kWarps * kMaxGroups];
  __shared__ int s_cnt;
  constexpr int kStage = 16;  // positions a thread stages at once: d_pad <= 16384 in one round
  const float c1 = __ldg(c1p);
  const float c2 = __ldg(c2p);
  const int emax = eb * kSubtile;
  float* us = zs + (blockDim.x / kThreads) * d_pad;
  float* xc = zs;  // the chunk's x by position, in the zc's room until the compaction
  const long long t = blockIdx.x;  // the block's chunk
  // xc[pos] = x[colmap[t, pos]] for the positions whose column is in
  // range: a prefix, cnt long; kStage positions a thread in flight
  const int* cmt = colmap + t * d_pad;
  if (threadIdx.x == 0) s_cnt = 0;
  int mine = 0;
  for (int q0 = threadIdx.x; q0 < d_pad; q0 += kStage * blockDim.x) {
    int col[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int q = q0 + i * blockDim.x;
      col[i] = q < d_pad ? __ldg(cmt + q) : -1;
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      if (col[i] >= 0 && col[i] < n) {
        xc[q0 + i * blockDim.x] = __ldg(x + col[i]);
        ++mine;
      }
    }
  }
  __syncthreads();  // s_cnt is 0
  if (mine) atomicAdd(&s_cnt, mine);  // an integer count: the same in any order
  __syncthreads();  // xc and s_cnt for the whole block
  const int cnt = s_cnt;
  pair_forward(vals_r + t * emax, col_r + t * emax, gpe + t * kChunkRows, cmt, x, n, xc, cnt, y,
               y_len, c1, c2, u + t * kChunkRows, us, t * kChunkRows);
  // the compaction's first loads go out as this warp's forward ends; its
  // barrier makes the chunk's u in shared memory whole
  compact_chunk<kShift, true>(vals, idx, RowsShared{us}, u_len - t * kChunkRows, partials,
                              d_pad, zs, first_col, first_sum, t, 0, d_pad, d_pad, 1, 0, 1, 0,
                              eb, eb);
}

// The pair's dynamic shared memory: G zc of d_pad floats and the chunk's u
inline size_t pair_chunk_smem(int groups, int d_pad) {
  return (static_cast<size_t>(groups) * d_pad + kChunkRows) * sizeof(float);
}

// Whether the WWCOO pair takes one pass (pair_chunks) for the adjoint's plan
// {G, wsize, windows, S} on this card: one window and one split, and the
// kernel's shared memory (static, and pair_chunk_smem) within what a block
// may opt in to. A window or a split needs all of a chunk's u in more than
// one block; a u that does not fit beside the G zc has no room. Other
// plans take the three kernels in turn.
template <int kShift>
cudaError_t pair_one_pass(int groups, int d_pad, int windows, int splits, bool* one) {
  *one = false;
  if (windows != 1 || splits != 1) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && pair_static<kShift> < 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, pair_chunks<kShift>);
    if (err == cudaSuccess) pair_static<kShift> = static_cast<int>(attr.sharedSizeBytes);
  }
  if (err != cudaSuccess) return err;
  *one = pair_static<kShift> + pair_chunk_smem(groups, d_pad) <= static_cast<size_t>(optin);
  return cudaSuccess;
}

// The WWCOO pair in one pass (pair_chunks, then expand_columns) for a plan
// of G groups, one window and one split that pair_one_pass takes. Every
// entry of u (m_pad) and z is written.
template <int kShift>
cudaError_t launch_pair_chunks(const void* vals_r, const void* col_r, const void* gpe,
                               const void* vals, const void* idx, const void* colmap, int d_pad,
                               const void* zptr, const void* zsrc, const void* x, int n,
                               const void* y, long long y_len, const void* c1, const void* c2,
                               void* u, void* partials, int groups, void* z, long long m_pad,
                               int emax, cudaStream_t stream) {
  if (n <= 0 || groups < 1 || groups > kMaxGroups || d_pad < 1 || d_pad > (1 << kShift) ||
      m_pad < kChunkRows || (m_pad / kChunkRows) * d_pad >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = pair_chunks<kShift>;
  const long long nc = m_pad / kChunkRows;  // a block each
  const int eb = emax / kSubtile;
  const size_t smem = pair_chunk_smem(groups, d_pad);
  const int threads = kThreads * groups;
  if (smem > pair_opted<kShift>) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    pair_opted<kShift> = smem;
  }
  pair_chunks<kShift><<<static_cast<unsigned>(nc), threads, smem, stream>>>(
      static_cast<const float*>(vals_r), static_cast<const int*>(col_r),
      static_cast<const int*>(gpe), static_cast<const float*>(vals),
      static_cast<const unsigned*>(idx), static_cast<const int*>(colmap), d_pad,
      static_cast<const float*>(x), n, static_cast<const float*>(y), y_len,
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<float*>(u),
      static_cast<float*>(partials), m_pad, eb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kLanes = 8;
  expand_columns<kLanes><<<static_cast<unsigned>((static_cast<long long>(n) * kLanes +
                                                   kExpandThreads - 1) / kExpandThreads),
                           kExpandThreads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<const int*>(zptr),
      static_cast<const int*>(zsrc), d_pad, 1, static_cast<float*>(z), n);
  return cudaGetLastError();
}

// WCOO: blocks (at least 1, at most slots / 1024) each write n partials,
// then the partials' sum writes z; every entry of z is written
template <int kShift>
cudaError_t launch_adjoint_partial(const void* vals, const void* idx, const void* u,
                                   long long u_len, void* partials, int blocks, void* z,
                                   int n, long long slots, int emax, cudaStream_t stream) {
  const long long subtiles = slots / kSubtile;
  if (n <= 0) return cudaSuccess;
  if (blocks < 1 || blocks > subtiles || n > (1 << kShift)) return cudaErrorInvalidValue;
  cols_adjoint_partial<kShift><<<blocks, kThreads, n * sizeof(float), stream>>>(
      static_cast<const float*>(vals), static_cast<const unsigned*>(idx),
      static_cast<const float*>(u), u_len, static_cast<float*>(partials), n, subtiles, emax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<kSumSegments><<<(n + 31) / 32, 32 * kSumSegments, 0, stream>>>(
      static_cast<const float*>(partials), blocks, static_cast<float*>(z), n);
  return cudaGetLastError();
}

}  // namespace lsqr_chunked_coo
