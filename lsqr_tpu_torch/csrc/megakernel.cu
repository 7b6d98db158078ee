// Iteration megakernels for Hopper (sm_90a): K whole LSQR, LSMR or CRAIG
// iterations per launch on the packed DIA stripes (data (nd, m) and its
// transpose tdata (nd, n), as in dia_packed.cu).
//
// Kernels and the TPU kernels they replace:
//
// 1. lsqr_megakernel  <- lsqr_tpu/ops/megakernel.py:411 _cached_call / _kernel
// 2. lsmr_megakernel  <- lsqr_tpu/ops/megakernel_lsmr.py:332 / _kernel
// 3. craig_megakernel <- lsqr_tpu/ops/megakernel_craig.py:195 / _kernel
//
// What each computes per launch is what the JAX kernel computes over its
// grid (K, 3, nt): K iterations of three phases each, the scalar recurrence
// at each phase boundary, iterations after istop != 0 masked out, and the
// stopping tests of iteration k deferred to iteration k+1's first boundary
// (they need a norm reduced in the last phase). Phase order:
//   LSQR, LSMR: p0 forward half-step over m (u), p1 adjoint over n (v),
//               p2 vector update over n (x, w / x, h, hbar);
//   CRAIG:      p0 x update over n, p1 forward over m, p2 adjoint over n.
// The state is a flat f32 array of 64 scalars with the JAX package's named
// indices (the enums below; a CPU test holds them to the Python modules).
// u and v are carried unnormalized, scaled through the state coefficients.
//
// What bounds them on the H100: bytes per iteration, the stripes (data and
// tdata once each) and the vector passes (f32, m = n long) that the
// barriers leave: the adjoint's 3 (u, v read; v written), and the update's
// with the next forward's, which share one read of v (LSQR 7: u, v, x, w
// read, u, x, w written; LSMR 9; CRAIG 5): 10, 12 and 8 an iteration; plus
// one grid-wide barrier per phase. The JAX design keeps the vectors
// resident in VMEM; a CUDA block has no such room, so this design is:
// * a persistent cooperative grid (cudaLaunchCooperativeKernel) sized at
//   the co-resident limit of the route's kernel and shared memory;
// * the two product phases (forward over m on data, adjoint over n on
//   tdata: each "out[i] = -c2 out[i] + sum_d rows[d][i] (vec[i + k_d] c1)"
//   on its own packed array, stride m or n) staged: a block walks tiles of
//   T = 512 outputs (tiles b, b + grid, ...) and keeps kMkStages = 2 of
//   them in shared memory, the next tile's 16-byte cp.async copies in
//   flight while it sums this one (as dia_shared.cu's staged half-step, row
//   3). A stage holds each diagonal's T stripe elements rounded out to 16
//   bytes (each diagonal at the 16-byte phase of its own address: the
//   stride is generally not a multiple of 16 bytes), the vector window
//   [c0 + k_min, c0 + T + k_max) clipped to the input dimension, and the
//   tile's T rows of out (its y), each vector at the phase of its own
//   address. No halo is recomputed. The vector is read once a tile from
//   shared memory, not once a diagonal through L2, and each stripe byte
//   crosses once with many copies in flight. Each thread sums kMkRows = 2
//   outputs 256 apart side by side (one a thread was 20-30% slower in
//   bf16, PERF.md), and the staged kernels' registers are capped so that
//   kMkBlocks = 4 blocks fit an SM (at the 110-119 registers the compiler
//   chose otherwise two fit: 17-28% slower, PERF.md). The megakernels keep
//   this staging apart from row 3's: one walk for both (a per-diagonal
//   phase table, an optional sum of squares) cost row 3 0.5-2% at 2^23 x
//   11 and 2.5-6% at 2^20 x 81 on the H100 (PERF.md);
// * T comes from ops/spmv.py: mk_tile (MkLayout's bytes, mirrored there as
//   mk_stage_bytes: change both together): 512 where the stages fit one
//   block's shared memory and the vector window T + lo + hi is at most
//   MK_SPREAD = 3 times the direct route's vector reads, nd T (a sparse
//   band spread wider copies more window than it saves: offsets -4096,
//   -1, 0, 1, 4096 at 2^24 ran 30-38% slower staged), else 0: both
//   product phases then take the direct route, kernels of their own
//   without the register cap (as many blocks an SM as their registers
//   allow): one thread an output in a grid-stride loop, reading its stripe
//   elements and, once a diagonal, the vector through L2 (forward_direct,
//   adjoint_direct). The routes give a thread other outputs, so their sums
//   of squares round differently: they agree to 1e-4 relative (the tests'
//   MK_TOL), not bit for bit;
// * phases separated by cooperative groups' grid.sync(): 3 barriers per
//   LSQR or LSMR iteration, 2 per CRAIG iteration (its x update needs no
//   reduction and touches nothing the forward phase reads);
// * reductions without float atomics: each block writes its partial sum to
//   a fixed slot (one slot set per reducing phase, so a fast block never
//   overwrites a slot another block still reads); after the barrier every
//   block sums all slots in the same fixed order, so every block holds the
//   same scalar and runs the O(1) recurrence itself from its shared-memory
//   copy of the state. Block 0 writes the state back at the end. The
//   result does not depend on block timing;
// * vectors written by other blocks inside the launch are read through L2
//   only (__ldcg, cp.async.cg), never through the non-coherent L1, and a
//   phase stages its vectors only after the barrier that ends the phase
//   that wrote them; the stripes are read-only. Every copy a phase issues
//   is waited for inside that phase, so none is outstanding at a barrier,
//   when the phases are skipped or when a block returns;
// * once every block sees istop != 0 the phases skip their vector work and
//   their barriers, so a converged solve's masked iterations cost only the
//   scalar code.
// Stripes are f32 or bf16 (widened to f32 on load); vectors and state f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_pair_staged.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kState = 64;
constexpr int kMkStages = 2;  // tiles of a staged phase in shared memory, the one summed included
constexpr int kMkRows = 2;    // outputs a thread sums side by side: T = kThreads * kMkRows
constexpr int kMkBatch = 4;   // diagonals whose loads a thread issues together
constexpr int kMkBlocks = 4;  // blocks an SM the staged kernels' registers leave room for
static_assert(kMkStages >= 2 && kMkBatch % 4 == 0, "staged phase shape");

// clang-format off
namespace lsqr_idx {
enum : int { ALPHA, BETA, RHOBAR, PHIBAR, ANORM, DNORM, RES2, PSI, XNORM, XNORM1, CS2, SN2, ZROW, DXMAX, MAXDX, ITN, ISTOP, NSTOP, SSQ_U, SSQ_V, SSQ_DK, RNORM, ARNORM, ACOND, BNORM, DAMP, ATOL, BTOL, CTOL, ITNLIM, NCONV, DAMPED, C1F, C2F, C1A, C2A, BPOS, T1, T2, T3, INVA, PHI, THETA, RHO, TAU, APREV, ACT0 };
}
namespace lsmr_idx {
enum : int { ALPHA, BETA, ALPHABAR, RHO, RHOBAR, CBAR, SBAR, ZETA, ZETABAR, BETADD, BETAD, RHODOLD, TAUTILDEOLD, THETATILDE, DACC, NORMA2, MAXRBAR, MINRBAR, NORMR, NORMAR, NORMA, CONDA, NORMX, ITN, ISTOP, SSQ_U, SSQ_V, SSQ_X, C1F, C2F, C1A, C2A, BPOS, CHB, CX, CH, INVA, APREV, ACT0, NORMB, ATOL, BTOL, CTOL, ITNLIM, DAMP };
}
namespace craig_idx {
enum : int { ALPHA, BETA, Y, CY, ANORM2, XNORM2, RNORM, ITN, ISTOP, SSQ_U, SSQ_V, C1F, C2F, C1A, C2A, BPOS, APREV, ACT0, BNORM, ATOL, BTOL, ITNLIM };
}
// clang-format on

enum Solver : int { kLSQR = 0, kLSMR = 1, kCRAIG = 2 };

template <typename S>
struct Params {
  const S* data;        // (nd, m)
  const S* tdata;       // (nd, n)
  const int* offsets;   // k_d
  const int* toffsets;  // -k_d
  int nd;
  long long m, n;
  float *u, *v, *x, *w, *hbar;  // w: LSQR's w, LSMR's h
  float* state;
  float* partial;  // 3 * gridDim.x slots
  int K;
  int lo, hi;  // the forward's halos max(0, -k_min), max(0, k_max) (the adjoint's swapped)
  int T;       // the staged phases' tile; 0: the direct phases
};

// A staged phase's shared memory: kMkStages stages, each nd rows of L = T
// + V stripe elements (V = 16 bytes' worth), the vector window (T + lo +
// hi floats and up to 3 in front, rounded up to 4) and y (T floats and up
// to 3 in front); then four ints a diagonal (nd rounded up to 4): each
// direction's offsets and 16-byte row phases. Both directions share it
// (their lo + hi is the same). ops/spmv.py: mk_stage_bytes mirrors it.
struct MkLayout {
  long long L, LX, stage, tables, bytes;
  int nd4;
  __host__ __device__ MkLayout(int nd, int halo, int T, int esize) {
    nd4 = (nd + 3) / 4 * 4;
    L = static_cast<long long>(T) + 16 / esize;
    LX = round_up(static_cast<long long>(T) + halo + 3, 4);
    stage = static_cast<long long>(nd) * L * esize + (LX + T + 4) * 4;
    tables = kMkStages * stage;
    bytes = T ? tables + 16LL * nd4 : 0;
  }
};

__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float d2(float a, float b) {
  const float scale = fabsf(a) + fabsf(b);
  const float safe = scale > 0.f ? scale : 1.f;
  const float ra = a / safe, rb = b / safe;
  return scale > 0.f ? safe * sqrtf(ra * ra + rb * rb) : 0.f;
}

__device__ __forceinline__ float safe_div(float num, float den) {
  return den != 0.f ? num / den : 0.f;
}

// Stable Givens rotation, the branchless form of lsqr_tpu/lsmr.py:101-129.
__device__ void sym_ortho(float a, float b, float& c, float& s, float& r) {
  const float absa = fabsf(a), absb = fabsf(b);
  const float sign_a = a >= 0.f ? 1.f : -1.f;
  const float sign_b = b >= 0.f ? 1.f : -1.f;
  const float safe_b = b != 0.f ? b : 1.f;
  const float tau_ab = a / safe_b;
  const float s_b = sign_b / sqrtf(1.f + tau_ab * tau_ab);
  const float c_b = s_b * tau_ab;
  const float r_b = safe_b / s_b;
  const float safe_a = a != 0.f ? a : 1.f;
  const float tau_ba = b / safe_a;
  const float c_a = sign_a / sqrtf(1.f + tau_ba * tau_ba);
  const float s_a = c_a * tau_ba;
  const float r_a = safe_a / c_a;
  if (b == 0.f) {
    c = sign_a; s = 0.f; r = absa;
  } else if (a == 0.f) {
    c = 0.f; s = sign_b; r = absb;
  } else if (absb > absa) {
    c = c_b; s = s_b; r = r_b;
  } else {
    c = c_a; s = s_a; r = r_a;
  }
}

// Sum over the block in a fixed tree order; every thread must call it.
__device__ float block_sum(float v, float* red) {
  __syncthreads();  // red may still be read from the previous call
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// The grid's total of one reducing phase: write this block's partial, wait
// for every block, then sum all slots in a fixed order (same in every block).
__device__ float grid_total(float local, float* slots, float* red, cg::grid_group& grid) {
  const float mine = block_sum(local, red);
  if (threadIdx.x == 0) slots[blockIdx.x] = mine;
  grid.sync();
  float acc = 0.f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) acc += ld(slots + b);
  return block_sum(acc, red);
}

// --- the phase bodies ----------------------------------------------------

// The direct route (T = 0), one thread an output in a grid-stride loop,
// each reading its stripe elements and, once a diagonal, the vector
// through L2. u = A (v * c1) - c2 * u over the m rows of data; returns
// this thread's sum(u^2).
template <typename S>
__device__ float forward_direct(const Params<S>& p, float c1, float c2) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float local = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.m; i += stride) {
    float acc = (-c2) * ld(p.u + i);
    for (int d = 0; d < p.nd; ++d) {
      const long long c = i + __ldg(p.offsets + d);
      if (c >= 0 && c < p.n) acc += widen(p.data + d * p.m + i) * (ld(p.v + c) * c1);
    }
    p.u[i] = acc;
    local += acc * acc;
  }
  return local;
}

// v = bpos ? A' (u * c1) - c2 * v : v over the n rows of tdata; sum(v^2).
template <typename S>
__device__ float adjoint_direct(const Params<S>& p, float c1, float c2, bool bpos) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float local = 0.f;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < p.n; j += stride) {
    const float vold = ld(p.v + j);
    float acc = (-c2) * vold;
    for (int d = 0; d < p.nd; ++d) {
      const long long r = j + __ldg(p.toffsets + d);
      if (r >= 0 && r < p.m) acc += widen(p.tdata + d * p.n + j) * (ld(p.u + r) * c1);
    }
    acc = bpos ? acc : vold;
    p.v[j] = acc;
    local += acc * acc;
  }
  return local;
}

// One direction of a staged phase: out[i] = -c2 out[i] + sum_d
// rows[d * stride + i] (vec[i + kk[d]] c1) for i in [0, dim_out), the
// vector index masked to [0, dim_in); lo, hi its halos; dm[d] the 16-byte
// phase of rows + d * stride; phx, phy those of vec and out.
template <typename S>
struct Side {
  const S* rows;
  long long stride;
  const float* vec;
  float* out;
  const int* kk;
  const int* dm;
  long long dim_out, dim_in;
  int lo, hi, phx, phy;
};

// The offsets (forward k_d, adjoint -k_d) and the 16-byte phase of each
// diagonal's row of data (stride m) and tdata (stride n), into shared
// memory after the stages.
template <typename S>
__device__ void load_tables(const Params<S>& p, unsigned char* smem, const MkLayout& lay) {
  constexpr int V = 16 / sizeof(S);
  int* const t = reinterpret_cast<int*>(smem + lay.tables);
  const long long pf = reinterpret_cast<uintptr_t>(p.data) / sizeof(S);
  const long long pa = reinterpret_cast<uintptr_t>(p.tdata) / sizeof(S);
  for (int d = threadIdx.x; d < p.nd; d += blockDim.x) {
    t[d] = __ldg(p.offsets + d);
    t[lay.nd4 + d] = __ldg(p.toffsets + d);
    t[2 * lay.nd4 + d] = static_cast<int>((pf + d * p.m) & (V - 1));
    t[3 * lay.nd4 + d] = static_cast<int>((pa + d * p.n) & (V - 1));
  }
}

__device__ __forceinline__ int phase4(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / 4) & 3);
}

// Stage the tile [c0, c0 + T) of one side into `buf` (no commit): each
// copy starts at the 16-byte boundary at or before its first element.
template <typename S>
__device__ __forceinline__ void mk_stage(unsigned char* buf, const MkLayout& lay,
                                         const Side<S>& sd, int nd, int T, long long c0) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(sd.dim_out - c0 < T ? sd.dim_out - c0 : T);
  const int P = static_cast<int>(lay.L / V);  // 16-byte pieces a row holds
  const int cm = static_cast<int>(c0 & (V - 1));
  S* const st = reinterpret_cast<S*>(buf);
  for (int e = threadIdx.x; e < nd * P; e += blockDim.x) {
    const int d = e / P, q = (e - d * P) * V;
    const int sh = (sd.dm[d] + cm) & (V - 1);
    if (q < sh + len) cp_async16(st + d * lay.L + q, sd.rows + d * sd.stride + c0 - sh + q);
  }
  float* const xs = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S));
  const long long xa = c0 - sd.lo > 0 ? c0 - sd.lo : 0;
  const long long xb = c0 + len + sd.hi < sd.dim_in ? c0 + len + sd.hi : sd.dim_in;
  if (xa < xb) {
    const int shx = static_cast<int>((sd.phx + xa) & 3);
    for (int q = threadIdx.x * 4; q < shx + (xb - xa); q += blockDim.x * 4) {
      cp_async16(xs + q, sd.vec + xa - shx + q);
    }
  }
  float* const ys = xs + lay.LX;
  const int shy = static_cast<int>((sd.phy + c0) & 3);
  for (int q = threadIdx.x * 4; q < shy + len; q += blockDim.x * 4) {
    cp_async16(ys + q, sd.out + c0 - shy + q);
  }
}

// Sum the staged tile [c0, c0 + T) into out and add the squares of what is
// written to `local`: R outputs a thread, kThreads apart, -c2 y first and
// then the diagonals in offset order, kMkBatch diagonals' loads issued
// before they are added (the direct phases' order and expressions); an
// output whose whole band lies inside [0, dim_in) skips the mask. keep:
// write y back unchanged (the adjoint when bpos is false).
template <typename S, int R>
__device__ __forceinline__ float mk_sum(const unsigned char* buf, const MkLayout& lay,
                                        const Side<S>& sd, int nd, float c1, float c2,
                                        bool keep, long long c0, float local) {
  constexpr int V = 16 / sizeof(S);
  constexpr int B = kMkBatch;
  const S* const st = reinterpret_cast<const S*>(buf);
  const float* const xs = reinterpret_cast<const float*>(buf + nd * lay.L * sizeof(S));
  const float* const ys = xs + lay.LX + ((sd.phy + c0) & 3);  // y[c0 + t] at ys[t]
  const long long xa = c0 - sd.lo > 0 ? c0 - sd.lo : 0;
  const int cm = static_cast<int>(c0 & (V - 1));
  const int t0 = threadIdx.x;
  const long long i0 = c0 + t0;  // this thread's outputs i0 + kThreads q
  const float* const xb = xs + ((sd.phx + xa) & 3) + (i0 - xa);  // vec[i0 + kThreads q + k]
  const int nb = nd / B * B;  // diagonals taken in whole batches
  float acc[R], yv[R];
  bool ok[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    ok[q] = i0 + q * kThreads < sd.dim_out;
    yv[q] = ok[q] ? ys[t0 + q * kThreads] : 0.f;
    acc[q] = (-c2) * yv[q];
  }
  if (ok[R - 1] && i0 >= sd.lo && i0 + (R - 1) * kThreads + sd.hi < sd.dim_in) {
    for (int d = 0; d < nb; d += B) {
      int kq[B], mq[B];
#pragma unroll
      for (int b = 0; b < B; b += 4) {
        const int4 k4 = *reinterpret_cast<const int4*>(sd.kk + d + b);
        const int4 m4 = *reinterpret_cast<const int4*>(sd.dm + d + b);
        kq[b] = k4.x, kq[b + 1] = k4.y, kq[b + 2] = k4.z, kq[b + 3] = k4.w;
        mq[b] = m4.x, mq[b + 1] = m4.y, mq[b + 2] = m4.z, mq[b + 3] = m4.w;
      }
      float sv[R][B], xv[R][B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const S* sp = st + (d + b) * lay.L + ((mq[b] + cm) & (V - 1)) + t0;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          sv[q][b] = lds(sp + q * kThreads);
          xv[q][b] = xb[q * kThreads + kq[b]];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int b = 0; b < B; ++b) acc[q] += sv[q][b] * (xv[q][b] * c1);
      }
    }
    for (int d = nb; d < nd; ++d) {
      const int k = sd.kk[d];
      const S* sp = st + d * lay.L + ((sd.dm[d] + cm) & (V - 1)) + t0;
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] += lds(sp + q * kThreads) * (xb[q * kThreads + k] * c1);
    }
  } else {
    for (int d = 0; d < nd; ++d) {
      const int k = sd.kk[d];
      const S* sp = st + d * lay.L + ((sd.dm[d] + cm) & (V - 1)) + t0;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long long src = i0 + q * kThreads + k;
        if (ok[q] && src >= 0 && src < sd.dim_in) {
          acc[q] += lds(sp + q * kThreads) * (xb[q * kThreads + k] * c1);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (ok[q]) {
      const float a = keep ? yv[q] : acc[q];
      sd.out[i0 + q * kThreads] = a;
      local += a * a;
    }
  }
  return local;
}

// A staged phase: block b walks the tiles b, b + grid, ... of T outputs,
// kMkStages of them in shared memory. Each step waits for its tile's
// copies, synchronises (so every thread has also left the tile before,
// whose stage the next copies reuse), stages the tile kMkStages - 1 ahead
// and sums its own. Every tile copied is waited for in the loop, so no
// copy is outstanding when the phase returns; the barrier in grid_total
// after it orders the next phase's copies after this phase's last reads.
template <typename S>
__device__ float staged_phase(const Side<S>& sd, int nd, int T, float c1, float c2,
                              bool keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MkLayout lay(nd, sd.lo + sd.hi, T, sizeof(S));
  const long long grid = gridDim.x;
  const long long tiles = (sd.dim_out + T - 1) / T;
#pragma unroll
  for (int s = 0; s < kMkStages - 1; ++s) {
    const long long tile = blockIdx.x + s * grid;
    if (tile < tiles) mk_stage(smem + s * lay.stage, lay, sd, nd, T, tile * T);
    cp_async_commit();
  }
  float local = 0.f;
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    cp_async_wait_group<kMkStages - 2>();  // this tile's copies
    __syncthreads();
    const long long ahead = tile + (kMkStages - 1) * grid;
    if (ahead < tiles) {
      mk_stage(smem + (it + kMkStages - 1) % kMkStages * lay.stage, lay, sd, nd, T, ahead * T);
    }
    cp_async_commit();
    local = mk_sum<S, kMkRows>(smem + it % kMkStages * lay.stage, lay, sd, nd, c1, c2, keep,
                               tile * T, local);
  }
  cp_async_wait_group<0>();  // the empty groups of the last steps
  return local;
}

// A staged phase's side on the tables load_tables wrote: the forward
// (data, v into u) or the adjoint (tdata, u into v, halos swapped).
template <typename S>
__device__ __forceinline__ Side<S> side(const Params<S>& p, bool adjoint) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MkLayout lay(p.nd, p.lo + p.hi, p.T, sizeof(S));
  const int* const t = reinterpret_cast<const int*>(smem + lay.tables);
  if (adjoint) {
    return {p.tdata, p.n, p.u, p.v, t + lay.nd4, t + 3 * lay.nd4, p.n, p.m, p.hi, p.lo,
            phase4(p.u), phase4(p.v)};
  }
  return {p.data, p.m, p.v, p.u, t, t + 2 * lay.nd4, p.m, p.n, p.lo, p.hi, phase4(p.v),
          phase4(p.u)};
}

// u = A (v * c1) - c2 * u over the m rows of data; returns this thread's
// sum(u^2).
template <typename S, bool Staged>
__device__ float forward(const Params<S>& p, float c1, float c2) {
  if (!Staged) return forward_direct(p, c1, c2);
  return staged_phase(side(p, false), p.nd, p.T, c1, c2, false);
}

// v = bpos ? A' (u * c1) - c2 * v : v over the n rows of tdata; returns
// this thread's sum(v^2).
template <typename S, bool Staged>
__device__ float adjoint(const Params<S>& p, float c1, float c2, bool bpos) {
  if (!Staged) return adjoint_direct(p, c1, c2, bpos);
  return staged_phase(side(p, true), p.nd, p.T, c1, c2, !bpos);
}

// --- LSQR: the scalar boundaries of lsqr_tpu/ops/megakernel.py:109-266 ----

__device__ void lsqr_p0(float* s) {
  using namespace lsqr_idx;
  if (s[ITN] > 0.5f) {  // the previous iteration's monitors and tests
    const bool active = s[ISTOP] == 0.f;
    const float dknorm = sqrtf(s[SSQ_DK]);
    const float dnorm = d2(s[DNORM], dknorm);
    const float dxk = fabsf(s[PHI] * dknorm);
    const bool new_max = s[DXMAX] < dxk;
    const float dxmax = new_max ? dxk : s[DXMAX];
    const float maxdx = new_max ? s[ITN] : s[MAXDX];
    const float anorm = s[ANORM];
    const float acond = anorm * dnorm;
    const float rnorm = s[RNORM];
    const float arnorm = s[ALPHA] * fabsf(s[TAU]);
    const float safe_b = s[BNORM] > 0.f ? s[BNORM] : 1.f;
    const float test1 = rnorm / safe_b;
    const float test2 = rnorm > 0.f ? arnorm / (anorm * rnorm) : 0.f;
    const float test3 = 1.f / (acond > 0.f ? acond : 1.f);
    const float xnorm = s[XNORM];
    const float t1rel = test1 / (1.f + anorm * xnorm / safe_b);
    const float rtol = s[BTOL] + s[ATOL] * anorm * xnorm / safe_b;
    float istop = 0.f;
    if (s[ITN] >= s[ITNLIM]) istop = 5.f;
    if (1.f + test3 <= 1.f) istop = 4.f;
    if (1.f + test2 <= 1.f) istop = 2.f;
    if (1.f + t1rel <= 1.f) istop = 1.f;
    if (test3 <= s[CTOL]) istop = 4.f;
    if (test2 <= s[ATOL]) istop = 2.f;
    if (test1 <= rtol) istop = 1.f;
    const float nstop = istop == 0.f ? 0.f : s[NSTOP] + 1.f;
    if (istop != 0.f && nstop < s[NCONV] && s[ITN] < s[ITNLIM]) istop = 0.f;
    if (active) {
      s[DNORM] = dnorm; s[DXMAX] = dxmax; s[MAXDX] = maxdx; s[ACOND] = acond;
      s[ARNORM] = arnorm; s[ISTOP] = istop; s[NSTOP] = nstop;
    }
  }
  // this iteration's forward coefficients: u = A (v/alpha) - (alpha/beta) u
  const float alpha = s[ALPHA], beta = s[BETA];
  const float inv_a = alpha > 0.f ? 1.f / alpha : 0.f;
  const float inv_b = beta > 0.f ? 1.f / beta : 0.f;
  s[C1F] = inv_a; s[C2F] = alpha * inv_b; s[APREV] = alpha; s[SSQ_U] = 0.f;
}

__device__ void lsqr_p1(float* s) {
  using namespace lsqr_idx;
  const bool active = s[ISTOP] == 0.f;
  const float beta = sqrtf(s[SSQ_U]);
  const float aprev = s[APREV];
  float temp = d2(aprev, beta);
  temp = d2(temp, s[DAMP]);
  const float anorm = d2(s[ANORM], temp);
  const float inv_b = beta > 0.f ? 1.f / beta : 0.f;
  const float inv_ap = aprev > 0.f ? 1.f / aprev : 0.f;
  if (active) { s[BETA] = beta; s[ANORM] = anorm; }
  s[BPOS] = active && beta > 0.f ? 1.f : 0.f;
  s[C1A] = inv_b; s[C2A] = beta * inv_ap; s[SSQ_V] = 0.f;
}

__device__ void lsqr_p2(float* s) {
  using namespace lsqr_idx;
  const bool active = s[ISTOP] == 0.f;
  const float alpha = s[BPOS] > 0.5f ? sqrtf(s[SSQ_V]) : s[APREV];
  const float itn = s[ITN] + 1.f;
  // damp-elimination rotation (lsqr.f90:703-710)
  const bool damped = s[DAMPED] > 0.5f;
  const float rhbar1_d = d2(s[RHOBAR], s[DAMP]);
  const float safe_r1 = rhbar1_d > 0.f ? rhbar1_d : 1.f;
  const float cs1 = s[RHOBAR] / safe_r1, sn1 = s[DAMP] / safe_r1;
  const float psi = damped ? sn1 * s[PHIBAR] : s[PSI];
  const float phibar0 = damped ? cs1 * s[PHIBAR] : s[PHIBAR];
  const float rhbar1 = damped ? rhbar1_d : s[RHOBAR];
  // Givens rotation (lsqr.f90:714-721)
  const float beta = s[BETA];
  const float rho = d2(rhbar1, beta);
  const float safe_rho = rho > 0.f ? rho : 1.f;
  const float cs = rhbar1 / safe_rho, sn = beta / safe_rho;
  const float theta = sn * alpha, rhobar = -cs * alpha;
  const float phi = cs * phibar0, phibar = sn * phibar0, tau = sn * phi;
  const float t1 = phi / safe_rho, t2 = -theta / safe_rho, t3 = 1.f / safe_rho;
  const float inv_an = alpha > 0.f ? 1.f / alpha : 1.f;
  // xnorm estimator (lsqr.f90:759-771)
  const float delta = s[SN2] * rho, gambar = -s[CS2] * rho;
  const float rhs = phi - delta * s[ZROW];
  const float zbar = rhs / (gambar != 0.f ? gambar : 1.f);
  const float xnorm = d2(s[XNORM1], zbar);
  const float gamma = d2(gambar, theta);
  const float safe_g = gamma > 0.f ? gamma : 1.f;
  const float cs2 = gambar / safe_g, sn2 = theta / safe_g, z = rhs / safe_g;
  const float xnorm1 = d2(s[XNORM1], z);
  const float res2 = d2(s[RES2], psi);
  const float rnorm = d2(res2, phibar);
  if (active) {
    s[ALPHA] = alpha; s[ITN] = itn; s[RHOBAR] = rhobar; s[PHIBAR] = phibar;
    s[PSI] = psi; s[XNORM] = xnorm; s[XNORM1] = xnorm1; s[CS2] = cs2; s[SN2] = sn2;
    s[ZROW] = z; s[RES2] = res2; s[RNORM] = rnorm; s[PHI] = phi; s[THETA] = theta;
    s[RHO] = rho; s[TAU] = tau; s[SSQ_DK] = 0.f;
  }
  s[T1] = t1; s[T2] = t2; s[T3] = t3; s[INVA] = inv_an;
}

// --- LSMR: the boundaries of lsqr_tpu/ops/megakernel_lsmr.py:121-261 ------

__device__ void lsmr_p0(float* s) {
  using namespace lsmr_idx;
  if (s[ITN] > 0.5f) {
    const bool active = s[ISTOP] == 0.f;
    const float normx = sqrtf(s[SSQ_X]);
    const float safe_b = s[NORMB] > 0.f ? s[NORMB] : 1.f;
    const float normr = s[NORMR], norma = s[NORMA], conda = s[CONDA], normar = s[NORMAR];
    const float test1 = normr / safe_b;
    const float denom2 = norma * normr;
    const float test2 = denom2 > 0.f ? normar / denom2 : __int_as_float(0x7f800000);
    const float test3 = 1.f / (conda > 0.f ? conda : 1.f);
    const float t1 = test1 / (1.f + norma * normx / safe_b);
    const float rtol = s[BTOL] + s[ATOL] * norma * normx / safe_b;
    float istop = 0.f;
    if (s[ITN] >= s[ITNLIM]) istop = 7.f;
    if (1.f + test3 <= 1.f) istop = 6.f;
    if (1.f + test2 <= 1.f) istop = 5.f;
    if (1.f + t1 <= 1.f) istop = 4.f;
    if (test3 <= s[CTOL]) istop = 3.f;
    if (test2 <= s[ATOL]) istop = 2.f;
    if (test1 <= rtol) istop = 1.f;
    if (active) { s[NORMX] = normx; s[ISTOP] = istop; }
  }
  const float alpha = s[ALPHA], beta = s[BETA];
  s[C1F] = safe_div(1.f, alpha); s[C2F] = alpha * safe_div(1.f, beta);
  s[APREV] = alpha; s[SSQ_U] = 0.f;
}

__device__ void lsmr_p1(float* s) {
  using namespace lsmr_idx;
  const bool active = s[ISTOP] == 0.f;
  const float beta = sqrtf(s[SSQ_U]);
  const float aprev = s[APREV];
  if (active) s[BETA] = beta;
  s[BPOS] = active && beta > 0.f ? 1.f : 0.f;
  s[C1A] = safe_div(1.f, beta); s[C2A] = beta * safe_div(1.f, aprev); s[SSQ_V] = 0.f;
}

__device__ void lsmr_p2(float* s) {
  using namespace lsmr_idx;
  const bool active = s[ISTOP] == 0.f;
  const float alpha = s[BPOS] > 0.5f ? sqrtf(s[SSQ_V]) : s[APREV];
  const float beta = s[BETA];
  const float itn = s[ITN] + 1.f;
  float chat, shat, alphahat;  // rotation Phat: eliminate damp
  sym_ortho(s[ALPHABAR], s[DAMP], chat, shat, alphahat);
  const float rhoold = s[RHO];  // rotation P: eliminate beta
  float cgiv, sgiv, rho;
  sym_ortho(alphahat, beta, cgiv, sgiv, rho);
  const float thetanew = sgiv * alpha, alphabar = cgiv * alpha;
  const float rhobarold = s[RHOBAR], zetaold = s[ZETA];  // rotation Pbar
  const float thetabar = s[SBAR] * rho, rhotemp = s[CBAR] * rho;
  float cbar, sbar, rhobar;
  sym_ortho(s[CBAR] * rho, thetanew, cbar, sbar, rhobar);
  const float zeta = cbar * s[ZETABAR], zetabar = -sbar * s[ZETABAR];
  const float c_hb = safe_div(thetabar * rho, rhoold * rhobarold);
  const float c_x = safe_div(zeta, rho * rhobar);
  const float c_h = safe_div(thetanew, rho);
  const float inva = alpha > 0.f ? 1.f / alpha : 1.f;
  // ||r|| recurrence
  const float betaacute = chat * s[BETADD], betacheck = -shat * s[BETADD];
  const float betahat = cgiv * betaacute, betadd = -sgiv * betaacute;
  const float thetatildeold = s[THETATILDE];
  float ctold, stold, rhotildeold;
  sym_ortho(s[RHODOLD], thetabar, ctold, stold, rhotildeold);
  const float thetatilde = stold * rhobar, rhodold = ctold * rhobar;
  const float betad = -stold * s[BETAD] + ctold * betahat;
  const float tautildeold = safe_div(zetaold - thetatildeold * s[TAUTILDEOLD], rhotildeold);
  const float taud = safe_div(zeta - thetatilde * tautildeold, rhodold);
  const float dacc = s[DACC] + betacheck * betacheck;
  const float bd_taud = betad - taud;
  const float normr = sqrtf(dacc + bd_taud * bd_taud + betadd * betadd);
  // ||A|| and cond(A) estimates
  float na2 = s[NORMA2] + beta * beta;
  const float norma = sqrtf(na2);
  na2 = na2 + alpha * alpha;
  const float maxrbar = fmaxf(s[MAXRBAR], rhobarold);
  const float minrbar = itn > 1.5f ? fminf(s[MINRBAR], rhobarold) : s[MINRBAR];
  const float num = fmaxf(maxrbar, rhotemp), den = fminf(minrbar, rhotemp);
  const float conda = num / (den > 0.f ? den : 1.f);
  const float normar = fabsf(zetabar);
  if (active) {
    s[ALPHA] = alpha; s[ITN] = itn; s[ALPHABAR] = alphabar; s[RHO] = rho;
    s[RHOBAR] = rhobar; s[CBAR] = cbar; s[SBAR] = sbar; s[ZETA] = zeta;
    s[ZETABAR] = zetabar; s[BETADD] = betadd; s[BETAD] = betad; s[RHODOLD] = rhodold;
    s[TAUTILDEOLD] = tautildeold; s[THETATILDE] = thetatilde; s[DACC] = dacc;
    s[NORMA2] = na2; s[MAXRBAR] = maxrbar; s[MINRBAR] = minrbar; s[NORMR] = normr;
    s[NORMAR] = normar; s[NORMA] = norma; s[CONDA] = conda; s[SSQ_X] = 0.f;
  }
  s[CHB] = c_hb; s[CX] = c_x; s[CH] = c_h; s[INVA] = inva;
}

// --- CRAIG: the boundaries of lsqr_tpu/ops/megakernel_craig.py:77-135 -----

__device__ void craig_p0(float* s) {
  using namespace craig_idx;
  if (s[ITN] > 0.5f) {  // finish the previous iteration: alpha, the tests
    const bool active = s[ISTOP] == 0.f;
    const bool bpos = s[BPOS] > 0.5f;
    const float alpha_cand = sqrtf(s[SSQ_V]);
    const bool apos = alpha_cand > 0.f;
    const float alpha = bpos && apos ? alpha_cand : s[ALPHA];
    const float anorm2 =
        s[ANORM2] + (bpos ? s[BETA] * s[BETA] + (apos ? alpha_cand * alpha_cand : 0.f) : 0.f);
    const float anorm = sqrtf(anorm2), xnorm = sqrtf(s[XNORM2]);
    const float safe_b = s[BNORM] > 0.f ? s[BNORM] : 1.f;
    const float test1 = s[RNORM] / safe_b;
    const float rtol = s[BTOL] + s[ATOL] * anorm * xnorm / safe_b;
    float istop = 0.f;
    if (s[ITN] >= s[ITNLIM]) istop = 5.f;
    if (bpos && !apos) istop = 4.f;
    if (1.f + test1 <= 1.f) istop = 2.f;
    if (test1 <= rtol) istop = 1.f;
    if (!bpos) istop = 1.f;
    if (active) { s[ALPHA] = alpha; s[ANORM2] = anorm2; s[ISTOP] = istop; }
  }
  // this iteration's forward-substitution scalar and coefficients
  const bool active = s[ISTOP] == 0.f;
  const float alpha = s[ALPHA], beta = s[BETA];
  const float itn = s[ITN] + 1.f;
  const float ratio = safe_div(beta, alpha);
  const float y = itn < 1.5f ? ratio : -ratio * s[Y];
  const float inv_a = safe_div(1.f, alpha);
  s[CY] = active ? y * inv_a : 0.f;
  if (active) { s[Y] = y; s[XNORM2] = s[XNORM2] + y * y; s[ITN] = itn; }
  s[C1F] = inv_a; s[C2F] = alpha * safe_div(1.f, beta); s[APREV] = alpha; s[SSQ_U] = 0.f;
}

__device__ void craig_p2(float* s) {
  using namespace craig_idx;
  const bool active = s[ISTOP] == 0.f;
  const float beta = sqrtf(s[SSQ_U]);
  const float aprev = s[APREV];
  if (active) {
    s[BETA] = beta; s[BPOS] = beta > 0.f ? 1.f : 0.f; s[RNORM] = beta * fabsf(s[Y]);
  }
  s[C1A] = safe_div(1.f, beta); s[C2A] = beta * safe_div(1.f, aprev); s[SSQ_V] = 0.f;
}

// --- the kernels ---------------------------------------------------------

// Load the state (and, on the staged route, the offset tables) into shared
// memory; false (every block alike) when the setup says there is nothing
// to do (ACT0 = 0: b = 0 or A'b = 0).
template <typename S, bool Staged>
__device__ bool load_state(const Params<S>& p, float* st, int act0) {
  if (threadIdx.x < kState) st[threadIdx.x] = p.state[threadIdx.x];
  if (Staged) {
    extern __shared__ __align__(16) unsigned char smem[];
    load_tables(p, smem, MkLayout(p.nd, p.lo + p.hi, p.T, sizeof(S)));
  }
  __syncthreads();
  return st[act0] > 0.5f;
}

__device__ void store_state(float* state, const float* st) {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < kState) state[threadIdx.x] = st[threadIdx.x];
}

// Thread 0 runs a boundary on the block's state copy; everyone then reads it.
#define BOUNDARY(fn)                  \
  do {                                \
    if (threadIdx.x == 0) fn(st);     \
    __syncthreads();                  \
  } while (0)

template <typename S, bool Staged>
__device__ __forceinline__ void lsqr_body(const Params<S>& p) {
  using namespace lsqr_idx;
  __shared__ float st[kState];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  if (!load_state<S, Staged>(p, st, ACT0)) return;
  float* slots0 = p.partial;
  float* slots1 = p.partial + gridDim.x;
  float* slots2 = p.partial + 2 * gridDim.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int k = 0; k < p.K; ++k) {
    BOUNDARY(lsqr_p0);
    const bool act = st[ISTOP] == 0.f;  // fixed until the next p0
    if (act) {
      const float tot = grid_total(forward<S, Staged>(p, st[C1F], st[C2F]), slots0, red, grid);
      if (threadIdx.x == 0) st[SSQ_U] += tot;
    }
    BOUNDARY(lsqr_p1);
    if (act) {
      const float tot =
          grid_total(adjoint<S, Staged>(p, st[C1A], st[C2A], st[BPOS] > 0.5f), slots1, red, grid);
      if (threadIdx.x == 0) st[SSQ_V] += tot;
    }
    BOUNDARY(lsqr_p2);
    if (act) {  // x += t1 w; w = t2 w + v/alpha; ssq of dk = t3 w
      const float t1 = st[T1], t2 = st[T2], t3 = st[T3], inva = st[INVA];
      float local = 0.f;
      for (long long j = tid; j < p.n; j += stride) {
        const float wold = ld(p.w + j);
        const float vnew = ld(p.v + j) * inva;
        p.x[j] = ld(p.x + j) + t1 * wold;
        p.w[j] = t2 * wold + vnew;
        const float dk = t3 * wold;
        local += dk * dk;
      }
      const float tot = grid_total(local, slots2, red, grid);
      if (threadIdx.x == 0) st[SSQ_DK] += tot;
    }
  }
  store_state(p.state, st);
}

template <typename S, bool Staged>
__device__ __forceinline__ void lsmr_body(const Params<S>& p) {
  using namespace lsmr_idx;
  __shared__ float st[kState];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  if (!load_state<S, Staged>(p, st, ACT0)) return;
  float* slots0 = p.partial;
  float* slots1 = p.partial + gridDim.x;
  float* slots2 = p.partial + 2 * gridDim.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int k = 0; k < p.K; ++k) {
    BOUNDARY(lsmr_p0);
    const bool act = st[ISTOP] == 0.f;
    if (act) {
      const float tot = grid_total(forward<S, Staged>(p, st[C1F], st[C2F]), slots0, red, grid);
      if (threadIdx.x == 0) st[SSQ_U] += tot;
    }
    BOUNDARY(lsmr_p1);
    if (act) {
      const float tot =
          grid_total(adjoint<S, Staged>(p, st[C1A], st[C2A], st[BPOS] > 0.5f), slots1, red, grid);
      if (threadIdx.x == 0) st[SSQ_V] += tot;
    }
    BOUNDARY(lsmr_p2);
    if (act) {  // hbar = h - chb hbar; x += cx hbar; h = v/alpha - ch h
      const float chb = st[CHB], cx = st[CX], ch = st[CH], inva = st[INVA];
      float local = 0.f;
      for (long long j = tid; j < p.n; j += stride) {
        const float h_old = ld(p.w + j);
        const float hbar_new = h_old - chb * ld(p.hbar + j);
        const float x_new = ld(p.x + j) + cx * hbar_new;
        p.hbar[j] = hbar_new;
        p.x[j] = x_new;
        p.w[j] = ld(p.v + j) * inva - ch * h_old;
        local += x_new * x_new;
      }
      const float tot = grid_total(local, slots2, red, grid);
      if (threadIdx.x == 0) st[SSQ_X] += tot;
    }
  }
  store_state(p.state, st);
}

template <typename S, bool Staged>
__device__ __forceinline__ void craig_body(const Params<S>& p) {
  using namespace craig_idx;
  __shared__ float st[kState];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  if (!load_state<S, Staged>(p, st, ACT0)) return;
  float* slots1 = p.partial + gridDim.x;
  float* slots2 = p.partial + 2 * gridDim.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int k = 0; k < p.K; ++k) {
    BOUNDARY(craig_p0);
    const bool act = st[ISTOP] == 0.f;
    if (act) {
      // p0: x += (y/alpha) v with v_k before its update. The grid.sync()
      // in grid_total after the last adjoint phase orders these reads of v
      // after every block's writes (whichever thread wrote an entry), and
      // the forward phase reads neither x nor writes v, so no barrier is
      // needed here
      const float cy = st[CY];
      for (long long j = tid; j < p.n; j += stride) p.x[j] = ld(p.x + j) + cy * ld(p.v + j);
      const float tot = grid_total(forward<S, Staged>(p, st[C1F], st[C2F]), slots1, red, grid);
      if (threadIdx.x == 0) st[SSQ_U] += tot;
    }
    BOUNDARY(craig_p2);
    if (act) {
      const float tot =
          grid_total(adjoint<S, Staged>(p, st[C1A], st[C2A], st[BPOS] > 0.5f), slots2, red, grid);
      if (threadIdx.x == 0) st[SSQ_V] += tot;
    }
  }
  store_state(p.state, st);
}

#undef BOUNDARY

// Each solver's two kernels: the staged route's, its registers capped so
// that kMkBlocks blocks fit an SM, and the direct route's, uncapped (as
// many blocks as its own registers leave room for).
#define MK_KERNELS(NAME)                                                                  \
  template <typename S>                                                                   \
  __global__ void __launch_bounds__(kThreads, kMkBlocks) NAME##_megakernel_staged(        \
      Params<S> p) {                                                                      \
    NAME##_body<S, true>(p);                                                              \
  }                                                                                       \
  template <typename S>                                                                   \
  __global__ void __launch_bounds__(kThreads) NAME##_megakernel_direct(Params<S> p) {     \
    NAME##_body<S, false>(p);                                                             \
  }

MK_KERNELS(lsqr)
MK_KERNELS(lsmr)
MK_KERNELS(craig)

#undef MK_KERNELS

// The kernel of a route: the staged one (T > 0) or the direct one (T = 0).
template <typename S, int Solver>
const void* kernel_of(int T) {
  if (Solver == kLSQR) {
    return T ? reinterpret_cast<const void*>(&lsqr_megakernel_staged<S>)
             : reinterpret_cast<const void*>(&lsqr_megakernel_direct<S>);
  }
  if (Solver == kLSMR) {
    return T ? reinterpret_cast<const void*>(&lsmr_megakernel_staged<S>)
             : reinterpret_cast<const void*>(&lsmr_megakernel_direct<S>);
  }
  return T ? reinterpret_cast<const void*>(&craig_megakernel_staged<S>)
           : reinterpret_cast<const void*>(&craig_megakernel_direct<S>);
}

// The dynamic shared memory of a launch: the staged phases' (T > 0) or
// none (the direct route).
template <typename S>
long long stage_bytes(int nd, int halo, int T) {
  return MkLayout(nd, halo, T, sizeof(S)).bytes;
}

template <typename S, int Solver>
int grid_size(long long dim, int nd, int halo, int T, int* blocks) {
  *blocks = 0;
  if (T != 0 && (T != kThreads * kMkRows || nd < 1 || halo < 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = stage_bytes<S>(nd, halo, T);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel_of<S, Solver>(T),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<S, Solver>(T),
                                                      kThreads, static_cast<size_t>(bytes));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm < 1) return 0;  // no cooperative launch: 0 blocks
  const long long per_block = T ? T : kThreads;  // outputs a block takes at a time
  const long long need = (dim + per_block - 1) / per_block;
  long long g = static_cast<long long>(per_sm) * sms;
  if (need < g) g = need;
  *blocks = static_cast<int>(g < 1 ? 1 : g);
  return 0;
}

template <typename S, int Solver>
int launch(const void* data, const void* tdata, const void* offsets,
           const void* toffsets, int nd, long long m, long long n, void* u, void* v,
           void* x, void* w, void* hbar, void* state, void* partial, int blocks, int K,
           int lo, int hi, int T, void* stream) {
  if (blocks < 1 || K < 1 || nd < 1 || lo < 0 || hi < 0 ||
      (T != 0 && T != kThreads * kMkRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = stage_bytes<S>(nd, lo + hi, T);
  Params<S> p{static_cast<const S*>(data), static_cast<const S*>(tdata),
              static_cast<const int*>(offsets), static_cast<const int*>(toffsets),
              nd, m, n,
              static_cast<float*>(u), static_cast<float*>(v), static_cast<float*>(x),
              static_cast<float*>(w), static_cast<float*>(hbar),
              static_cast<float*>(state), static_cast<float*>(partial), K, lo, hi, T};
  cudaError_t e = cudaFuncSetAttribute(kernel_of<S, Solver>(T),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_of<S, Solver>(T), dim3(blocks), dim3(kThreads), args, static_cast<size_t>(bytes),
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// The cooperative grid of one megakernel: blocks = min(co-resident blocks
// of the route's kernel with its shared memory, ceil(max(m, n) / 512) on
// the staged route, ceil(max(m, n) / 256) on the direct one), 0 where the
// device has no cooperative launch or no block fits. solver: 0 LSQR, 1
// LSMR, 2 CRAIG; bf16: the stripes' type; nd, halo = lo + hi and T: the
// route's (T = 0: the direct route).
int lsqr_mk_grid(int solver, int bf16, long long dim, int nd, int halo, int T, int* blocks) {
  if (bf16) {
    if (solver == kLSQR) return grid_size<__nv_bfloat16, kLSQR>(dim, nd, halo, T, blocks);
    if (solver == kLSMR) return grid_size<__nv_bfloat16, kLSMR>(dim, nd, halo, T, blocks);
    return grid_size<__nv_bfloat16, kCRAIG>(dim, nd, halo, T, blocks);
  }
  if (solver == kLSQR) return grid_size<float, kLSQR>(dim, nd, halo, T, blocks);
  if (solver == kLSMR) return grid_size<float, kLSMR>(dim, nd, halo, T, blocks);
  return grid_size<float, kCRAIG>(dim, nd, halo, T, blocks);
}

// partial holds 3 * blocks floats; blocks comes from lsqr_mk_grid with the
// same nd, lo + hi and T. Vectors the solver does not use (LSQR: hbar;
// CRAIG: w, hbar) may be null. lo = max(0, -k_min), hi = max(0, k_max);
// T: 0 (the direct route) or the staged tile (ops/spmv.py: mk_tile).
#define LSQR_MK(NAME, SUFFIX, S, SOLVER)                                          \
  int lsqr_mk_##NAME##_##SUFFIX(                                                  \
      const void* data, const void* tdata, const void* offsets,                   \
      const void* toffsets, int nd, long long m, long long n, void* u, void* v,   \
      void* x, void* w, void* hbar, void* state, void* partial, int blocks,       \
      int K, int lo, int hi, int T, void* stream) {                               \
    return launch<S, SOLVER>(data, tdata, offsets, toffsets, nd, m, n, u, v, x,   \
                             w, hbar, state, partial, blocks, K, lo, hi, T,       \
                             stream);                                             \
  }

LSQR_MK(lsqr, f32, float, kLSQR)
LSQR_MK(lsqr, bf16, __nv_bfloat16, kLSQR)
LSQR_MK(lsmr, f32, float, kLSMR)
LSQR_MK(lsmr, bf16, __nv_bfloat16, kLSMR)
LSQR_MK(craig, f32, float, kCRAIG)
LSQR_MK(craig, bf16, __nv_bfloat16, kCRAIG)

#undef LSQR_MK

}  // extern "C"
