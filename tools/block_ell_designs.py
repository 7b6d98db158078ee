#!/usr/bin/env python3
"""Times of the BlockELL product's designs, launch shapes and work plans.

    python3 tools/block_ell_designs.py [--reps N] [--out FILE]

Writes one source per design into ``build/block_ell_designs/`` and builds
each there with nvcc (the library's flags; all builds started together):
the shipped kernel, ``lsqr_tpu_torch/csrc/block_ell.cu`` (``kRows`` = 4
rows a warp straight into registers; both products' entry points run it),
as it is and at other row counts; and the ring designs that lost to it
(``RING`` below, which includes the shipped source: the blocks through
``kStages`` shared-memory stages of at most ``kStageBytes``, filled by bulk
asynchronous copies; one CTA a unit, and a persistent walk), at other
stage counts and sizes. Each design runs on the four packings of
``chip_smoke.py``'s BlockELL operators that the solves take: the 2^18
forward (kb = 3) and transpose (kt = 10) packings, the tall forward (600
block rows x 3) and transpose (12 x 164) packings, on the work plan of
``spmv_sparse.block_ell_plan``; the shipped build runs at other plans too
(``spmv_sparse.UNITS_PER_SM`` set to 1, 2, 8 and 16 for the plan). Every
result is held to the plain twin (relative 1e-5) before it is timed with
``chip_smoke.time_ms``. Prints one JSON object (the card's name and power
limit with it) and, with ``--out FILE``, writes it there. Needs one CUDA
device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

SHIPPED = HERE / "lsqr_tpu_torch" / "csrc" / "block_ell.cu"
ROWS = {"rows": "lsqr_block_ell_matvec_f32"}
RINGS = {"ring": "lsqr_block_ell_ring_f32", "ring walk": "lsqr_block_ell_ring_walk_f32"}
#: name: (rows a warp, None) for the shipped kernel, or (stages, stage
#: bytes) for a ring design; then its entry points
DESIGNS = {
    "shipped": ((4, None), ROWS),
    "rows2": ((2, None), ROWS),
    "rows8": ((8, None), ROWS),
    "4x16k": ((4, 16384), RINGS),
    "2x16k": ((2, 16384), RINGS),
    "6x16k": ((6, 16384), RINGS),
    "4x4k": ((4, 4096), RINGS),
    "4x8k": ((4, 8192), RINGS),
    "6x8k": ((6, 8192), RINGS),
    "4x32k": ((4, 32768), RINGS),
}
PLANS = (1, 2, 8, 16)  # units per SM tried with the shipped build (4 is its own)

#: the ring designs, with the shipped source included
RING = r"""
// A ring design of the BlockELL product (tools/block_ell_designs.py):
// the blocks stream through a ring of kStages shared-memory stages of at
// most kStageBytes (whole rows of one block), each filled by one bulk
// asynchronous copy (cp.async.bulk, completion on an mbarrier) that thread
// 0 issues kStages chunks ahead, the warps reducing the stage that has
// landed; x segments through __ldg. 16-byte packings only (bw a multiple
// of 4, aligned). Built with the shipped source included (its helpers,
// plan and sum pass).
// * lsqr_block_ell_ring_f32: one CTA per unit of the shipped plan (a slice
//   of a block row), the ring filled afresh in each;
// * lsqr_block_ell_ring_walk_f32: a persistent grid walking units of one
//   row group (the rows a stage holds) of a slice, the ring running on
//   across units.
// Same arguments as lsqr_block_ell_matvec_f32.

#include "@SHIPPED@"

namespace {

constexpr int kStages = @STAGES@;
constexpr int kStageBytes = @STAGE_BYTES@;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One unit of the shipped plan. Chunk c is rows [g*cr, g*cr + cr) of
// block j0 + c % nblk, g = c / nblk: a row group runs through the slice's
// blocks before the next starts, so a warp keeps RW >= cr / kWarps sums.
template <int RW>
__global__ void __launch_bounds__(kThreads) block_ell_ring_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, float* __restrict__ out, int kb, int bh, int bw, int S,
    int cr, int ms) {
  (void)ms;
  extern __shared__ float4 ring4[];
  __shared__ __align__(8) uint64_t full[kStages];
  float* ring = reinterpret_cast<float*>(ring4);
  const Unit u = unit_of(kb, S);
  const int nblk = u.j1 - u.j0, nch = (bh + cr - 1) / cr * nblk;
  const long long stage_len = static_cast<long long>(cr) * bw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / 4;
  auto issue = [&](int c) {
    const int i0 = c / nblk * cr, j = u.j0 + c % nblk;
    const int k = c % kStages;
    bulk_load(ring + k * stage_len, blocks + ((u.r * kb + j) * bh + i0) * bw,
              static_cast<unsigned>(min(cr, bh - i0) * bw * 4), &full[k]);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&full[k])),
                   "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < min(kStages, nch); ++c) issue(c);
  float* dst = out + (u.r * S + u.s) * bh;
  float acc[RW];
#pragma unroll
  for (int t = 0; t < RW; ++t) acc[t] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const int k = c % kStages, jj = c % nblk;
    const int i0 = c / nblk * cr, rows = min(cr, bh - i0);
    const float4* xs = reinterpret_cast<const float4*>(
        x + static_cast<long long>(__ldg(bcols + u.r * kb + u.j0 + jj)) * bw);
    bar_wait(&full[k], (c / kStages) & 1);
    const float* stage = ring + k * stage_len;
    for (int q = lane; q < nvec; q += 32) {
      const float4 xv = __ldg(xs + q);
#pragma unroll
      for (int t = 0; t < RW; ++t) {
        const int row = warp + kWarps * t;
        if (row < rows) {
          const float4 av = reinterpret_cast<const float4*>(stage + row * bw)[q];
          acc[t] += av.x * xv.x + av.y * xv.y + av.z * xv.z + av.w * xv.w;
        }
      }
    }
    __syncthreads();  // every warp is done with stage k
    if (threadIdx.x == 0 && c + kStages < nch) issue(c + kStages);
    if (jj == nblk - 1) {  // the row group is complete
#pragma unroll
      for (int t = 0; t < RW; ++t) {
        const int row = warp + kWarps * t;
        const float v = warp_sum(acc[t]);
        if (lane == 0 && row < rows) dst[i0 + row] = v;
        acc[t] = 0.0f;
      }
    }
  }
}

// A work unit here is row group g (rows [g*cr, g*cr + cr), cr = the rows a
// stage holds) of slice s of block row r: u = (r*S + s)*G + g, G =
// ceil(bh / cr); its chunks are those rows of blocks j0 .. j1-1, each
// contiguous (cr*bw floats). The grid is persistent (as many CTAs as fit
// the card) and a CTA walks units blockIdx.x, + gridDim.x, ...; thread 0
// runs kStages chunks ahead along the same walk, across unit
// boundaries, so the ring never drains between units. A warp keeps RW >=
// cr / kWarps sums (rows warp, warp + kWarps, ...) and writes them when the
// unit's last chunk is done.
struct RingWalk {
  long long r;
  int g, s, j0, j1;
};

__device__ __forceinline__ RingWalk ring_unit(long long u, int G, int S, int kb) {
  RingWalk w;
  w.g = static_cast<int>(u % G);
  const long long rs = u / G;
  w.r = rs / S;
  w.s = static_cast<int>(rs % S);
  w.j0 = static_cast<int>(static_cast<long long>(w.s) * kb / S);
  w.j1 = static_cast<int>(static_cast<long long>(w.s + 1) * kb / S);
  return w;
}

template <int RW>
__global__ void __launch_bounds__(kThreads) block_ell_ring_walk_kernel(
    const float* __restrict__ blocks, const int* __restrict__ bcols,
    const float* __restrict__ x, float* __restrict__ out, int kb, int bh, int bw, int S,
    int cr, int ms) {
  extern __shared__ float4 ring4[];
  __shared__ __align__(8) uint64_t full[kStages];
  float* ring = reinterpret_cast<float*>(ring4);
  const int G = (bh + cr - 1) / cr;
  const long long units = static_cast<long long>(ms) * G;  // ms = mb*S
  const long long stage_len = static_cast<long long>(cr) * bw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = bw / 4;
  // thread 0's producer: the next chunk to copy (unit pu, block pj)
  long long pu = blockIdx.x;
  int pj = 0, issued = 0;
  if (pu < units) pj = ring_unit(pu, G, S, kb).j0;
  auto issue_next = [&]() {
    if (pu >= units) return;
    const RingWalk w = ring_unit(pu, G, S, kb);
    const int i0 = w.g * cr, k = issued % kStages;
    bulk_load(ring + k * stage_len, blocks + ((w.r * kb + pj) * bh + i0) * bw,
              static_cast<unsigned>(min(cr, bh - i0) * bw * 4), &full[k]);
    ++issued;
    if (++pj == w.j1) {
      pu += gridDim.x;
      if (pu < units) pj = ring_unit(pu, G, S, kb).j0;
    }
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&full[k])),
                   "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages; ++k) issue_next();
  int consumed = 0;
  for (long long cu = blockIdx.x; cu < units; cu += gridDim.x) {
    const RingWalk w = ring_unit(cu, G, S, kb);
    const int i0 = w.g * cr, rows = min(cr, bh - i0);
    float acc[RW];
#pragma unroll
    for (int t = 0; t < RW; ++t) acc[t] = 0.0f;
    for (int j = w.j0; j < w.j1; ++j, ++consumed) {
      const int k = consumed % kStages;
      const float4* xs = reinterpret_cast<const float4*>(
          x + static_cast<long long>(__ldg(bcols + w.r * kb + j)) * bw);
      bar_wait(&full[k], (consumed / kStages) & 1);
      const float* stage = ring + k * stage_len;
      for (int q = lane; q < nvec; q += 32) {
        const float4 xv = __ldg(xs + q);
#pragma unroll
        for (int t = 0; t < RW; ++t) {
          const int row = warp + kWarps * t;
          if (row < rows) {
            const float4 av = reinterpret_cast<const float4*>(stage + row * bw)[q];
            acc[t] += av.x * xv.x + av.y * xv.y + av.z * xv.z + av.w * xv.w;
          }
        }
      }
      __syncthreads();  // every warp is done with stage k
      if (threadIdx.x == 0) issue_next();
    }
    float* dst = out + (w.r * S + w.s) * bh + i0;
#pragma unroll
    for (int t = 0; t < RW; ++t) {
      const int row = warp + kWarps * t;
      const float v = warp_sum(acc[t]);
      if (lane == 0 && row < rows) dst[row] = v;
    }
  }
}

using RingKernel = void (*)(const float*, const int*, const float*, float*, int, int, int,
                            int, int, int);

// Launch a ring design (walk: the persistent one) on the shipped plan.
int ring_product(bool walk, const void* blocks, const void* bcols, const void* x, void* out,
                 void* partial, int mb, int kb, int bh, int bw, int S, cudaStream_t st) {
  if (kb == 0 || bw % 4 || !aligned16(blocks) || !aligned16(x)) return 1;
  // a stage: as many whole rows of a block as kStageBytes holds, at
  // least one, at most bh and 8 a warp
  int cr = kStageBytes / (bw * static_cast<int>(sizeof(float)));
  cr = cr < 1 ? 1 : cr;
  cr = cr > bh ? bh : cr;
  cr = cr > 8 * kWarps ? 8 * kWarps : cr;
  const int rw = (cr + kWarps - 1) / kWarps;
  const RingKernel kernel =
      walk ? (rw <= 1   ? block_ell_ring_walk_kernel<1>
              : rw <= 2 ? block_ell_ring_walk_kernel<2>
              : rw <= 4 ? block_ell_ring_walk_kernel<4>
                        : block_ell_ring_walk_kernel<8>)
           : (rw <= 1   ? block_ell_ring_kernel<1>
              : rw <= 2 ? block_ell_ring_kernel<2>
              : rw <= 4 ? block_ell_ring_kernel<4>
                        : block_ell_ring_kernel<8>);
  const size_t smem = static_cast<size_t>(kStages) * cr * bw * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const long long ms = static_cast<long long>(mb) * S;
  long long grid = ms;
  if (walk) {  // as many CTAs as fit the card, at most one a unit
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev))) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             smem)))
      return err;
    const long long units = ms * ((bh + cr - 1) / cr);
    const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    grid = units < slots ? units : slots;
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(S > 1 ? partial : out), kb, bh, bw, S,
      cr, static_cast<int>(ms));
  if ((err = static_cast<int>(cudaGetLastError())) || S == 1) return err;
  const long long len = static_cast<long long>(mb) * bh;
  sum_slices_kernel<<<static_cast<unsigned>((len + kThreads - 1) / kThreads), kThreads, 0,
                      st>>>(static_cast<const float*>(partial), static_cast<float*>(out), len,
                            bh, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lsqr_block_ell_ring_f32(const void* blocks, const void* bcols, const void* x, void* out,
                            void* partial, int mb, int kb, int bh, int bw, int S,
                            void* stream) {
  return ring_product(false, blocks, bcols, x, out, partial, mb, kb, bh, bw, S,
                      static_cast<cudaStream_t>(stream));
}

int lsqr_block_ell_ring_walk_f32(const void* blocks, const void* bcols, const void* x,
                                 void* out, void* partial, int mb, int kb, int bh, int bw,
                                 int S, void* stream) {
  return ring_product(true, blocks, bcols, x, out, partial, mb, kb, bh, bw, S,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
"""


def source(name):
    """The CUDA source of design ``name``."""
    (a, stage_bytes), _ = DESIGNS[name]
    shipped = SHIPPED.read_text()
    if stage_bytes is None:
        line = "constexpr int kRows = 4;"
        if line not in shipped:
            raise RuntimeError(f"{SHIPPED} no longer holds {line!r}")
        return shipped.replace(line, f"constexpr int kRows = {a};")
    return (RING.replace("@SHIPPED@", str(SHIPPED)).replace("@STAGES@", str(a))
            .replace("@STAGE_BYTES@", str(stage_bytes)))


def build(out_dir):
    """{design: loaded library}: every design compiled at once."""
    from lsqr_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in DESIGNS:
        src, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(source(name))
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    signature = _cuda._SIGNATURES["lsqr_block_ell_matvec_f32"]
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in DESIGNS[name][1].values():
            getattr(lib, entry).argtypes = signature
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def plan_at(blocks, sms, units_per_sm):
    """``spmv_sparse.block_ell_plan`` for ``blocks`` at ``units_per_sm``."""
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    mb, kb, bh, _ = blocks.shape
    shipped, sp.UNITS_PER_SM = sp.UNITS_PER_SM, units_per_sm
    try:
        return sp.block_ell_plan(mb, kb, bh, sms)
    finally:
        sp.UNITS_PER_SM = shipped


def call(lib, entry, blocks, bcols, x, plan):
    """y from one entry point of ``lib`` on ``plan``."""
    import torch

    mb, kb, bh, bw = blocks.shape
    out = torch.empty(mb * bh, device=blocks.device)
    partial = torch.empty(max(plan.scratch, 1), device=blocks.device)
    err = getattr(lib, entry)(blocks.data_ptr(), bcols.data_ptr(), x.data_ptr(),
                              out.data_ptr(), partial.data_ptr(), mb, kb, bh, bw, plan.slices,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="write the result to this JSON file too")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("block_ell_designs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import random_block_coo
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    card = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader").splitlines()[0]
    libs = build(HERE / "build" / "block_ell_designs")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"card": card, "sms": sms, "times": {}}
    for key, (m, n), seed in (("2^18", (smoke.M_BELL, smoke.M_BELL), 13),
                              ("tall", smoke.BELL_TALL, 15)):
        A = lt.block_ell_operator(m, n, *random_block_coo(m, n, diag=2.0, seed=seed),
                                  device=dev)
        x, y = smoke.padded_vectors(dev, A, seed)
        for side, args in (("forward", (A.blocks, A.bcols, x)),
                           ("transpose", (A.tblocks, A.tbrows, y))):
            packing = f"{key} {side} ({args[0].shape[0]} x {args[0].shape[1]})"
            ref = sp.block_ell_matvec_plain(*args)
            runs = [(d, kind, sp.UNITS_PER_SM) for d, (_, entries) in DESIGNS.items()
                    for kind in entries]
            runs += [("shipped", "rows", u) for u in PLANS]
            for design, kind, units in runs:
                plan = plan_at(args[0], sms, units)
                fn = (lambda lib=libs[design], e=DESIGNS[design][1][kind], p=plan:  # noqa: E731
                      call(lib, e, *args, p))
                err = smoke.rel(fn(), ref)
                smoke.check(err <= 1e-5, f"{design} {kind} {packing}: rel err {err:.3e}")
                tag = f"{packing} {kind} {design} units/SM={units}"
                res["times"][tag] = smoke.time_ms(fn, opts.reps)
                smoke.log(f"  {tag:60s} {res['times'][tag]:.5f} ms  (rel err {err:.2e})")
        del A, x, y
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
