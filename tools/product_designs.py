#!/usr/bin/env python3
"""Designs of the staged DIA product (``dia_matvec`` and
``dia_product_shared``, csrc/dia_product_staged.cuh), and their times
against the parent's, on one card.

    python3 tools/product_designs.py designs [--reps N] [--out FILE]
    python3 tools/product_designs.py times ROOT [ROOT ...] [--reps N] [--out FILE]

The shapes: ``chip_smoke.py``'s main band (m = n = 2^23, 11 diagonals,
phase 1's stripes, seed 0) and its 81-diagonal band (``chip_smoke.MANY``,
2^20, phase 4's stripes, seed 104), f32 and bf16 stripes, and at each every
call of the two products (``chip_smoke.product_calls``): the shared forward
and ``[adjoint]``, the packed data forward, ``[t]`` on tdata and
``[column]``, data's column side.

``designs`` writes one source per design into ``build/product_designs/``
(the shipped header with a constant or a function replaced, and the staged
launcher's C entries), builds them all at once with nvcc (the library's
flags) and times each with ``chip_smoke.time_ms`` after holding its result
to the shipped build's bit for bit (every design sums in the same order).
The designs:

* ``T``: the shipped build at other tiles than the rule's
  (``product_tile``), and the direct kernel (T = 0, the parent's design:
  one thread an output);
* ``stages S``: S tiles in shared memory (``kProductStages``);
* ``blocks P``: at most P blocks an SM (``kProductBlocks``; 32: as many as
  fit);
* ``threads 128``: blocks of 128 threads (``kProductThreads``), at most four
  an SM;
* ``batch 8``: 8 diagonals' loads issued together (``kProductBatch``);
* ``table``: every side through the per-diagonal phase table, also where
  all rows share one 16-byte phase (``UNIFORM_LINE`` never taken);
* ``bulk``: each stage by 1-D bulk copies (TMA) that one thread issues and
  an mbarrier counts, instead of 16-byte cp.async copies (``BULK`` below).

``times`` runs each ROOT (a checkout; to compare a commit with its parent,
``git archive <parent> | tar -x -C build/parent`` and pass
``build/parent . . build/parent``) in a process of its own: every call at
the shapes above through each checkout's wrappers, the kernels of rows 1,
3 and 4 that share their sources (``dia_pair_shared``, both directions of
``dia_product_shared_axpy``, ``dia_pair``) at the main band, and the solves that
launch the products each iteration: phase 7's 2^23 f32 packed LSQR with
``fused=False`` (phase 2's stripes, seed 100, +12 on the diagonal), phase
10's regular ``cgls`` on the same packed operator, and phase 17's 2^21 ZDIA
``lsmr``, ``cgls`` and ``craig`` with ``pair=False`` (seed 17, +12,
right-hand side seed 171): istop, itn, the wall ms per iteration of a
second run and the kernel ms per iteration of a third under the profiler
(all its kernels, and the products' apart), per iteration run (whole
segments of 64, setup included). It prints the max |difference|
of every output and x to the first run's on the same inputs. Every
checkout is timed by this checkout's ``chip_smoke.time_ms``. Prints one
JSON object per run (the card's name and power limit with it) and, with
``--out FILE``, writes them all there. Needs one CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CSRC = HERE / "lsqr_tpu_torch" / "csrc"
HEADER = "dia_product_staged.cuh"

#: the tiles timed on the shipped build
PRODUCT_TS = (2048, 1024, 512, 256, 128, 64)
#: (design, {constant: value} of the header); a "bulk" value replaces the
#: stage; "blocks 32" lets as many blocks an SM run as fit
VARIANTS = [
    ("stages 3", {"kProductStages": 3}),
    ("blocks 1", {"kProductBlocks": 1}),
    ("blocks 3", {"kProductBlocks": 3}),
    ("blocks 32", {"kProductBlocks": 32}),
    ("threads 128", {"kProductThreads": 128, "kProductBlocks": 4}),
    ("batch 8", {"kProductBatch": 8}),
    ("table", {"table": True}),
    ("bulk", {"bulk": True}),
]
#: the staged launcher's choice of the kernel without the phase table
UNIFORM_LINE = "  if (stride % V == 0) {  // every row at row 0's 16-byte phase\n"

#: the C entries of a design: the staged launcher on any layout
ENTRIES = r"""
#include "dia_product_staged.cuh"

extern "C" {
int design_product_f32(const void* stripes, long long count, long long stride,
                       long long base, const void* vec, void* out, const void* offsets,
                       int nd, long long dim_out, long long dim_in, int column, int lo,
                       int hi, int T, void* stream) {
  return launch_product_staged<float>(stripes, count, stride, base, vec, out, offsets, nd,
                                      dim_out, dim_in, column, lo, hi, T,
                                      static_cast<cudaStream_t>(stream));
}
int design_product_bf16(const void* stripes, long long count, long long stride,
                        long long base, const void* vec, void* out, const void* offsets,
                        int nd, long long dim_out, long long dim_in, int column, int lo,
                        int hi, int T, void* stream) {
  return launch_product_staged<__nv_bfloat16>(stripes, count, stride, base, vec, out,
                                              offsets, nd, dim_out, dim_in, column, lo, hi,
                                              T, static_cast<cudaStream_t>(stream));
}
}
"""

#: the bulk design: product_stage replaced by one that thread 0 runs, one
#: bulk copy a diagonal (its pieces inside the stripe allocation), one for
#: the window, all counted in bytes by the stage's mbarrier; the kernel
#: waits on the mbarrier instead of the cp.async groups (BULK_KERNEL)
BULK_STAGE = r"""
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk(void* dst, const void* src, unsigned bytes,
                                     unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
               "r"(smem_u32(bar)) : "memory");
}

template <typename S, bool Uniform>
__device__ void product_stage_bulk(unsigned char* buf, const ProductLayout& lay,
                                   const S* __restrict__ rows, long long stride,
                                   long long lim_lo, long long lim_hi, int ph, const int* kk,
                                   const int* pq, const float* __restrict__ vec, int nd,
                                   long long dim_out, long long dim_in, int lo, int hi, int T,
                                   long long c0, int column, unsigned long long* bar) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(dim_out - c0 < T ? dim_out - c0 : T);
  const int cb = tile_phase<V, Uniform>(ph, c0);
  const long long xa = c0 - lo > 0 ? c0 - lo : 0;
  const long long xb = c0 + len + hi < dim_in ? c0 + len + hi : dim_in;
  const int shx = static_cast<int>(xa & 3);
  unsigned total = xa < xb ? static_cast<unsigned>((shx + (xb - xa) + 3) / 4) * 16u : 0u;
  // each diagonal's pieces [q0, q1) of V elements inside [lim_lo, lim_hi)
  for (int pass = 0; pass < 2; ++pass) {
    for (int d = 0; d < nd; ++d) {
      const int sh = piece_shift<V, Uniform>(cb, kk[d], Uniform ? 0 : pq[d], column);
      const long long g0 = d * stride + c0 + (column ? kk[d] : 0) - sh;
      long long q0 = 0, q1 = (sh + len + V - 1) / V;
      if (g0 < lim_lo) q0 = (lim_lo - g0) / V;
      if (g0 + q1 * V > lim_hi) q1 = (lim_hi - g0 + V - 1) / V;
      if (q0 >= q1) continue;
      if (pass == 0) {
        total += static_cast<unsigned>(q1 - q0) * 16u;
      } else {
        bulk(reinterpret_cast<S*>(buf) + d * lay.L + q0 * V, rows + g0 + q0 * V,
             static_cast<unsigned>(q1 - q0) * 16u, bar);
      }
    }
    if (pass == 0) bar_expect(bar, total);
  }
  float* const xs = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S));
  if (xa < xb) bulk(xs, vec + xa - shx, static_cast<unsigned>((shx + (xb - xa) + 3) / 4) * 16u,
                    bar);
}
"""

BULK_KERNEL = r"""
template <typename S, int R, bool Uniform>
__global__ void __launch_bounds__(kProductThreads) dia_product_staged_kernel(
    const S* __restrict__ rows, long long stride, long long lim_lo, long long lim_hi,
    const float* __restrict__ vec, float* __restrict__ out, const int* __restrict__ offsets,
    int nd, long long dim_out, long long dim_in, int lo, int hi, int T, long long tiles,
    int column) {
  constexpr int V = 16 / sizeof(S);
  extern __shared__ __align__(16) unsigned char smem[];
  const ProductLayout lay(nd, lo, hi, T, sizeof(S));
  int* const kk = reinterpret_cast<int*>(smem + kProductStages * lay.stage);
  int* const pq = kk + lay.nd4;
  auto* const bars = reinterpret_cast<unsigned long long*>(smem + lay.bytes);
  const unsigned long long r0 = reinterpret_cast<uintptr_t>(rows) / sizeof(S);
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    const int k = __ldg(offsets + d);
    kk[d] = column ? -k : k;
    const long long s = column ? -k : 0;
    pq[d] = static_cast<int>((r0 + static_cast<unsigned long long>(d) * stride +
                              static_cast<unsigned long long>(s)) & (V - 1));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kProductStages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int ph = static_cast<int>(r0 & (V - 1));
  const long long grid = gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kProductStages - 1; ++s) {
      const long long tile = blockIdx.x + s * grid;
      if (tile < tiles) {
        product_stage_bulk<S, Uniform>(smem + s * lay.stage, lay, rows, stride, lim_lo, lim_hi,
                                       ph, kk, pq, vec, nd, dim_out, dim_in, lo, hi, T,
                                       tile * T, column, bars + s);
      }
    }
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    bar_wait(bars + it % kProductStages, (it / kProductStages) & 1);
    __syncthreads();
    const long long ahead = tile + (kProductStages - 1) * grid;
    if (threadIdx.x == 0 && ahead < tiles) {
      const int b = (it + kProductStages - 1) % kProductStages;
      product_stage_bulk<S, Uniform>(smem + b * lay.stage, lay, rows, stride, lim_lo, lim_hi,
                                     ph, kk, pq, vec, nd, dim_out, dim_in, lo, hi, T, ahead * T,
                                     column, bars + b);
    }
    product_sum<S, R, Uniform>(smem + it % kProductStages * lay.stage, lay, ph, kk, pq, nd, out,
                               dim_out, dim_in, lo, hi, T, tile * T, column);
  }
}
"""


def yardstick():
    """This checkout's ``chip_smoke.py`` (loaded by path, so that a checkout
    under test cannot replace it): its shapes, seeds, calls and ``time_ms``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _replace_block(src, start, end_marker, new):
    """src with the block from the line starting ``start`` up to and
    including the first line equal to ``end_marker`` after it replaced."""
    i = src.index(start)
    j = src.index(end_marker, i) + len(end_marker)
    return src[:i] + new + src[j:]


def design_header(constants):
    """csrc/dia_product_staged.cuh with these constants (and, for "bulk",
    TMA stages; for "table", the phase table on every side)."""
    src = (CSRC / HEADER).read_text().replace(
        '#include "dia_pair_staged.cuh"', f'#include "{CSRC / "dia_pair_staged.cuh"}"')
    constants = dict(constants)
    if constants.pop("table", False):
        if src.count(UNIFORM_LINE) != 1:
            raise RuntimeError(f"csrc/{HEADER}: the launcher's uniform-phase test moved")
        src = src.replace(UNIFORM_LINE, "  if (false) {\n")
    if constants.pop("bulk", False):
        if src.count("template <typename S, int R, bool Uniform>\n__global__") != 1:
            raise RuntimeError(f"csrc/{HEADER}: the staged kernel moved")
        src = src.replace("// Sum the staged tile [c0, c0 + T) into out", BULK_STAGE
                          + "\n// Sum the staged tile [c0, c0 + T) into out")
        src = _replace_block(src, "template <typename S, int R, bool Uniform>\n__global__",
                             "  cp_async_wait_group<0>();  // the empty groups of the last "
                             "steps\n}\n", BULK_KERNEL)
        src = src.replace("  const ProductLayout lay(nd, lo, hi, T, sizeof(S));\n"
                          "  auto kernel = dia_product_staged_kernel<S, R, Uniform>;\n",
                          "  ProductLayout lay(nd, lo, hi, T, sizeof(S));\n"
                          "  lay.bytes += 8 * kProductStages;  // the mbarriers\n"
                          "  auto kernel = dia_product_staged_kernel<S, R, Uniform>;\n")
    for const, value in constants.items():
        line = next((ln for ln in src.splitlines()
                     if ln.startswith(f"constexpr int {const} = ")), None)
        if line is None:
            raise RuntimeError(f"csrc/{HEADER} no longer defines {const}")
        src = src.replace(line, f"constexpr int {const} = {value};")
    return src


def build(out_dir):
    """{design: loaded library}: every design compiled at once."""
    from lsqr_tpu_torch.ops import _cuda

    procs = {}
    for name, constants in VARIANTS:
        stem = name.replace(" ", "_")
        sub = out_dir / stem
        sub.mkdir(parents=True, exist_ok=True)
        (sub / HEADER).write_text(design_header(constants))
        cu, so = sub / "entries.cu", sub / f"{stem}.so"
        cu.write_text(ENTRIES)
        procs[name] = (so, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for s in ("f32", "bf16"):
            fn = getattr(lib, f"design_product_{s}")
            fn.argtypes = [P, L, L, L, P, P, P, I, L, L, I, I, I, I, P]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def stage_bytes(name, nd, lo, hi, T, esize):
    """A design's shared memory at tile T: the rule's mirror at the design's
    stage count, with the bulk design's mbarriers."""
    from lsqr_tpu_torch.ops import spmv

    constants = dict(next((c for n, c in VARIANTS if n == name), {}))
    stages = constants.get("kProductStages", spmv.PRODUCT_STAGES)
    return spmv.product_stage_bytes(nd, lo, hi, T, esize, stages) + (
        8 * stages if constants.get("bulk") else 0)


def shapes(smoke):
    """{label: (m, offsets, seed)}: the main band and the 81-diagonal one."""
    return {"2^23 x 11": (smoke.M_MAIN, smoke.OFFSETS, 0),
            "2^20 x 81": (smoke.MANY[0], smoke.MANY[1], 104)}


def inputs(smoke, dev, shape):
    """(stripes, y, v, offsets, m) of a shape: phase 1's (or phase 4's) draws."""
    import torch

    m, ks, seed = shape
    data, y, g = smoke.random_stripes(m, m, ks, dev, seed=seed)
    return data, y, torch.randn(m, generator=g, device=dev), ks, m


def layout(wrapper, stripes, kw):
    """(count, stride, base) of a call's stripes for the staged launcher."""
    from lsqr_tpu_torch.ops import spmv

    nd = len(kw["offsets"])
    if wrapper is spmv.dia_product_shared:
        H, Lp = spmv._geometry(kw["offsets"], kw["m"], kw["n"])
        return nd * Lp, Lp, H
    return nd * kw["m"], kw["m"], 0  # packed rows: data's m, or tdata's n as its m


def run_designs(reps):
    import torch

    from lsqr_tpu_torch.ops import spmv

    smoke = yardstick()
    libs = build(HERE / "build" / "product_designs")
    dev = torch.device("cuda")
    optin = spmv._smem_limits(dev)[1]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {"times": {}, "max_abs_diff_to_shipped": {}, "tiles": {}}

    def record(tag, fn, ref):
        got = fn()
        torch.cuda.synchronize()
        diff = smoke.absdiff(got, ref)
        res["max_abs_diff_to_shipped"][tag] = diff
        res["times"][tag] = smoke.time_ms(fn, reps)
        smoke.log(f"  {tag:60s} {res['times'][tag]:.5f} ms  (max |diff| to shipped {diff:.3e})")
        smoke.check(diff == 0.0 and torch.equal(got, ref), f"{tag}: not the shipped kernel's bits")

    for label, shape in shapes(smoke).items():
        data, y, v, ks, m = inputs(smoke, dev, shape)
        lo, hi = spmv._halos(ks)
        for storage in (torch.float32, torch.bfloat16):
            sfx = "f32" if storage == torch.float32 else "bf16"
            As, Ap = smoke.dia_operators(data, m, m, ks, storage)
            rule = spmv._product_rule(As.dp, ks)
            res["tiles"][f"{label} {sfx}"] = rule
            for name, (wrapper, stripes, vec, kw) in smoke.product_calls(As, Ap, v, y).items():
                side = f"{name} {label}"
                wrapped = lambda w=wrapper, s=stripes, x=vec, k=kw: w(s, x, **k)  # noqa: E731
                ref = wrapped()
                record(f"{side} shipped, the rule's T {rule}", wrapped, ref)
                record(f"{side} direct (T 0)", lambda w=wrapper, s=stripes, x=vec, k=kw:
                       spmv._product_launch(w, s, x, tile=0, **k), ref)
                count, stride, base = layout(wrapper, stripes, kw)
                dim_out, dim_in = (kw["n"], kw["m"]) if kw["adjoint"] else (kw["m"], kw["n"])
                for T in PRODUCT_TS:
                    if T == rule or spmv.product_stage_bytes(len(ks), lo, hi, T,
                                                             storage.itemsize) > optin:
                        continue
                    record(f"{side} shipped T {T}", lambda w=wrapper, s=stripes, x=vec, k=kw,
                           T=T: spmv._product_launch(w, s, x, tile=T, **k), ref)
                for design, lib in libs.items():
                    if stage_bytes(design, len(ks), lo, hi, rule, storage.itemsize) > optin:
                        continue
                    entry = getattr(lib, f"design_product_{sfx}")

                    def call(entry=entry, s=stripes, x=vec, k=kw, geo=(count, stride, base),
                             dims=(dim_out, dim_in)):
                        out = torch.empty(dims[0], device=dev)
                        err = entry(s.data_ptr(), *geo, x.data_ptr(), out.data_ptr(),
                                    k["offsets_t"].data_ptr(), len(ks), *dims,
                                    int(k["adjoint"]), *spmv._halos(k["offsets"]), rule,
                                    stream())
                        if err:
                            raise RuntimeError(f"CUDA error {err}")
                        return out
                    record(f"{side} {design} T {rule}", call, ref)
            del As, Ap
            torch.cuda.empty_cache()
        del data, y, v
        torch.cuda.empty_cache()
    return res


def profiled_solve(smoke, fn, args, kw):
    """(result, {istop, itn, wall and kernel ms per iteration}) of a solve:
    a warm-up run, a timed one, then one under the profiler (every kernel's
    device time, and the products' apart). An iteration is one the solve
    runs: the solvers run whole segments of ``loop_segment`` (64)
    iterations, the last masked after convergence
    (``chip_smoke.iterations_run``), setup included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lsqr_tpu_torch as lt

    fn(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = fn(*args, **kw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    product = ("dia_product_staged_kernel", "dia_matvec_kernel", "dia_product_shared_kernel")
    itn = int(res.itn)
    smoke.check(int(again.itn) == itn, "a solve's second run stopped elsewhere")
    runs = smoke.iterations_run(itn, lt.LSQROptions().loop_segment)
    return res, dict(istop=int(res.istop), itn=itn, iterations_run=runs,
                     wall_ms_per_iteration=wall * 1e3 / runs,
                     kernel_ms_per_iteration=sum(e.device_time for e in kernels) / 1e3 / runs,
                     product_ms_per_iteration=sum(e.device_time for e in kernels
                                                  if any(p in e.name for p in product))
                     / 1e3 / runs)


def one(root, reps, dump):
    """Times, solves and results of the checkout at ``root`` (this process)."""
    sys.path.insert(0, str(root))
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    assert Path(lt.__file__).resolve().is_relative_to(Path(root).resolve()), lt.__file__
    smoke = yardstick()
    dev = torch.device("cuda")
    out, saved = {}, {}
    for label, shape in shapes(smoke).items():
        data, y, v, ks, m = inputs(smoke, dev, shape)
        for storage in (torch.float32, torch.bfloat16):
            As = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
            Ap = lt.dia_operator_device(m, m, ks, data, storage_dtype=storage)
            # the calls as chip_smoke.product_calls makes them, through this
            # checkout's wrappers
            sfx = "" if storage == torch.float32 else "[bf16]"
            kw = dict(offsets=ks, m=m, n=m)
            calls = {
                f"dia_product_shared{sfx}": lambda: spmv.dia_product_shared(
                    As.dp, v, adjoint=False, offsets_t=As.offsets_t, **kw),
                f"dia_product_shared{sfx}[adjoint]": lambda: spmv.dia_product_shared(
                    As.dp, y, adjoint=True, offsets_t=As.offsets_t, **kw),
                f"dia_matvec{sfx}": lambda: spmv.dia_matvec(Ap.data, v,
                                                            offsets_t=Ap.offsets_t, **kw),
                f"dia_matvec{sfx}[t]": lambda: spmv.dia_matvec(
                    Ap.tdata, y, offsets=Ap.toffsets, m=m, n=m, offsets_t=Ap.toffsets_t),
                f"dia_matvec{sfx}[column]": lambda: spmv.dia_matvec(
                    Ap.data, y, adjoint=True, offsets_t=Ap.offsets_t, **kw),
            }
            if label == "2^23 x 11":  # the neighbours in the same sources: rows 1, 3, 4
                c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
                calls.update({
                    f"dia_pair_shared{sfx}": lambda: spmv.dia_pair_shared(
                        As.dp, v, y, c1, c2, offsets_t=As.offsets_t, **kw),
                    f"dia_product_shared_axpy{sfx}": lambda: spmv.dia_product_shared_axpy(
                        As.dp, v, y, c1, c2, adjoint=False, offsets_t=As.offsets_t, **kw),
                    f"dia_product_shared_axpy{sfx}[adjoint]":
                        lambda: spmv.dia_product_shared_axpy(
                            As.dp, y, v, c1, c2, adjoint=True, offsets_t=As.offsets_t, **kw),
                    f"dia_pair{sfx}": lambda: spmv.dia_pair(Ap.data, y, v, c1, c2,
                                                            offsets_t=Ap.offsets_t, **kw),
                })
            for name, fn in calls.items():
                tag = f"{name} {label}"
                out[tag] = smoke.time_ms(fn, reps)
                got = fn()
                saved[tag] = [t.cpu() for t in (got if isinstance(got, tuple) else (got,))]
            del As, Ap
            torch.cuda.empty_cache()
        del data, y, v
        torch.cuda.empty_cache()

    tol = dict(atol=1e-6, btol=1e-6)
    m = smoke.M_MAIN
    data, b, _ = smoke.random_stripes(m, m, smoke.OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_operator_device(m, m, smoke.OFFSETS, data)
    del data
    for label, fn, args, kw in (
            ("phase 7 packed lsqr fused=False", lt.lsqr, (A, b, smoke.DAMP),
             dict(tol, fused=False)),
            ("phase 10 packed cgls regular", lt.cgls, (A, b, smoke.DAMP), dict(tol))):
        res, out[f"solve {label}"] = profiled_solve(smoke, fn, args, kw)
        saved[f"x {label}"] = [res.x.cpu()]
    del A, b
    torch.cuda.empty_cache()
    from lsqr_tpu_torch.models.synthetic import ZDIA_OFFSETS

    m, ks = smoke.M_ZDIA, ZDIA_OFFSETS
    A = lt.dia_operator_device(m, m, ks, lt.zdia_stripes(m, m, ks, seed=17, diag=12.0,
                                                         device=dev, generator="torch"))
    b = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(171), device=dev,
                    dtype=torch.complex64)
    for name in ("lsmr", "cgls", "craig"):
        args = (A, b) if name == "craig" else (A, b, smoke.DAMP)
        label = f"phase 17 ZDIA {name} pair=False"
        res, out[f"solve {label}"] = profiled_solve(smoke, getattr(lt, name), args,
                                                    dict(tol, pair=False))
        saved[f"x {label}"] = [res.x.cpu()]
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
    return out


def run_times(roots, reps):
    import torch

    runs = []
    dumps = HERE / "build" / "product_designs" / "times"
    for i, root in enumerate(roots):
        root = str(Path(root).resolve())
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--reps", str(reps),
                               "--dump", str(dumps / f"{i}.pt")], capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(proc.returncode)
        runs.append({"root": root, **json.loads(proc.stdout.splitlines()[-1])})
        if i:  # each result against the first run's
            first, this = (torch.load(dumps / f"{k}.pt") for k in (0, i))
            runs[-1]["max_abs_diff_to_first"] = {
                tag: [float((a - b).abs().max()) for a, b in zip(this[tag], first[tag])]
                for tag in this}
        print(json.dumps(runs[-1]), flush=True)
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["designs", "times"])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="write the result to this JSON file too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.reps, args.dump)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("product_designs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.mode == "times":
        result = {"card": card, "runs": run_times(args.roots or [str(HERE)], args.reps)}
    else:
        result = {"card": card, **run_designs(args.reps)}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
