#!/usr/bin/env python3
"""Designs of the megakernels' staged product phases (``csrc/megakernel.cu``)
and the three megakernels' times against the parent's, on one card.

    python3 tools/megakernel_designs.py designs [--reps N] [--out FILE]
    python3 tools/megakernel_designs.py times ROOT [ROOT ...] [--reps N] [--out FILE]

The shape: ``chip_smoke.py``'s phase 9 main case, m = n = 2^23 with 11
diagonals (-5..5), its stripes (seed 100, +12 on the main diagonal), f32
and bf16 stripes, one call of K = 8 iterations of each of ``lsqr``,
``lsmr`` and ``craig`` from the solver's own setup (CRAIG on a consistent
right-hand side), each call from the same state.

``designs`` writes one source per design into ``build/megakernel_designs/``,
builds them all at once with nvcc (the library's flags) and times each
with ``chip_smoke.time_ms`` after holding its first call to the shipped
build's: bit for bit where the design keeps the shipped ownership (two
outputs a thread) and grid, else within ``chip_smoke.MK_TOL`` (relative, on
the state and the vectors: another grid or another ownership changes the
sums' rounding). The designs:

* ``direct``: the shipped build's direct route (T = 0: its own kernel, one
  thread an output, no register cap) at the staged route's grid and at its
  own grid (what the rule launches where T = 0);
* ``rows R``: R outputs a thread side by side, tiles of 256 R (``kMkRows``);
* ``stages S``: S tiles in shared memory (``kMkStages``);
* ``blocks P``: ``__launch_bounds__(256, P)`` (``kMkBlocks``), so that P
  blocks fit an SM's registers; ``grid 1 an SM``: the shipped build on one
  block an SM;
* ``bulk``: each stage by 1-D bulk copies (the TMA's ``cp.async.bulk``)
  that thread 0 issues and an mbarrier a stage counts in bytes (``BULK``);
* ``prefetch``: the forward phase issues the adjoint's first tile's stripe
  copies before its closing barrier (``PREFETCH``; stripes are read-only).

It then times the shipped LSQR megakernel's staged route against its
direct route (at the staged grid and at its own) on wider bands at 2^20
(``BANDS``), and on sparse bands spread wide at 2^24 (``SPREADS``: offsets
-s, -1, 0, 1, s and -s, 0, s), where the staged route copies a vector
window of T + 2s floats a tile against the direct route's nd reads an
output: the data behind ``spmv.MK_SPREAD``.

``times`` runs each ROOT (a checkout; to compare a commit with its parent,
``git archive <parent> | tar -x -C build/parent`` and pass ``build/parent
. . build/parent``) in a process of its own: the six megakernels as above
through each checkout's wrappers (with the route each launched), LSQR
at ``EXTRA``'s bands (the direct route's, and a sparse band spread wide),
phase 10's solves with ``megakernel=True`` (f32 and bf16 ``lsqr``, ``lsmr``,
``craig`` to atol = btol = 1e-6: istop, itn) and the fixed 64-iteration
f32 ``lsqr(megakernel=True)`` at 2^23 and 2^19 (wall ms per iteration
after a warm-up run, kernel ms per iteration from
``chip_smoke.phase_launches``, and the device's idle share 1 - kernel /
wall). It prints the max |difference| of every output (state, vectors, x)
to the first run's. Every checkout is timed by this checkout's
``chip_smoke.time_ms``. Prints one JSON object per run (the card's name
and power limit with it) and, with ``--out FILE``, writes them all there.
Needs one CUDA device.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CSRC = HERE / "lsqr_tpu_torch" / "csrc"
SOLVERS = ("lsqr", "lsmr", "craig")
SOLVER_IDS = {"lsqr": 0, "lsmr": 1, "craig": 2}  # lsqr_mk_grid's
#: (design, {constant: value}) of the variants built from the shipped
#: source: outputs a thread (kMkRows: tiles of 256 R), stages (kMkStages),
#: blocks an SM the registers leave room for (kMkBlocks)
VARIANTS = [
    ("rows 1, blocks 4", {"kMkRows": 1}),
    ("rows 1, blocks 6", {"kMkRows": 1, "kMkBlocks": 6}),
    ("rows 1, blocks 8", {"kMkRows": 1, "kMkBlocks": 8}),
    ("blocks 2", {"kMkBlocks": 2}),
    ("blocks 3", {"kMkBlocks": 3}),
    ("blocks 5", {"kMkBlocks": 5}),
    ("blocks 6", {"kMkBlocks": 6}),
    ("rows 4, blocks 2", {"kMkRows": 4, "kMkBlocks": 2}),
    ("rows 4, blocks 3", {"kMkRows": 4, "kMkBlocks": 3}),
    ("stages 3", {"kMkStages": 3}),
]
#: the sparse bands' spreads s at 2^24 rows (offsets -s, -1, 0, 1, s and
#: -s, 0, s), staged against direct
SPREADS = (256, 1024, 2048, 4096, 8192, 16384)
#: (label, m = n, offsets) of the bands ``times`` runs LSQR on besides the
#: main one: 81 diagonals (more than a staged f32 tile takes), offsets of
#: +-m/2 (``chip_smoke.MK_FAR``), and a 2-D Laplacian's five diagonals on a
#: 4096-wide grid (spread too wide for the staged route)
EXTRA = (("2^20 x 81", 2 ** 20, tuple(range(-40, 41))),
         ("2^16 +-2^15", 2 ** 16, (-2 ** 15, 0, 2 ** 15)),
         ("2^24 laplacian 4096", 2 ** 24, (-4096, -1, 0, 1, 4096)))
#: the wider bands (2^20 rows, diagonals -nd/2 .. nd/2) at which the
#: shipped build's staged route is timed against its direct route, at the
#: staged grid and at the direct route's own
BANDS = (21, 31, 41, 53)

#: mbarrier and bulk-copy helpers of the ``bulk`` design
BULK_HELPERS = r"""
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void bar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)));
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
__device__ __forceinline__ unsigned pieces16(long long elems, int per) {
  return static_cast<unsigned>((elems + per - 1) / per) * 16u;
}

// mk_stage's pieces by thread 0: one bulk copy a diagonal, one for the
// window, one for y, counted by `bar`
template <typename S>
__device__ void mk_stage_bulk(unsigned char* buf, const MkLayout& lay, const Side<S>& sd,
                              int nd, int T, long long c0, unsigned long long* bar) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(sd.dim_out - c0 < T ? sd.dim_out - c0 : T);
  const int cm = static_cast<int>(c0 & (V - 1));
  const long long xa = c0 - sd.lo > 0 ? c0 - sd.lo : 0;
  const long long xb = c0 + len + sd.hi < sd.dim_in ? c0 + len + sd.hi : sd.dim_in;
  const int shx = static_cast<int>((sd.phx + xa) & 3);
  const int shy = static_cast<int>((sd.phy + c0) & 3);
  unsigned total = pieces16(shy + len, 4) + (xa < xb ? pieces16(shx + (xb - xa), 4) : 0u);
  for (int d = 0; d < nd; ++d) total += pieces16(((sd.dm[d] + cm) & (V - 1)) + len, V);
  bar_expect(bar, total);
  S* const st = reinterpret_cast<S*>(buf);
  for (int d = 0; d < nd; ++d) {
    const int sh = (sd.dm[d] + cm) & (V - 1);
    bulk(st + d * lay.L, sd.rows + d * sd.stride + c0 - sh, pieces16(sh + len, V), bar);
  }
  float* const xs = reinterpret_cast<float*>(buf + nd * lay.L * sizeof(S));
  if (xa < xb) bulk(xs, sd.vec + xa - shx, pieces16(shx + (xb - xa), 4), bar);
  bulk(xs + lay.LX, sd.out + c0 - shy, pieces16(shy + len, 4), bar);
}

"""

#: the ``bulk`` design's staged phase (replaces the shipped one)
BULK_PHASE = r"""template <typename S>
__device__ float staged_phase(const Side<S>& sd, int nd, int T, float c1, float c2,
                              bool keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MkLayout lay(nd, sd.lo + sd.hi, T, sizeof(S));
  auto* const bars = reinterpret_cast<unsigned long long*>(smem + lay.tables + 16LL * lay.nd4);
  const long long grid = gridDim.x;
  const long long tiles = (sd.dim_out + T - 1) / T;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMkStages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMkStages - 1; ++s) {
      const long long tile = blockIdx.x + s * grid;
      if (tile < tiles) mk_stage_bulk(smem + s * lay.stage, lay, sd, nd, T, tile * T, bars + s);
    }
  }
  float local = 0.f;
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    bar_wait(bars + it % kMkStages, (it / kMkStages) & 1);
    __syncthreads();
    const long long ahead = tile + (kMkStages - 1) * grid;
    if (threadIdx.x == 0 && ahead < tiles) {
      const int b = (it + kMkStages - 1) % kMkStages;
      mk_stage_bulk(smem + b * lay.stage, lay, sd, nd, T, ahead * T, bars + b);
    }
    local = mk_sum<S, kMkRows>(smem + it % kMkStages * lay.stage, lay, sd, nd, c1, c2, keep,
                               tile * T, local);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMkStages; ++s) bar_inval(bars + s);
  }
  return local;
}
"""

#: the ``prefetch`` design: the staging split into stripes and vectors, the
#: forward phase issuing the adjoint's first tile's stripes before its
#: closing barrier, the adjoint staging only that tile's vectors
PREFETCH_STAGE = r"""template <typename S>
__device__ __forceinline__ void mk_stage(unsigned char* buf, const MkLayout& lay,
                                         const Side<S>& sd, int nd, int T, long long c0,
                                         bool stripes = true, bool vectors = true) {
  constexpr int V = 16 / sizeof(S);
  const int len = static_cast<int>(sd.dim_out - c0 < T ? sd.dim_out - c0 : T);
  const int P = static_cast<int>(lay.L / V);
  const int cm = static_cast<int>(c0 & (V - 1));
  S* const st = reinterpret_cast<S*>(buf);
  if (stripes) {
    for (int e = threadIdx.x; e < nd * P; e += blockDim.x) {
      const int d = e / P, q = (e - d * P) * V;
      const int sh = (sd.dm[d] + cm) & (V - 1);
      if (q < sh + len) cp_async16(st + d * lay.L + q, sd.rows + d * sd.stride + c0 - sh + q);
    }
  }
  if (!vectors) return;
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
"""
PREFETCH_PHASE = r"""template <typename S>
__device__ float staged_phase(const Side<S>& sd, int nd, int T, float c1, float c2,
                              bool keep, const Side<S>* next = nullptr, bool ready = false) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MkLayout lay(nd, sd.lo + sd.hi, T, sizeof(S));
  const long long grid = gridDim.x;
  const long long tiles = (sd.dim_out + T - 1) / T;
#pragma unroll
  for (int s = 0; s < kMkStages - 1; ++s) {
    const long long tile = blockIdx.x + s * grid;
    if (tile < tiles) {
      mk_stage(smem + s * lay.stage, lay, sd, nd, T, tile * T, !(ready && s == 0));
    }
    cp_async_commit();
  }
  float local = 0.f;
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += grid, ++it) {
    cp_async_wait_group<kMkStages - 2>();
    __syncthreads();
    const long long ahead = tile + (kMkStages - 1) * grid;
    if (ahead < tiles) {
      mk_stage(smem + (it + kMkStages - 1) % kMkStages * lay.stage, lay, sd, nd, T, ahead * T);
    }
    cp_async_commit();
    local = mk_sum<S, kMkRows>(smem + it % kMkStages * lay.stage, lay, sd, nd, c1, c2, keep,
                               tile * T, local);
  }
  cp_async_wait_group<0>();
  if (next) {
    __syncthreads();  // every thread has left stage 0
    if (blockIdx.x * static_cast<long long>(T) < next->dim_out) {
      mk_stage(smem, lay, *next, nd, T, blockIdx.x * static_cast<long long>(T), true, false);
    }
    cp_async_commit();
  }
  return local;
}
"""
PREFETCH_SIDES = r"""template <typename S, bool Staged>
__device__ float forward(const Params<S>& p, float c1, float c2) {
  if (!Staged) return forward_direct(p, c1, c2);
  const Side<S> next = side(p, true);
  return staged_phase(side(p, false), p.nd, p.T, c1, c2, false, &next);
}

template <typename S, bool Staged>
__device__ float adjoint(const Params<S>& p, float c1, float c2, bool bpos) {
  if (!Staged) return adjoint_direct(p, c1, c2, bpos);
  return staged_phase(side(p, true), p.nd, p.T, c1, c2, !bpos,
                      static_cast<const Side<S>*>(nullptr), true);
}
"""


def yardstick():
    """This checkout's ``chip_smoke.py`` (loaded by path, so that a checkout
    under test cannot replace it): its shapes, seeds and ``time_ms``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def replace_function(src, head, body):
    """``src`` with the function that starts at the line ``head`` (up to
    its closing brace at the start of a line) replaced by ``body``."""
    start = src.find(head)
    end = src.find("\n}\n", start)
    if start < 0 or end < 0 or src.count(head) != 1:
        raise RuntimeError(f"csrc/megakernel.cu: the function {head!r} moved")
    return src[:start] + body.rstrip("\n") + src[end + 2:]


STAGE_HEAD = "template <typename S>\n__device__ __forceinline__ void mk_stage("
PHASE_HEAD = "template <typename S>\n__device__ float staged_phase("
FORWARD_HEAD = "template <typename S, bool Staged>\n__device__ float forward("
ADJOINT_HEAD = "template <typename S, bool Staged>\n__device__ float adjoint("
BYTES_LINE = "    bytes = T ? tables + 16LL * nd4 : 0;\n"


def shipped_source(constants=None):
    """csrc/megakernel.cu with an absolute include and these constants
    replaced."""
    src = (CSRC / "megakernel.cu").read_text().replace(
        '#include "dia_pair_staged.cuh"', f'#include "{CSRC / "dia_pair_staged.cuh"}"')
    for const, value in (constants or {}).items():
        line = next((ln for ln in src.splitlines()
                     if ln.startswith(f"constexpr int {const} = ")), None)
        if line is None:
            raise RuntimeError(f"csrc/megakernel.cu no longer defines {const}")
        src = src.replace(line, f"constexpr int {const} = {value};")
    return src


def designs():
    """{name: (source, T)}: every design's source and tile."""
    rows = int(re.search(r"constexpr int kMkRows = (\d+);", shipped_source()).group(1))
    out = {name: (shipped_source(c), 256 * c.get("kMkRows", rows)) for name, c in VARIANTS}
    src = shipped_source()
    if src.count(BYTES_LINE) != 1:
        raise RuntimeError("csrc/megakernel.cu: MkLayout's bytes line moved")
    bulk = src.replace(BYTES_LINE, "    bytes = T ? tables + 16LL * nd4 + 8 * kMkStages : 0;\n")
    bulk = replace_function(bulk, PHASE_HEAD, BULK_HELPERS + BULK_PHASE)
    out["bulk"] = (bulk, 256 * rows)
    pre = replace_function(src, STAGE_HEAD, PREFETCH_STAGE)
    pre = replace_function(pre, PHASE_HEAD, PREFETCH_PHASE)
    pre = replace_function(pre, ADJOINT_HEAD, "")
    pre = replace_function(pre, FORWARD_HEAD, PREFETCH_SIDES)
    out["prefetch"] = (pre, 256 * rows)
    return out


def bind(lib):
    from lsqr_tpu_torch.ops import _cuda

    for name, sig in _cuda._SIGNATURES.items():
        if name.startswith("lsqr_mk_"):
            getattr(lib, name).argtypes = list(sig)
            getattr(lib, name).restype = ctypes.c_int
    return lib


def build(out_dir, table):
    """{design: loaded library}: every design compiled at once; each
    build's ptxas lines of the megakernels in ``{design}.log``."""
    from lsqr_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _) in table.items():
        stem = re.sub(r"\W+", "_", name)  # nvcc takes no commas in a file name
        cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs[name] = registers(log)
        libs[name] = bind(ctypes.CDLL(str(so)))
    return libs, regs


def registers(log):
    """{kernel: (registers, bytes of spill stores)} of the megakernels in a
    ptxas log (``-Xptxas=-v``); the direct route's kernels as "... direct"."""
    out, current, spill = {}, None, 0
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '\S*?(lsqr|lsmr|craig)_megakernel_"
                        r"(staged|direct)I(f|13__nv_bfloat16)E", line)
        if hit:
            current = (f"{hit.group(1)}_megakernel[{'f32' if hit.group(3) == 'f' else 'bf16'}]"
                       + ("" if hit.group(2) == "staged" else " direct"))
        elif current and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif current and "Used" in line:
            out[current] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
            current, spill = None, 0
    return out


def problem(smoke, dev, storage):
    """(operator, b, consistent b) at phase 9's main shape."""
    import torch

    import lsqr_tpu_torch as lt

    m = smoke.M_MAIN
    data, b, g = smoke.random_stripes(m, m, smoke.OFFSETS, dev, seed=100, boost=12.0)
    xt = torch.randn(m, generator=g, device=dev)
    A = lt.dia_operator_device(m, m, smoke.OFFSETS, data, storage_dtype=storage)
    return A, b, A.matvec(xt)


def prepared(smoke, solver, A, rhs):
    """(vectors, state) of the solver's setup, as phase 9 makes them."""
    mod, _ = smoke.mk_modules()[solver]
    kw = {} if solver == "craig" else dict(damp=smoke.DAMP)
    return getattr(mod, f"{solver}_megakernel_prepare")(A, rhs, itnlim=10_000, **kw)


def run_designs(reps):
    import torch

    from lsqr_tpu_torch.ops import _cuda, spmv

    smoke = yardstick()
    table = designs()
    libs, regs = build(HERE / "build" / "megakernel_designs", table)
    shipped = _cuda.library()
    regs["shipped"] = registers(_cuda.build_log())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"registers": regs, "times": {}, "grid": {}, "max_rel_diff_to_shipped": {}}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    m, ks = smoke.M_MAIN, smoke.OFFSETS
    lo, hi = spmv._halos(ks)
    for storage in (torch.float32, torch.bfloat16):
        sfx = "f32" if storage == torch.float32 else "bf16"
        A, b, bc = problem(smoke, dev, storage)
        for solver in SOLVERS:
            tag = f"{solver}_megakernel[{sfx}]"
            _, wrapper = smoke.mk_modules()[solver]
            vectors, state = prepared(smoke, solver, A, bc if solver == "craig" else b)
            start = [t.clone() for t in (*vectors, state)]
            mine = [t.clone() for t in start]
            kw = dict(offsets=ks, m=m, n=m, K=smoke.MK_K, offsets_t=A.offsets_t,
                      toffsets_t=A.toffsets_t)
            wrapper(A.data, A.tdata, *mine, **kw)
            ref = [t.clone() for t in mine]
            rule_grid = wrapper.blocks
            ms = smoke.time_ms(lambda: (mine[-1].copy_(start[-1]),
                                        wrapper(A.data, A.tdata, *mine, **kw)), reps)
            key = f"{tag} shipped (T {wrapper.tile})"
            res["times"][key], res["grid"][key] = ms, rule_grid
            smoke.log(f"  {key:44s} {ms:.4f} ms, grid {rule_grid}  [{regs['shipped'].get(tag)}]")
            own = ctypes.c_int(0)
            _cuda.check(shipped.lsqr_mk_grid(SOLVER_IDS[solver], int(storage == torch.bfloat16),
                                             m, len(ks), lo + hi, 0, ctypes.byref(own)),
                        "lsqr_mk_grid")
            # (design, library, T, blocks)
            runs = [("direct at the staged grid", shipped, 0, rule_grid),
                    ("direct at its own grid", shipped, 0, own.value),
                    ("grid 1 an SM", shipped, wrapper.tile, sms)]
            for name, (_, T) in table.items():
                blocks = ctypes.c_int(0)
                _cuda.check(libs[name].lsqr_mk_grid(
                    SOLVER_IDS[solver], int(storage == torch.bfloat16), m, len(ks), lo + hi, T,
                    ctypes.byref(blocks)), name)
                runs.append((name, libs[name], T, blocks.value))
            for name, lib, T, blocks in runs:
                fn = getattr(lib, f"lsqr_mk_{solver}_{sfx}")
                partial = torch.empty(3 * blocks, device=dev)
                vec = [t.clone() for t in start]
                u, v, x = vec[:3]
                w = vec[3] if solver != "craig" else None
                hbar = vec[4] if solver == "lsmr" else None

                def call(vec=vec, fn=fn, T=T, blocks=blocks, partial=partial, w=w, hbar=hbar):
                    ptr = [None if t is None else t.data_ptr() for t in (w, hbar)]
                    _cuda.check(fn(A.data.data_ptr(), A.tdata.data_ptr(), A.offsets_t.data_ptr(),
                                   A.toffsets_t.data_ptr(), len(ks), m, m, vec[0].data_ptr(),
                                   vec[1].data_ptr(), vec[2].data_ptr(), *ptr,
                                   vec[-1].data_ptr(), partial.data_ptr(), blocks,
                                   smoke.MK_K, lo, hi, T, stream()), name)
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(a, r) for a, r in zip(vec, ref))
                worst = max(smoke.rel(a, r) for a, r in zip(vec[:-1], ref[:-1]))
                st, sr = vec[-1].double(), ref[-1].double()
                worst = max(worst, float(((st - sr).abs() / sr.abs().clamp_min(1e-6)).max()))
                keeps = T == wrapper.tile and blocks == rule_grid
                key = f"{tag} {name} (T {T})"
                kern = tag + ("" if T else " direct")
                res["max_rel_diff_to_shipped"][key] = worst
                ms = smoke.time_ms(lambda: (vec[-1].copy_(start[-1]), call()), reps)
                res["times"][key], res["grid"][key] = ms, blocks
                smoke.log(f"  {key:44s} {ms:.4f} ms, grid {blocks}, max rel diff "
                          f"{worst:.2e}{' (bits)' if same else ''}  "
                          f"[{regs.get(name, regs['shipped']).get(kern)}]")
                if keeps:
                    smoke.check(same, f"{key}: not the shipped build's bits")
                smoke.check(worst <= smoke.MK_TOL, f"{key}: differs by {worst:.3e}")
            del vectors, state, start, mine, ref
        del A, b, bc
        torch.cuda.empty_cache()
    run_bands(smoke, shipped, reps, res)
    run_spread(smoke, reps, res)
    return res


def run_bands(smoke, lib, reps, res):
    """The shipped LSQR megakernel at BANDS: the rule's route, and the
    direct route at the staged grid and at its own grid (within MK_TOL of
    the rule's)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import _cuda, megakernel, spmv

    dev = torch.device("cuda")
    m = 2 ** 20
    for nd in BANDS:
        ks = tuple(range(-(nd // 2), nd // 2 + 1))
        lo, hi = spmv._halos(ks)
        data, b, _ = smoke.random_stripes(m, m, ks, dev, seed=100 + nd, boost=float(nd))
        for storage in (torch.float32, torch.bfloat16):
            A = lt.dia_operator_device(m, m, ks, data, storage_dtype=storage)
            vectors, state = prepared(smoke, "lsqr", A, b)
            start = [t.clone() for t in (*vectors, state)]
            tile, grid = megakernel.route("lsqr", A.data, ks, m, m)
            own = ctypes.c_int(0)
            _cuda.check(lib.lsqr_mk_grid(0, int(storage == torch.bfloat16), m, nd, lo + hi, 0,
                                         ctypes.byref(own)), "lsqr_mk_grid")
            out = {}
            for label, route in ((f"rule (T {tile})", (tile, grid)),
                                 ("direct at the staged grid", (0, grid)),
                                 ("direct at its own grid", (0, own.value))):
                vec = [t.clone() for t in start]
                kw = dict(offsets=ks, m=m, n=m, K=smoke.MK_K, offsets_t=A.offsets_t,
                          toffsets_t=A.toffsets_t, _route=route)
                megakernel.lsqr_megakernel_call(A.data, A.tdata, *vec, **kw)
                out[label] = [t.clone() for t in vec]
                ms = smoke.time_ms(lambda: (vec[-1].copy_(start[-1]),
                                            megakernel.lsqr_megakernel_call(A.data, A.tdata,
                                                                            *vec, **kw)), reps)
                key = f"lsqr_megakernel[{'f32' if storage == torch.float32 else 'bf16'}] " \
                      f"2^20 x {nd} {label}"
                res["times"][key], res["grid"][key] = ms, route[1]
                smoke.log(f"  {key:60s} {ms:.4f} ms, grid {route[1]}")
            for label in ("direct at the staged grid", "direct at its own grid"):
                worst = route_diff(smoke, out[label], out[f"rule (T {tile})"])
                smoke.check(worst <= smoke.MK_TOL, f"2^20 x {nd}: {label} differs by {worst:.3e}")
            del A, vectors, state, start, out
        del data, b
        torch.cuda.empty_cache()


def route_diff(smoke, got, ref):
    """The max relative difference of one call's vectors and state (as
    phase 9 holds a megakernel to its twin)."""
    worst = max(smoke.rel(a, r) for a, r in zip(got[:-1], ref[:-1]))
    st, sr = got[-1].double(), ref[-1].double()
    return max(worst, float(((st - sr).abs() / sr.abs().clamp_min(1e-6)).max()))


def run_spread(smoke, reps, res):
    """The shipped LSQR megakernel on sparse bands at 2^24 (SPREADS): the
    staged route (where its stages fit) against the direct route at its own
    grid, whatever the rule takes."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import megakernel, spmv

    dev = torch.device("cuda")
    m = 2 ** 24
    optin = spmv._smem_limits(dev)[1]
    for s in SPREADS:
        for ks in ((-s, -1, 0, 1, s), (-s, 0, s)):
            lo, hi = spmv._halos(ks)
            data, b, _ = smoke.random_stripes(m, m, ks, dev, seed=300 + s, boost=12.0)
            for storage in (torch.float32, torch.bfloat16):
                A = lt.dia_operator_device(m, m, ks, data, storage_dtype=storage)
                bf16 = storage == torch.bfloat16
                esize = A.data.element_size()
                vectors, state = prepared(smoke, "lsqr", A, b)
                start = [t.clone() for t in (*vectors, state)]
                routes = [("direct", 0)]
                if spmv.mk_stage_bytes(len(ks), lo, hi, spmv.MK_TILE, esize) \
                        + spmv.MK_STATIC_BYTES <= optin:
                    routes.insert(0, ("staged", spmv.MK_TILE))
                out = {}
                for label, tile in routes:
                    grid = megakernel._grid_cached("lsqr", bf16, m, len(ks), lo + hi, tile,
                                                   dev.index or 0)
                    vec = [t.clone() for t in start]
                    kw = dict(offsets=ks, m=m, n=m, K=smoke.MK_K, offsets_t=A.offsets_t,
                              toffsets_t=A.toffsets_t, _route=(tile, grid))
                    megakernel.lsqr_megakernel_call(A.data, A.tdata, *vec, **kw)
                    out[label] = [t.clone() for t in vec]
                    ms = smoke.time_ms(lambda: (vec[-1].copy_(start[-1]),
                                                megakernel.lsqr_megakernel_call(
                                                    A.data, A.tdata, *vec, **kw)), reps)
                    ratio = (spmv.MK_TILE + lo + hi) / (len(ks) * spmv.MK_TILE)
                    key = (f"lsqr_megakernel[{'bf16' if bf16 else 'f32'}] 2^24 "
                           f"{ks} {label}")
                    res["times"][key], res["grid"][key] = ms, grid
                    res.setdefault("window_ratio", {})[key] = ratio
                    smoke.log(f"  {key:64s} {ms:.4f} ms, grid {grid}, window / reads "
                              f"{ratio:.3f}, rule T {spmv.mk_tile(len(ks), lo, hi, esize, optin)}")
                if "staged" in out:
                    worst = route_diff(smoke, out["direct"], out["staged"])
                    smoke.check(worst <= smoke.MK_TOL, f"2^24 {ks}: the routes differ by "
                                f"{worst:.3e}")
                del A, vectors, state, start, out
            del data, b
            torch.cuda.empty_cache()


def one(root, reps, dump):
    """Times, solves and results of the checkout at ``root`` (this process)."""
    sys.path.insert(0, str(root))
    import inspect

    import torch

    import lsqr_tpu_torch as lt

    assert Path(lt.__file__).resolve().is_relative_to(Path(root).resolve()), lt.__file__
    smoke = yardstick()
    dev = torch.device("cuda")
    out, saved = {}, {}
    m = smoke.M_MAIN
    for storage in (torch.float32, torch.bfloat16):
        sfx = "" if storage == torch.float32 else "[bf16]"
        A, b, bc = problem(smoke, dev, storage)
        for solver in SOLVERS:
            _, wrapper = smoke.mk_modules()[solver]
            vectors, state = prepared(smoke, solver, A, bc if solver == "craig" else b)
            start = state.clone()
            kw = dict(offsets=A.offsets, m=m, n=m, K=smoke.MK_K, offsets_t=A.offsets_t,
                      toffsets_t=A.toffsets_t)
            wrapper(A.data, A.tdata, *vectors, state, **kw)
            tag = f"{solver}_megakernel{sfx}"
            saved[tag] = [t.cpu() for t in (*vectors, state)]
            ms = smoke.time_ms(lambda: (state.copy_(start),
                                        wrapper(A.data, A.tdata, *vectors, state, **kw)), reps)
            out[tag] = dict(ms=ms, tile=getattr(wrapper, "tile", None), blocks=wrapper.blocks)
        for solver, fn, rhs, kw in (("lsqr", lt.lsqr, b, dict(damp=smoke.DAMP)),
                                    ("lsmr", lt.lsmr, b, dict(damp=smoke.DAMP)),
                                    ("craig", lt.craig, bc, {})):
            res = fn(A, rhs, megakernel=True, atol=1e-6, btol=1e-6, **kw)
            out[f"solve {solver}{sfx}"] = dict(istop=int(res.istop), itn=int(res.itn))
            saved[f"x {solver}{sfx}"] = [res.x.cpu()]
        del A, b, bc
        torch.cuda.empty_cache()
    for label, mm, ks in EXTRA:  # LSQR on the other routes' bands
        data, b, _ = smoke.random_stripes(mm, mm, ks, dev, seed=400, boost=float(len(ks)))
        for storage in (torch.float32, torch.bfloat16):
            A = lt.dia_operator_device(mm, mm, ks, data, storage_dtype=storage)
            _, wrapper = smoke.mk_modules()["lsqr"]
            vectors, state = prepared(smoke, "lsqr", A, b)
            start = state.clone()
            kw = dict(offsets=A.offsets, m=mm, n=mm, K=smoke.MK_K, offsets_t=A.offsets_t,
                      toffsets_t=A.toffsets_t)
            wrapper(A.data, A.tdata, *vectors, state, **kw)
            tag = f"lsqr_megakernel{'' if storage == torch.float32 else '[bf16]'} {label}"
            saved[tag] = [t.cpu() for t in (*vectors, state)]
            ms = smoke.time_ms(lambda: (state.copy_(start),
                                        wrapper(A.data, A.tdata, *vectors, state, **kw)), reps)
            out[tag] = dict(ms=ms, tile=getattr(wrapper, "tile", None), blocks=wrapper.blocks)
            del A, vectors, state, start
        del data, b
        torch.cuda.empty_cache()
    k_call = inspect.signature(lt.lsqr_megakernel).parameters["iters_per_call"].default
    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65, megakernel=True)
    for mm in (m, smoke.M_SMALL):
        data, b, _ = smoke.random_stripes(mm, mm, smoke.OFFSETS, dev, seed=100, boost=12.0)
        A = lt.dia_operator_device(mm, mm, smoke.OFFSETS, data)
        del data
        lt.lsqr(A, b, smoke.DAMP, **fixed)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.lsqr(A, b, smoke.DAMP, **fixed)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 64
        prof = smoke.phase_launches(A, b, ("lsqr_megakernel", k_call), megakernel=True)
        kern = prof["kernel_ms_per_iteration"]
        out[f"fixed64 m={mm}"] = dict(itn=int(res.itn), wall_ms_per_iteration=wall,
                                      kernel_ms_per_iteration=kern, device_idle=1 - kern / wall)
        saved[f"x fixed64 m={mm}"] = [res.x.cpu()]
        del A, b
        torch.cuda.empty_cache()
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
    return out


def rel_diff(got, ref, state=False):
    """max |got - ref| relative to max |ref| (a vector), or entry by entry
    to max(|ref|, 1e-6) (the state: scalars of every size), as phase 9
    holds a megakernel to its twin."""
    got, ref = got.double(), ref.double()
    if state:
        return float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def run_times(roots, reps):
    import torch

    runs = []
    dumps = HERE / "build" / "megakernel_designs" / "times"
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
                tag: [float((a.double() - b.double()).abs().max())
                      for a, b in zip(this[tag], first[tag])] for tag in this}
            runs[-1]["max_rel_diff_to_first"] = {
                tag: max(rel_diff(a, b, state=not tag.startswith("x ") and j == len(this[tag]) - 1)
                         for j, (a, b) in enumerate(zip(this[tag], first[tag]))) for tag in this}
        print(json.dumps(runs[-1]), flush=True)
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["designs", "times"])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="write the result to this JSON file too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.reps, args.dump)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("megakernel_designs: no CUDA device", file=sys.stderr)
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
