#!/usr/bin/env python3
"""Designs of the staged DIA product (``dia_matvec`` and
``dia_product_shared``, csrc/dia_product_staged.cuh) and of the staged
fused half-step that shares its kernel (``dia_fused_halfstep_v2`` and
``_v3``), and their times against the parent's, on one card.

    python3 tools/product_designs.py designs [--reps N] [--out FILE]
    python3 tools/product_designs.py times ROOT [ROOT ...] [--reps N] [--out FILE]

The shapes: ``chip_smoke.py``'s main band (m = n = 2^23, 11 diagonals,
phase 1's stripes, seed 0) and its 81-diagonal band (``chip_smoke.MANY``,
2^20, phase 4's stripes, seed 104), f32 and bf16 stripes, and at each every
call of the two products (``chip_smoke.product_calls``): the shared forward
and ``[adjoint]``, the packed data forward, ``[t]`` on tdata and
``[column]``, data's column side; and the two half-step variants on
packed data (out = A (v c1) - c2 y, ssq).

``designs`` writes one source per design into ``build/product_designs/``
(the shipped header with a constant or a function replaced, and the staged
launchers' C entries), builds them all at once with nvcc (the library's
flags) and times each with ``chip_smoke.time_ms`` after holding its result
(a half-step's out) to the shipped build's bit for bit (every design sums
in the same order; a half-step's ssq, whose grouping a design may change,
is logged against the shipped one's). The designs:

* ``T``: the shipped build at other tiles than the rule's
  (``product_tile``, ``halfstep_tile``), and the direct kernel (T = 0, the
  parent's design: one thread an output);
* ``stages S``: S tiles in shared memory (``kProductStages``);
* ``blocks P``: at most P blocks an SM (``kProductBlocks``; 32: as many
  as fit);
* ``threads 128``: blocks of 128 threads (``kProductThreads``), at most four
  an SM;
* ``batch 8``: 8 diagonals' loads issued together (``kProductBatch``);
* ``table``: every side through the per-diagonal phase table, also where
  all rows share one 16-byte phase (``UNIFORM_LINE`` never taken);
* ``slot batch 1``: v2's last block loads the slots one at a time
  (``kSlotBatch``; the half-step's first design);
* ``block partials``: a half-step's sum of squares in one slot a block
  (each thread's squares over all its tiles, one block sum at the end)
  instead of one a tile (``BLOCK_PARTIALS`` below; its bits follow the
  grid).

Then the half-step's band sweep (``BANDS``): at 2^20 rows and 11 to 121
diagonals, f32 and bf16, v2 and v3 through the shipped build at each tile
of 1024, 512, 256 that fits against the direct kernel (the sweep behind
``halfstep_tile``'s f32 rule).

The ``bulk`` design (TMA stages: 3% faster at 11 diagonals in f32, 1.7-2x
slower at 81; PERF.md) is no longer built.

``times`` runs each ROOT (a checkout; to compare a commit with its parent,
``git archive <parent> | tar -x -C build/parent`` and pass
``build/parent . . build/parent``) in a process of its own: every call at
the shapes above through each checkout's wrappers, the kernels of rows 1,
3 and 4 that share their sources (``dia_pair_shared``, both directions of
``dia_product_shared_axpy``, ``dia_pair``) and rows 8 and 9 (v2 and v3 on
packed data, out and ssq) at the main band, and the solves that
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
#: (design, {constant: value} of the header); "blocks 32" lets as many
#: blocks an SM run as fit; "table" and "block partials" patch functions
VARIANTS = [
    ("stages 3", {"kProductStages": 3}),
    ("blocks 1", {"kProductBlocks": 1}),
    ("blocks 3", {"kProductBlocks": 3}),
    ("blocks 32", {"kProductBlocks": 32}),
    ("threads 128", {"kProductThreads": 128, "kProductBlocks": 4}),
    ("batch 8", {"kProductBatch": 8}),
    ("table", {"table": True}),
    ("slot batch 1", {"kSlotBatch": 1}),
    ("block partials", {"block partials": True}),
]
#: the designs that change only the half-step (the product's times under
#: them would repeat the shipped build's)
HALFSTEP_ONLY = ("slot batch 1", "block partials")
#: the half-step's band sweep at 2^20 rows (offsets -nd//2 .. nd//2): the
#: shipped build at every tile of the first tier that fits one block
#: against the direct kernel, f32 and bf16 (where the staged route pays)
BANDS = (11, 21, 31, 41, 53, 61, 81, 121)
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
#define DESIGN_HALFSTEP(SUFFIX, S)                                                          \
  int design_halfstep_v2_##SUFFIX(const void* data, const void* vec, const void* y,         \
                                  const void* c1, const void* c2, void* out, void* partial, \
                                  void* ticket, void* ssq, const void* offsets, int nd,     \
                                  long long dim_out, long long dim_in, int slots, int lo,   \
                                  int hi, int T, void* stream) {                            \
    const StepArgs step{static_cast<const float*>(y), static_cast<const float*>(c1),        \
                        static_cast<const float*>(c2), static_cast<float*>(partial),        \
                        static_cast<unsigned int*>(ticket), static_cast<float*>(ssq)};      \
    return launch_halfstep_staged<S, S, kTicketed>(data, vec, out, offsets, nd, dim_out,    \
                                                   dim_in, lo, hi, T, slots, step,          \
                                                   static_cast<cudaStream_t>(stream));      \
  }                                                                                         \
  int design_halfstep_v3_##SUFFIX(const void* data, const void* vec, const void* y,         \
                                  const void* c1, const void* c2, void* out, void* partial, \
                                  const void* offsets, int nd, long long dim_out,           \
                                  long long dim_in, int slots, int lo, int hi, int T,       \
                                  void* stream) {                                           \
    const StepArgs step{static_cast<const float*>(y), static_cast<const float*>(c1),        \
                        static_cast<const float*>(c2), static_cast<float*>(partial),        \
                        nullptr, nullptr};                                                  \
    return launch_halfstep_staged<S, S, kPartials>(data, vec, out, offsets, nd, dim_out,    \
                                                   dim_in, lo, hi, T, slots, step,          \
                                                   static_cast<cudaStream_t>(stream));      \
  }
DESIGN_HALFSTEP(f32, float)
DESIGN_HALFSTEP(bf16, __nv_bfloat16)
}
"""

#: the block-partials design: (shipped text, replacement) pairs of the
#: staged kernel: no slot a tile, each thread's squares over all its tiles,
#: one block sum into slot blockIdx.x, and v2's last block adds gridDim.x
#: slots
BLOCK_PARTIALS = [
    ("""    if constexpr (kStep) {  // the tile before's warp sums are all in
      if (threadIdx.x == 0 && it > 0) {
        step.partial[tile - grid] = warps_total(red + (it - 1) % 2 * kProductWarps);
      }
    }
""", ""),
    ("  int it = 0;\n  for (long long tile = blockIdx.x;",
     "  int it = 0;\n  float blk = 0.0f;\n  for (long long tile = blockIdx.x;"),
    ("""    if constexpr (kStep) {
      const float w = warp_sum(ssq);
      if ((threadIdx.x & 31) == 0) red[it % 2 * kProductWarps + threadIdx.x / 32] = w;
    }
""", "    if constexpr (kStep) blk += ssq;\n"),
    ("""    __syncthreads();  // the last tile's warp sums
    if (threadIdx.x == 0 && it > 0) {
      step.partial[blockIdx.x + (it - 1) * grid] = warps_total(red + (it - 1) % 2 * kProductWarps);
    }
""", """    const float w = warp_sum(blk);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = w;
    __syncthreads();
    if (threadIdx.x == 0) step.partial[blockIdx.x] = warps_total(red);
"""),
    ("b0 < tiles;", "b0 < gridDim.x;"),
    ("p[j] = b < tiles ?", "p[j] = b < gridDim.x ?"),
]


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
    """csrc/dia_product_staged.cuh with these constants (and, for "table",
    the phase table on every side; for "block partials", BLOCK_PARTIALS)."""
    src = (CSRC / HEADER).read_text().replace(
        '#include "dia_pair_staged.cuh"', f'#include "{CSRC / "dia_pair_staged.cuh"}"')
    constants = dict(constants)
    if constants.pop("table", False):
        if src.count(UNIFORM_LINE) != 1:
            raise RuntimeError(f"csrc/{HEADER}: the launcher's uniform-phase test moved")
        src = src.replace(UNIFORM_LINE, "  if (false) {\n")
    if constants.pop("block partials", False):
        for old, new in BLOCK_PARTIALS:
            if src.count(old) != 1:
                raise RuntimeError(f"csrc/{HEADER}: the staged kernel's sum of squares moved")
            src = src.replace(old, new)
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
            v2 = getattr(lib, f"design_halfstep_v2_{s}")
            v2.argtypes = [P] * 10 + [I, L, L, I, I, I, I, P]
            v3 = getattr(lib, f"design_halfstep_v3_{s}")
            v3.argtypes = [P] * 8 + [I, L, L, I, I, I, I, P]
            for f in (fn, v2, v3):
                f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def stage_bytes(name, nd, lo, hi, T, esize, halfstep=False):
    """A design's shared memory at tile T: the rule's mirror (the product's
    or the half-step's) at the design's stage count."""
    from lsqr_tpu_torch.ops import spmv

    constants = dict(next((c for n, c in VARIANTS if n == name), {}))
    stages = constants.get("kProductStages", spmv.PRODUCT_STAGES)
    mirror = spmv.halfstep_stage_bytes if halfstep else spmv.product_stage_bytes
    return mirror(nd, lo, hi, T, esize, stages)


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
    res = {"times": {}, "max_abs_diff_to_shipped": {}, "tiles": {}, "ssq_rel_to_shipped": {}}

    def record(tag, fn, ref):
        """Time fn after holding its result (a half-step's out) to ref's."""
        got = fn()
        torch.cuda.synchronize()
        ssq = ""
        if isinstance(ref, tuple):  # a half-step: (out, ssq)
            rel = abs(float(got[1]) - float(ref[1])) / abs(float(ref[1]))
            res["ssq_rel_to_shipped"][tag] = rel
            ssq = f", ssq rel {rel:.2e}"
            got, ref = got[0], ref[0]
        diff = smoke.absdiff(got, ref)
        res["max_abs_diff_to_shipped"][tag] = diff
        res["times"][tag] = smoke.time_ms(fn, reps)
        smoke.log(f"  {tag:60s} {res['times'][tag]:.5f} ms  (max |diff| to shipped {diff:.3e}"
                  f"{ssq})")
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
                    if design in HALFSTEP_ONLY or stage_bytes(design, len(ks), lo, hi, rule,
                                                              storage.itemsize) > optin:
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
            halfsteps(Ap, y, v, ks, m, label, sfx, libs, record, optin)
            del As, Ap
            torch.cuda.empty_cache()
        del data, y, v
        torch.cuda.empty_cache()
    band_sweep(smoke, dev, record, optin)
    return res


def band_sweep(smoke, dev, record, optin):
    """BANDS: v2 and v3 on packed data at 2^20 rows through the shipped
    build at each tile of the first tier that fits, held to the direct
    kernel (the reference here), f32 and bf16."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    m = smoke.MANY[0]
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    for nd in BANDS:
        ks = tuple(range(-(nd // 2), nd - nd // 2))
        data, y, g = smoke.random_stripes(m, m, ks, dev, seed=nd)
        v = torch.randn(m, generator=g, device=dev)
        for storage in (torch.float32, torch.bfloat16):
            A = lt.dia_operator_device(m, m, ks, data, storage_dtype=storage)
            kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
            rule = spmv._halfstep_rule(A.data, ks)
            sfx = "" if storage == torch.float32 else "[bf16]"
            for wrapper in (spmv.dia_fused_halfstep_v2, spmv.dia_fused_halfstep_v3):
                side = f"{wrapper.__name__}{sfx} 2^20 x {nd} (rule's T {rule})"
                launch = lambda w=wrapper, T=0: spmv._halfstep_launch(  # noqa: E731
                    w, A.data, y, v, c1, c2, tile=T, **kw)
                ref = launch()
                record(f"{side} direct (T 0)", launch, ref)
                for T in spmv.PRODUCT_TILES[0]:
                    if spmv.halfstep_stage_bytes(nd, *spmv._halos(ks), T,
                                                 storage.itemsize) <= optin:
                        record(f"{side} shipped T {T}", lambda w=wrapper, T=T: launch(w, T), ref)
            del A
        del data, y, v
        torch.cuda.empty_cache()


def halfsteps(Ap, y, v, ks, m, label, sfx, libs, record, optin):
    """Rows 8 and 9 (v2, v3) on packed data through ``record``: the shipped
    build at the rule's tile (``halfstep_tile``), the direct kernel, the
    shipped build at other tiles, each design at the rule's tile."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    dev = Ap.data.device
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    kw = dict(offsets=ks, m=m, n=m, offsets_t=Ap.offsets_t)
    lo, hi = spmv._halos(ks)
    esize = Ap.data.dtype.itemsize
    rule = spmv._halfstep_rule(Ap.data, ks)
    stream = torch.cuda.current_stream().cuda_stream
    for wrapper in (spmv.dia_fused_halfstep_v2, spmv.dia_fused_halfstep_v3):
        v2 = wrapper is spmv.dia_fused_halfstep_v2
        side = f"{wrapper.__name__}{'' if sfx == 'f32' else '[bf16]'} {label}"
        shipped = lambda w=wrapper, T=rule: spmv._halfstep_launch(  # noqa: E731
            w, Ap.data, y, v, c1, c2, tile=T, **kw)
        ref = shipped()
        record(f"{side} shipped, the rule's T {rule}", shipped, ref)
        record(f"{side} direct (T 0)", lambda w=wrapper: spmv._halfstep_launch(
            w, Ap.data, y, v, c1, c2, tile=0, **kw), ref)
        for T in PRODUCT_TS:
            if T != rule and spmv.halfstep_stage_bytes(len(ks), lo, hi, T, esize) <= optin:
                record(f"{side} shipped T {T}", lambda w=wrapper, T=T: shipped(w, T), ref)
        for design, lib in libs.items():
            if stage_bytes(design, len(ks), lo, hi, rule, esize, halfstep=True) > optin:
                continue
            entry = getattr(lib, f"design_halfstep_{'v2' if v2 else 'v3'}_{sfx}")

            def call(entry=entry, v2=v2):
                out = torch.empty(m, dtype=Ap.data.dtype, device=dev)
                partial = torch.zeros(-(-m // rule), device=dev)
                ssq = torch.empty((), device=dev)
                extra = (spmv._ticket(dev).data_ptr(), ssq.data_ptr()) if v2 else ()
                err = entry(Ap.data.data_ptr(), v.data_ptr(), y.data_ptr(), c1.data_ptr(),
                            c2.data_ptr(), out.data_ptr(), partial.data_ptr(), *extra,
                            Ap.offsets_t.data_ptr(), len(ks), m, m, partial.shape[0], lo, hi,
                            rule, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return out, (ssq if v2 else torch.sum(partial))
            record(f"{side} {design} T {rule}", call, ref)


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
                    f"dia_fused_halfstep_v2{sfx}": lambda: spmv.dia_fused_halfstep_v2(
                        Ap.data, y, v, c1, c2, offsets_t=Ap.offsets_t, **kw),
                    f"dia_fused_halfstep_v3{sfx}": lambda: spmv.dia_fused_halfstep_v3(
                        Ap.data, y, v, c1, c2, offsets_t=Ap.offsets_t, **kw),
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
