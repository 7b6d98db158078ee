#!/usr/bin/env python3
"""Designs of the WWCOO pair's one-pass kernel (``csrc/chunked_coo.cuh``:
``pair_chunks``) timed against each other and against its other routes on
RWCOO's cold stream.

    python3 tools/wwcoo_pair_designs.py [--reps N] [--turns K] [--out FILE]

At ``bench.py``'s RWCOO Zipf shape (m = 2^21, n = 65,536, 10,485,760
entries, seed 0, through ``auto_operator``) the cold stream's pair
(``spmv_wcoo.wwcoo_pair``, c2 = 0.3) is timed by ``chip_smoke.time_ms``
(the mean device time of ``--reps`` calls) on

- this checkout's library (its own route there, "chunk": the one-pass
  kernel, then the expansion);
- each design of ``DESIGNS``: this checkout's ``csrc/chunked_coo.cuh`` and
  ``csrc/wwcoo.cu`` with a constant changed or source patches applied (the
  three kernels in turn, as the "sequence" route launches them: the
  parent's pair; the expansion after a grid-wide barrier or launched early,
  no pipeline or a deeper one, L2 prefetches, the compaction's first loads
  after the block barrier; the probes skip phases of the one-pass kernel),
  built alone into ``build/wwcoo_pair_designs/<name>/`` and called through
  the same wrapper,

all in ``--turns`` turns. Every run's u and z must be the bits of this
checkout's ``wwcoo_forward`` followed by ``wwcoo_adjoint`` on the same
inputs (not a probe's); the CUDA kernels one call launches, and their
device times, are read from the profiler.
Beside them: the forward and the adjoint alone, and the cold stream's two
``torch.sparse_csr_tensor`` products (A @ x, the CSR of A' @ y). Prints one
JSON object (the card's name and power limit with it) and writes it to
``--out``. Needs one CUDA device.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
M, N_WIDE, NNZ = 2 ** 21, 65536, 10 * 2 ** 20

#: source patches (old text, new text) of csrc/chunked_coo.cuh, each old
#: text found once. The probes skip a phase of the one-pass kernel (their u
#: or z is wrong; their time is that of the rest).
NO_COMPACTION = [("  compact_chunk<kShift, true>(vals, idx, RowsShared{us}",
                  "  if (false) compact_chunk<kShift, true>(vals, idx, RowsShared{us}")]
NO_FORWARD = [("  pair_forward(vals_r", "  if (false) pair_forward(vals_r")]
#: every plan to the three kernels in turn (the sequence route; the
#: parent's pair)
SEQUENCE = [("  if (windows != 1 || splits != 1) return cudaSuccess;\n",
             "  return cudaSuccess;\n")]
#: the forward's pipeline: the shipped loop, with the next batch's row ends
#: in flight
PIPELINE = """  Ends next;
  load_ends(threadIdx.x >> 5, next);
  for (int k0 = threadIdx.x >> 5; k0 < kGroups; k0 += step) {
    const Ends e = next;
    load_ends(k0 + step, next);
    Slots sl;
    load_slots(e, sl);
    finish(k0, e, sl);
  }
"""
#: no pipeline: a batch's row ends, then its slots, then its sums
DEPTH0 = [(PIPELINE, """  for (int k0 = threadIdx.x >> 5; k0 < kGroups; k0 += step) {
    Ends e;
    load_ends(k0, e);
    Slots sl;
    load_slots(e, sl);
    finish(k0, e, sl);
  }
""")]
#: two deep: the row ends of the batch after next and the next batch's
#: first-step slots in flight
DEPTH2 = [(PIPELINE, """  Ends e1, e2;
  Slots s1;
  load_ends(threadIdx.x >> 5, e1);
  load_ends((threadIdx.x >> 5) + step, e2);
  load_slots(e1, s1);
  for (int k0 = threadIdx.x >> 5; k0 < kGroups; k0 += step) {
    const Ends e = e1;
    const Slots sl = s1;
    e1 = e2;
    load_slots(e1, s1);
    load_ends(k0 + 2 * step, e2);
    finish(k0, e, sl);
  }
""")]
#: L2 prefetches of the chunk's column-sorted copy before its staging
PREFETCH = [("  const int* cmt = colmap + t * d_pad;\n", """  const int* cmt = colmap + t * d_pad;
  const char* pv = reinterpret_cast<const char*>(vals + t * emax);
  const char* pi = reinterpret_cast<const char*>(idx + t * emax);
  for (long long o = threadIdx.x * 128LL; o < emax * 4LL; o += blockDim.x * 128LL) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(pv + o));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(pi + o));
  }
""")]
#: the pair's launch (the shipped one-pass kernel)
PAIR_LAUNCH = """  pair_chunks<kShift><<<static_cast<unsigned>(nc), threads, smem, stream>>>(
      static_cast<const float*>(vals_r), static_cast<const int*>(col_r),
      static_cast<const int*>(gpe), static_cast<const float*>(vals),
      static_cast<const unsigned*>(idx), static_cast<const int*>(colmap), d_pad,
      static_cast<const float*>(x), n, static_cast<const float*>(y), y_len,
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<float*>(u),
      static_cast<float*>(partials), m_pad, eb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kLanes = 8;
"""
#: the pair's expansion launch (the shipped second launch)
EXPAND_LAUNCH = """  expand_columns<kLanes><<<static_cast<unsigned>((static_cast<long long>(n) * kLanes +
                                                   kExpandThreads - 1) / kExpandThreads),
                           kExpandThreads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<const int*>(zptr),
      static_cast<const int*>(zsrc), d_pad, 1, static_cast<float*>(z), n);
  return cudaGetLastError();"""
#: the expansion launched while the pair still runs (programmatic dependent
#: launch): the pair lets it be scheduled at once, it waits for the pair
EARLY = [
    ("  const long long gt = static_cast<long long>(blockIdx.x) * kExpandThreads + threadIdx.x;\n"
     "  const long long c = gt / kLanes;",
     "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
     "  const long long gt = static_cast<long long>(blockIdx.x) * kExpandThreads + threadIdx.x;\n"
     "  const long long c = gt / kLanes;"),
    ("  const long long t = blockIdx.x;  // the block's chunk\n",
     "  const long long t = blockIdx.x;  // the block's chunk\n"
     "  asm volatile(\"griddepcontrol.launch_dependents;\");\n"),
    (EXPAND_LAUNCH, """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((static_cast<long long>(n) * kLanes +
                                            kExpandThreads - 1) / kExpandThreads));
  cfg.blockDim = dim3(kExpandThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, expand_columns<kLanes>, static_cast<const float*>(partials),
                            static_cast<const int*>(zptr), static_cast<const int*>(zsrc),
                            d_pad, 1, static_cast<float*>(z), n);"""),
]
#: the expansion in the same launch after a grid-wide barrier (a
#: cooperative grid: every chunk's block co-resident), its partials read
#: through L2, in expand_columns' order
GRID = [
    ("#include <cuda_runtime.h>\n", "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
    ("    float* __restrict__ partials, long long u_len, int eb) {",
     "    float* __restrict__ partials, long long u_len, int eb, const int* __restrict__ zptr,\n"
     "    const int* __restrict__ zsrc, float* __restrict__ z) {"),
    ("""                              eb, eb);
}
""", """                              eb, eb);
  cooperative_groups::this_grid().sync();
  constexpr int kLanes = 8;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       gt - (threadIdx.x & 31) < static_cast<long long>(n) * kLanes; gt += threads) {
    const long long c = gt / kLanes;
    const int l = static_cast<int>(gt % kLanes);
    float acc = 0.0f;
    if (c < n) {
      const int k1 = __ldg(zptr + c + 1);
      for (int k = __ldg(zptr + c) + l; k < k1; k += kLanes) {
        acc += __ldcg(partials + __ldg(zsrc + k));
      }
    }
    for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o, kLanes);
    if (l == 0 && c < n) z[c] = acc;
  }
}
"""),
    (PAIR_LAUNCH + EXPAND_LAUNCH,
     """  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e != cudaSuccess) return e;
  if (static_cast<long long>(per_sm) * sms < nc) return cudaErrorCooperativeLaunchTooLarge;
  const float* a_vr = static_cast<const float*>(vals_r);
  const int* a_cr = static_cast<const int*>(col_r);
  const int* a_g = static_cast<const int*>(gpe);
  const float* a_v = static_cast<const float*>(vals);
  const unsigned* a_i = static_cast<const unsigned*>(idx);
  const int* a_cm = static_cast<const int*>(colmap);
  const float* a_x = static_cast<const float*>(x);
  const float* a_y = static_cast<const float*>(y);
  const float* a_c1 = static_cast<const float*>(c1);
  const float* a_c2 = static_cast<const float*>(c2);
  float* a_u = static_cast<float*>(u);
  float* a_p = static_cast<float*>(partials);
  const int* a_zp = static_cast<const int*>(zptr);
  const int* a_zs = static_cast<const int*>(zsrc);
  float* a_z = static_cast<float*>(z);
  long long u_len = m_pad;
  int eb_arg = eb;
  void* args[] = {&a_vr, &a_cr, &a_g, &a_v, &a_i, &a_cm, &d_pad, &a_x, &n, &a_y, &y_len, &a_c1,
                  &a_c2, &a_u, &a_p, &u_len, &eb_arg, &a_zp, &a_zs, &a_z};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(static_cast<unsigned>(nc)), dim3(threads), args, smem,
                                     stream);"""),
]
#: the shipped pass issues each warp's first compaction loads as its
#: forward ends, before the block barrier (compact_chunk<.., true>); this
#: design puts the barrier first, as cols_compact has it (the zc zeroed,
#: then the loads)
BARRIER_FIRST = [("  // the compaction's first loads go out as this warp's forward ends; its\n"
                  "  // barrier makes the chunk's u in shared memory whole\n"
                  "  compact_chunk<kShift, true>(",
                  "  __syncthreads();\n  compact_chunk<kShift, false>(")]
#: the compaction's stream to L2 as each warp's forward ends: every tile the
#: warp will load (its subtiles g, g + G, ...), both planes, while the
#: block's other warps still sum rows
OVERLAP_L2 = [("  // the compaction's first loads go out as this warp's forward ends; its\n",
               """  {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int groups = blockDim.x / kThreads;
    const long long tile0 = t * emax + (warp % kWarps) * kTile + 4 * lane;
    for (int j = warp / kWarps; j < eb; j += groups) {
      const long long s0 = tile0 + static_cast<long long>(j) * kSubtile;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(vals + s0));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(idx + s0));
    }
  }
  // the compaction's first loads go out as this warp's forward ends; its
""")]
#: design name: ({constant of csrc/chunked_coo.cuh: its value}, source patches)
DESIGNS = {
    "sequence": ({}, SEQUENCE),  # the three kernels in turn (the parent's pair)
    "barrier_first": ({}, BARRIER_FIRST),  # the compaction's loads after the barrier
    "overlap_l2": ({}, OVERLAP_L2),  # the compaction's stream to L2 under the forward
    "grid": ({}, GRID),  # the expansion after a grid barrier
    "early": ({}, EARLY),  # the expansion launched while the pair runs
    "batch1": ({"kPairBatch": "1"}, []),  # row groups a warp of the forward sums at once
    "batch4": ({"kPairBatch": "4"}, []),
    "depth0": ({}, DEPTH0),  # batches of the forward in flight ahead
    "depth2": ({}, DEPTH2),
    "prefetch": ({}, PREFETCH),  # the compaction's stream to L2 first
    "probe_forward_only": ({}, NO_COMPACTION),
    "probe_no_forward": ({}, NO_FORWARD),
    "probe_staging_only": ({}, NO_COMPACTION + NO_FORWARD),
}


def yardstick():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(name, design):
    """Build the WWCOO source alone with the design's constants changed and
    its patches applied; returns its ctypes library."""
    from lsqr_tpu_torch.ops import _cuda

    out = HERE / "build" / "wwcoo_pair_designs" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    src = (_cuda.CSRC / "chunked_coo.cuh").read_text()
    constants, patches = design
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} not found once in chunked_coo.cuh")
        src = src.replace(old, new)
    for const, value in constants.items():
        src, k = re.subn(rf"(constexpr (?:int|bool) {const} = )[^;]+;", rf"\g<1>{value};", src)
        if k != 1:
            raise ValueError(f"{const} not found once in chunked_coo.cuh")
    (out / "chunked_coo.cuh").write_text(src)
    shutil.copy(_cuda.CSRC / "wwcoo.cu", out / "wwcoo.cu")
    lib_path = out / "libwwcoo.so"
    _cuda._compile([out / "wwcoo.cu"], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("lsqr_wwcoo_pair_f32", "lsqr_wwcoo_adjoint_plan", "lsqr_wwcoo_pair_route"):
        getattr(lib, fn).argtypes = list(_cuda._SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def kernels_of(call):
    """The CUDA kernels one call launches: [name (cut at the argument list),
    device ms] from the profiler, the mean of 10 calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    names, ms = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0].replace("void ", "")
            if name not in ms:
                names.append(name)
            ms[name] = ms.get(name, 0.0) + e.device_time / 1e3 / 10
    return [[name, ms[name]] for name in names]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", help="write the result to this JSON file too")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wwcoo_pair_designs: no CUDA device", file=sys.stderr)
        return 1
    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo
    from lsqr_tpu_torch.ops import _cuda
    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    smoke = yardstick()
    shipped = _cuda.library()
    with ThreadPoolExecutor(len(DESIGNS)) as pool:  # nvcc runs in processes of its own
        libs = dict(zip(DESIGNS, pool.map(lambda kv: build(*kv), DESIGNS.items())))
    dev = torch.device("cuda")
    trip = zipf_column_coo(M, N_WIDE, NNZ, seed=0)
    A = lt.auto_operator(M, N_WIDE, *trip, device=dev)
    p = A.cold
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(p.n, generator=g, device=dev)
    y = torch.randn(M, generator=g, device=dev)
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(0.3, device=dev)
    u_ref = sw.wwcoo_forward(p, x, c1, c2, y)
    z_ref = sw.wwcoo_adjoint(p, u_ref)
    plan = sw.wwcoo_adjoint_plan(p.vals.device.index, p.js * 128, p.eb, p.nc)
    out = {"plan": plan, "shape": dict(m=p.m, n=p.n, nc=p.nc, eb=p.eb, d_pad=p.js * 128,
                                       slots=p.nc * p.eb * 1024)}
    out["route"] = sw.wwcoo_pair_route(p.vals.device.index, plan)
    fn_of = sw._fn
    runs = {"shipped": shipped, **libs}

    def call_for(lib):
        def call():  # the library picks its route (the wrapper's count may not follow it)
            sw._fn = lambda name: getattr(lib, name)
            try:
                return sw.wwcoo_pair(p, y, x, c1, c2)
            finally:
                sw._fn = fn_of
        return call

    calls = {}
    for key, lib in runs.items():
        call = call_for(lib)
        try:
            u, z = call()
            torch.cuda.synchronize()
        except RuntimeError as e:  # a design the card refuses is reported, not timed
            out[key] = {"error": str(e)}
            continue
        calls[key] = call
        out[key] = {"bit_equal_to_forward_then_adjoint": [bool(torch.equal(u, u_ref)),
                                                          bool(torch.equal(z, z_ref))],
                    "kernels": kernels_of(call), "ms": []}
    for _ in range(args.turns):
        for key, call in calls.items():
            out[key]["ms"].append(smoke.time_ms(call, args.reps))
    out["forward_ms"] = smoke.time_ms(lambda: sw.wwcoo_forward(p, x, c1, c2, y), args.reps)
    out["adjoint_ms"] = smoke.time_ms(lambda: sw.wwcoo_adjoint(p, y), args.reps)
    cold = ~np.isin(trip[2], A.hotmap.cpu().numpy())
    tri = [torch.from_numpy(a[cold]).to(dev) for a in (trip[1], trip[2], trip[0])]
    a, at = smoke.csr_of(*tri, M, N_WIDE), smoke.csr_of(tri[1], tri[0], tri[2], N_WIDE, M)
    out["csr_ms"] = smoke.time_ms(lambda: a @ x, args.reps)
    out["csr_t_ms"] = smoke.time_ms(lambda: at @ y, args.reps)
    out["card"] = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader").splitlines()[0]
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
