#!/usr/bin/env python3
"""Drive lsqr_tpu_torch's banded paths once on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA device (it exits non-zero, printing no result, without one),
nvcc under $CUDA_HOME or /usr/local/cuda, and scipy. It builds the kernels
from lsqr_tpu_torch/csrc into build/lsqr_tpu_torch/, then runs eight phases;
each raises on failure:

1. each hand-written kernel against its plain PyTorch twin on the card, at
   the main path's shape (m = n = 2^23, 11 diagonals: f32, and bf16
   stripes), a ragged rectangular one (f32, and the f64 products), a wide
   one, and a band wider than the pair kernels' halo (2^20, offsets
   +-1500: the two-launch route); the kernels' and the twins' times;
2. the main-path solve at m = n = 2^23 on the shared-stripe layout: f32
   stripes from a seeded generator with 12 added to the main diagonal, damp
   0.01 — a run to the machine-precision guards within 64 iterations, a
   fixed 64-iteration run for the time per iteration, and a run to
   atol = btol = 1e-6 whose answer is checked independently with the twins
   in f64;
3. the same solve with pair=False (the product+axpy kernel);
4. ``auto_operator`` on the COO triplets of a 2^20 banded f32 matrix and a
   short solve, against the same solve on the host;
5. f64 conformance at 2^16 against ``scipy.sparse.linalg.lsqr``, on the
   shared layout and through ``auto_operator`` (the packed layout), and the
   README 3x3 system through ``LSQRSolver(device="cuda")``;
6. the CUDA kernel launches one iteration of the f32 shared pair solve
   makes;
7. the phase-2 solve on the packed layout (``dia_operator_device``, same
   stripes): fixed 64 iterations, the run to 1e-6 checked in f64 and against
   phase 2's x, pair=False (the fused half-step) and fused=False (the
   product), its launches per iteration, and a band wider than the pair
   kernel's halo at 2^20;
8. bf16 stripe storage at 2^23 on both layouts: solves to 1e-6 checked in
   f64 against the bf16-rounded operator and against the f32 x, the fixed
   64-iteration time, forced half-steps (the product+axpy kernels), and the
   launches per iteration of each pair solve;
9. the three iteration megakernels (LSQR in f32 and bf16, LSMR, CRAIG)
   against their plain twins on the card: one call of K = 8 iterations
   from the same setup on the phase-7 operator (2^23, packed), and on a
   one-sided band and a ragged rectangular shape at 2^20; the kernels' and
   the twins' times per call;
10. solves through the megakernels: ``lsqr``, ``lsmr`` and ``craig`` with
   ``megakernel=True`` against the regular (pair) path on the card, in f32
   and bf16, the LSQR answer checked in f64; fixed 64-iteration LSQR runs
   with and without the megakernel at 2^23 and 2^19 (ms and CUDA launches
   per iteration); ``cgls`` (regular, and ``pair=True``) checked in f64.

Every solve of phases 2-5, 7, 8 and 10 runs with the launch counts reset
just before it and read just after; each path must launch the kernels it
runs, and every kernel variant must have launched on some path. The
second-to-last line of output is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

M_MAIN = 2 ** 23
OFFSETS = tuple(range(-5, 6))
WIDE = (2 ** 20, 2 ** 20, (-1500, 0, 1500))
DAMP = 0.01
TOL = 1e-5  # f32 kernel vs twin, relative to the max: summation order only
BF16_TOL = 1e-2  # bf16 results (the packed axpy's): one bf16 ulp is 2^-8
SHARED = "lsqr_tpu_torch/csrc/dia_shared.cu"
PACKED = "lsqr_tpu_torch/csrc/dia_packed.cu"
MEGA = "lsqr_tpu_torch/csrc/megakernel.cu"
MK_K = 8  # iterations per megakernel call in phase 9
MK_SIDE = 2 ** 20  # phase 9's one-sided and ragged shapes
M_SMALL = 2 ** 19  # phase 10's second timing size, the JAX megakernel's size class
MK_TOL = 1e-4  # megakernel vs twin after MK_K iterations, relative
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "dia_pair_shared": (SHARED, "lsqr_tpu/ops/pallas_spmv.py:1969"),
    "dia_product_shared": (SHARED, "lsqr_tpu/ops/pallas_spmv.py:1653"),
    "dia_product_shared_axpy": (SHARED, "lsqr_tpu/ops/pallas_spmv.py:2081"),
    "dia_pair": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:1418"),
    "dia_matvec": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:452"),
    "dia_matvec_axpy": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:690"),
    "dia_fused_halfstep": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:582"),
    "lsqr_megakernel": (MEGA, "lsqr_tpu/ops/megakernel.py:411"),
    "lsmr_megakernel": (MEGA, "lsqr_tpu/ops/megakernel_lsmr.py:332"),
    "craig_megakernel": (MEGA, "lsqr_tpu/ops/megakernel_craig.py:195"),
}
#: grid-wide barriers per iteration of each megakernel (csrc/megakernel.cu)
BARRIERS = {"lsqr": 3, "lsmr": 3, "craig": 2}
#: f32 vectors each call reads or writes, in units of (m, n) lengths
VECTORS = {"dia_product_shared": (1, 1), "dia_matvec": (1, 1),
           "dia_product_shared_axpy": (2, 1), "dia_matvec_axpy": (2, 1),
           "dia_fused_halfstep": (2, 1), "dia_pair_shared": (2, 2), "dia_pair": (2, 2)}


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def sh(*cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def absdiff(got, ref):
    return float((got.double() - ref.double()).abs().max())


def time_ms(fn, reps=20):
    """Mean time of one call on the card (CUDA events around ``reps`` calls
    after a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_stripes(m, n, offsets, device, seed, boost=0.0, dtype=None):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randn((len(offsets), m), generator=g, device=device, dtype=dtype)
    data[offsets.index(0)] += boost
    return data, torch.randn(m, generator=g, device=device, dtype=dtype), g


def base(variant):
    return variant.split("[")[0]


def counted(fn):
    """(fn's result, kernel launches by variant while it ran): one path of
    the main program, with every count set to 0 just before it."""
    from lsqr_tpu_torch.ops import spmv

    spmv.reset_launch_counts()
    out = fn()
    return out, spmv.launch_counts(by_variant=True)


# ---------------------------------------------------------------------------


def kernel_calls(dev, data, v, y, m, n, ks, storage):
    """{variant: [(kernel call, twin call), ...]} of every kernel taking
    these stripes (f32 or bf16 storage)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    sfx = "" if storage == torch.float32 else "[bf16]"
    As = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage)
    Ap = lt.dia_operator_device(m, n, ks, data, storage_dtype=storage)
    c1 = torch.tensor(0.8, device=dev)
    c2 = torch.tensor(1.1, device=dev)
    kw = dict(offsets=ks, m=m, n=n)
    tkw = dict(offsets=Ap.toffsets, m=n, n=m)
    # the kernels read the offsets from the device copies the operators hold
    # (as in a solve); without them each call would copy them to the card
    skw = dict(kw, offsets_t=As.offsets_t)
    pkw = dict(kw, offsets_t=Ap.offsets_t)
    ptkw = dict(tkw, offsets_t=Ap.toffsets_t)
    dp, pd, pt = As.dp, Ap.data, Ap.tdata
    calls = {
        "dia_product_shared": [
            (lambda a=a: spmv.dia_product_shared(dp, y if a else v, adjoint=a, **skw),
             lambda a=a: spmv.dia_product_shared_plain(dp, y if a else v, adjoint=a, **kw))
            for a in (False, True)],
        "dia_product_shared_axpy": [
            (lambda a=a: spmv.dia_product_shared_axpy(dp, y if a else v, v if a else y,
                                                      c1, c2, adjoint=a, **skw),
             lambda a=a: spmv.dia_product_shared_axpy_plain(dp, y if a else v,
                                                            v if a else y, c1, c2,
                                                            adjoint=a, **kw))
            for a in (False, True)],
        "dia_pair_shared": [
            (lambda: spmv.dia_pair_shared(dp, v, y, c1, c2, **skw),
             lambda: spmv.dia_pair_shared_plain(dp, v, y, c1, c2, **kw))],
        "dia_matvec": [
            (lambda: spmv.dia_matvec(pd, v, **pkw),
             lambda: spmv.dia_matvec_plain(pd, v, **kw)),
            (lambda: spmv.dia_matvec(pt, y, **ptkw),
             lambda: spmv.dia_matvec_plain(pt, y, **tkw)),
            (lambda: spmv.dia_matvec(pd, y, adjoint=True, **pkw),  # the column side
             lambda: spmv.dia_matvec_plain(pd, y, adjoint=True, **kw))],
        "dia_matvec_axpy": [
            (lambda: spmv.dia_matvec_axpy(pd, y, v, c1, c2, **pkw),
             lambda: spmv.dia_matvec_axpy_plain(pd, y, v, c1, c2, **kw)),
            (lambda: spmv.dia_matvec_axpy(pt, v, y, c1, c2, **ptkw),
             lambda: spmv.dia_matvec_axpy_plain(pt, v, y, c1, c2, **tkw)),
            # the f32 result the operators' half-steps take (bf16 stripes)
            (lambda: spmv.dia_matvec_axpy(pd, y, v, c1, c2, out_dtype=torch.float32, **pkw),
             lambda: spmv.dia_matvec_axpy_plain(pd, y, v, c1, c2, out_dtype=torch.float32,
                                                **kw))],
        "dia_pair": [
            (lambda: spmv.dia_pair(pd, y, v, c1, c2, **pkw),
             lambda: spmv.dia_pair_plain(pd, y, v, c1, c2, **kw))],
    }
    if storage == torch.float32:
        calls["dia_fused_halfstep"] = [
            (lambda: spmv.dia_fused_halfstep(pd, y, v, c1, c2, **pkw),
             lambda: spmv.dia_fused_halfstep_plain(pd, y, v, c1, c2, **kw)),
            (lambda: spmv.dia_fused_halfstep(pt, v, y, c1, c2, **ptkw),
             lambda: spmv.dia_fused_halfstep_plain(pt, v, y, c1, c2, **tkw))]
    return {name + sfx: pairs for name, pairs in calls.items()}


def hold(calls, errs, m, n, ks, bound):
    """Run every (kernel, twin) call and hold the outputs to ``bound``."""
    import torch

    for name, pairs in calls.items():
        for kernel, plain in pairs:
            got, ref = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"{name}: {a.dtype}{tuple(a.shape)} vs twin {b.dtype}{tuple(b.shape)}")
                r = rel(a, b)
                errs[name] = max(errs.get(name, 0.0), absdiff(a, b))
                tol = BF16_TOL if a.dtype == torch.bfloat16 else bound
                log(f"  {name:30s} m={m} n={n} nd={len(ks)} out {tuple(a.shape)} "
                    f"{str(a.dtype)[6:]}: max rel err {r:.3e}")
                check(r <= tol, f"{name} disagrees with its twin: {r:.3e} > {tol}")


def phase_kernels(dev, shapes, errs):
    """Phase 1: every kernel against its twin on the card; returns
    {variant: (kernel ms, twin ms, m, n, nd, stripe bytes per element)} of the
    first call of each, at the first (main-path) shape for f32 and bf16 and
    at the second for f64."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    times = {}
    for si, (m, n, ks) in enumerate(shapes):
        data, y, g = random_stripes(m, n, ks, dev, seed=si)
        v = torch.randn(n, generator=g, device=dev)
        for storage in (torch.float32, torch.bfloat16)[:2 if si == 0 else 1]:
            calls = kernel_calls(dev, data, v, y, m, n, ks, storage)
            hold(calls, errs, m, n, ks, TOL)
            if si == 0:
                for name, pairs in calls.items():
                    times[name] = (time_ms(pairs[0][0]), time_ms(pairs[0][1]), m, n,
                                   len(ks), storage.itemsize)
            del calls
        if si == 1:  # the f64 products (f64 solves on the card use them);
            # full-width f64 values: products of f32 values would be exact
            import lsqr_tpu_torch as lt

            d64 = torch.randn(data.shape, generator=g, device=dev, dtype=torch.float64)
            x64 = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
            y64 = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
            As = lt.dia_shared_operator(m, n, ks, d64)
            Ap = lt.dia_operator_device(m, n, ks, d64)
            kw = dict(offsets=ks, m=m, n=n)
            tkw = dict(offsets=Ap.toffsets, m=n, n=m)
            skw = dict(kw, offsets_t=As.offsets_t)
            calls = {
                "dia_product_shared[f64]": [
                    (lambda: spmv.dia_product_shared(As.dp, x64, adjoint=False, **skw),
                     lambda: spmv.dia_product_shared_plain(As.dp, x64, adjoint=False, **kw)),
                    (lambda: spmv.dia_product_shared(As.dp, y64, adjoint=True, **skw),
                     lambda: spmv.dia_product_shared_plain(As.dp, y64, adjoint=True, **kw))],
                "dia_matvec[f64]": [
                    (lambda: spmv.dia_matvec(Ap.data, x64, offsets_t=Ap.offsets_t, **kw),
                     lambda: spmv.dia_matvec_plain(Ap.data, x64, **kw)),
                    (lambda: spmv.dia_matvec(Ap.tdata, y64, offsets_t=Ap.toffsets_t, **tkw),
                     lambda: spmv.dia_matvec_plain(Ap.tdata, y64, **tkw))],
            }
            hold(calls, errs, m, n, ks, 1e-12)
            for name, pairs in calls.items():
                times[name] = (time_ms(pairs[0][0]), time_ms(pairs[0][1]), m, n,
                               len(ks), 8)
            del calls, As, Ap, d64
        del data, y, v
        torch.cuda.empty_cache()
    return times


def timed_solve(A, b, label, card, **kw):
    """One lsqr solve as a counted path: (result, launches by variant,
    wall seconds)."""
    import torch

    import lsqr_tpu_torch as lt

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.lsqr(A, b, DAMP, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (res, secs), delta = counted(run)
    itn, istop = int(res.itn), int(res.istop)
    check(bool(torch.isfinite(res.x).all()) and res.x.shape == (A.n,), f"{label}: bad x")
    launched = {k: v for k, v in delta.items() if v}
    log(f"  {label}: istop={istop} itn={itn} rnorm={float(res.rnorm):.6e} "
        f"arnorm={float(res.arnorm):.6e} wall={secs * 1e3:.3f} ms "
        f"({secs * 1e3 / max(itn, 1):.4f} ms/iteration incl. setup, {card}) "
        f"launches={launched}")
    return res, delta, secs


def iterations_run(itn, seg):
    """Iterations a masked-segment solve runs: itn plus the masked rest."""
    return -(-itn // seg) * seg


def optimality(forward, adjoint, fro, b, x):
    """||A'r - damp^2 x|| / (||A||_F ||(r; damp x)||) in f64 with r = b - A x,
    from f64 products (xcheck's test3, lsqr.f90:1089-1094)."""
    import torch

    x64 = x.double()
    r = b.double() - forward(x64)
    grad = adjoint(r) - DAMP ** 2 * x64
    rho = torch.sqrt(r.norm() ** 2 + (DAMP * x64.norm()) ** 2)
    return float(grad.norm() / (fro * rho))


def packed_optimality(A, b, x):
    """:func:`optimality` of a DIAOperator, from its stripes in f64 (the
    column side of data gives the adjoint without an f64 tdata)."""
    from lsqr_tpu_torch.ops.spmv import dia_matvec_plain

    d64 = A.data.double()
    kw = dict(offsets=A.offsets, m=A.m, n=A.n)
    ratio = optimality(lambda x: dia_matvec_plain(d64, x, **kw),
                       lambda r: dia_matvec_plain(d64, r, adjoint=True, **kw),
                       d64.norm(), b, x)
    del d64
    return ratio


def shared_optimality(A, b, x):
    from lsqr_tpu_torch.ops.spmv import dia_product_shared_plain

    dp64 = A.dp.double()
    kw = dict(offsets=A.offsets, m=A.m, n=A.n)
    ratio = optimality(lambda x: dia_product_shared_plain(dp64, x, adjoint=False, **kw),
                       lambda r: dia_product_shared_plain(dp64, r, adjoint=True, **kw),
                       dp64.norm(), b, x)
    del dp64
    return ratio


def phase_main_solve(dev, m, card, paths):
    """Phase 2-3: the main-path solves at m = n (2^23 on the card)."""
    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_shared_operator(m, m, OFFSETS, data)
    del data
    check(A.prefers_pair, "the f32 operator on the card must take pair mode")
    seg = lt.LSQROptions().loop_segment
    out = {}

    def solve(label, **kw):
        res, delta, secs = timed_solve(A, b, label, card, **kw)
        paths.append(delta)
        return res, delta, secs

    # (a) to the machine-precision guards, at most 64 iterations
    res, delta, _ = solve("(a) itnlim=64, atol=btol=conlim=0", itnlim=64, atol=0.0,
                          btol=0.0, conlim=0.0)
    check(int(res.istop) in (1, 2, 3, 5) and int(res.itn) <= 64, "(a) bad stop")
    check(int(res.istop) != 5 or int(res.itn) == 64, "(a) istop 5 before itnlim")
    check(delta["dia_pair_shared"] == 64 and delta["dia_product_shared"] == 1,
          f"(a) expected 64 pair launches (itn + masked) and one setup product: {delta}")

    # fixed length: nconv > itnlim keeps the solve going to itnlim
    kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    solve("warm-up 64 iterations", **kw)
    res, delta, secs = solve("fixed 64 iterations", **kw)
    check(int(res.itn) == 64 and delta["dia_pair_shared"] == 64, "fixed run: itn != 64")
    out["ms_per_iteration_fixed64"] = secs * 1e3 / 64

    # (b) to atol = btol = 1e-6
    res_b, delta, secs = solve("(b) atol=btol=1e-6", atol=1e-6, btol=1e-6)
    itn_b = int(res_b.itn)
    check(int(res_b.istop) in (1, 2, 3), f"(b) istop {int(res_b.istop)}")
    body = iterations_run(itn_b, seg)
    check(delta["dia_pair_shared"] == body,
          f"(b) pair launches {delta['dia_pair_shared']} != itn + masked = {body}")
    out["solve_b"] = dict(istop=int(res_b.istop), itn=itn_b, ms=secs * 1e3)

    # independent check of (b), in f64 with the twins: the damped normal
    # equations' residual
    ratio = shared_optimality(A, b, res_b.x)
    log(f"  (b) independent check ||A'r - damp^2 x|| / (||A||_F ||(r; damp x)||)"
        f" = {ratio:.3e}")
    check(ratio <= 1e-4, f"(b) independent optimality check {ratio:.3e} > 1e-4")
    out["optimality_b"] = ratio

    # phase 3: pair=False goes through the product+axpy kernel
    res_c, delta, secs = solve("(b) pair=False", atol=1e-6, btol=1e-6, pair=False)
    check(int(res_c.istop) == int(res_b.istop), "pair=False: istop differs")
    check(abs(int(res_c.itn) - itn_b) <= 2, "pair=False: itn differs by more than 2")
    body = iterations_run(int(res_c.itn), seg)
    check(delta["dia_product_shared_axpy"] == 2 * body and delta["dia_pair_shared"] == 0,
          f"pair=False: expected {2 * body} axpy launches: {delta}")
    check(rel(res_c.x, res_b.x) <= 1e-4, "pair=False: x differs")
    out["solve_pair_false"] = dict(istop=int(res_c.istop), itn=int(res_c.itn), ms=secs * 1e3)
    return A, b, res_b.x, out


def phase_auto_operator(dev, m, paths):
    """Phase 4: COO triplets -> auto_operator on the card -> a short solve,
    against the same solve on the host (the twins)."""
    import numpy as np
    import torch

    import lsqr_tpu_torch as lt

    rng = np.random.default_rng(4)
    i = np.arange(m)
    rows, cols, vals = [], [], []
    for k in OFFSETS:
        ok = (i + k >= 0) & (i + k < m)
        rows.append(i[ok])
        cols.append(i[ok] + k)
        vals.append(rng.standard_normal(ok.sum()).astype(np.float32) + (12.0 if k == 0 else 0.0))
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    b = rng.standard_normal(m).astype(np.float32)
    A = lt.auto_operator(m, m, vals, rows, cols, device=dev)
    check(isinstance(A, lt.DIASharedOperator) and A.dp.device.type == dev.type
          and A.offsets == OFFSETS,
          f"auto_operator chose {type(A).__name__}")
    res, delta = counted(lambda: lt.lsqr(A, b, DAMP, atol=1e-6, btol=1e-6))
    paths.append(delta)
    check(delta["dia_pair_shared"] > 0, f"auto_operator solve: no pair launches {delta}")
    ref = lt.lsqr(lt.auto_operator(m, m, vals, rows, cols), b, DAMP, atol=1e-6, btol=1e-6)
    err = rel(res.x.cpu(), ref.x)
    log(f"  auto_operator -> {type(A).__name__} on {A.dp.device}: istop={int(res.istop)} "
        f"itn={int(res.itn)}; host twin solve istop={int(ref.istop)} itn={int(ref.itn)}; "
        f"x rel diff {err:.3e}")
    check(int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 2,
          "auto_operator solve differs from the host solve")
    check(err <= 1e-4 and bool(torch.isfinite(res.x).all()), "auto_operator solve: x differs")


def scipy_istop(istop, damped):
    """scipy's lsqr taxonomy mapped to the reference's (lsqr.f90:520-538)."""
    mapped = {0: 0, 1: 1, 2: 2, 3: 4, 4: 1, 5: 2, 6: 4, 7: 5}[istop]
    return 3 if (damped and mapped == 2) else mapped


def phase_f64(dev, m, paths):
    """Phase 5: f64 on the card against scipy (shared layout, and the packed
    one through auto_operator), and the README 3x3."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg
    import torch

    import lsqr_tpu_torch as lt

    rng = np.random.default_rng(5)
    data = rng.standard_normal((len(OFFSETS), m))
    data[OFFSETS.index(0)] += 12.0
    b = rng.standard_normal(m)
    i = np.arange(m)
    ok = [(i + k >= 0) & (i + k < m) for k in OFFSETS]
    vals = np.concatenate([data[d][ok[d]] for d in range(len(OFFSETS))])
    rows = np.concatenate([i[ok[d]] for d in range(len(OFFSETS))])
    cols = np.concatenate([i[ok[d]] + k for d, k in enumerate(OFFSETS)])
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    tol = dict(atol=1e-10, btol=1e-10, conlim=1e8)
    ref = scipy.sparse.linalg.lsqr(S, b, damp=DAMP, iter_lim=2 * m, **tol)
    istop_ref, itn_ref = scipy_istop(ref[1], DAMP > 0), ref[2]

    for label, A, kernel in (
            ("shared", lt.dia_shared_operator(m, m, OFFSETS, data, device=dev),
             "dia_product_shared[f64]"),
            ("auto_operator", lt.auto_operator(m, m, vals, rows, cols, device=dev),
             "dia_matvec[f64]")):
        if label == "auto_operator":
            check(isinstance(A, lt.DIAOperator) and A.data.device.type == dev.type
                  and A.dtype == torch.float64,
                  f"auto_operator chose {type(A).__name__} for f64 on the card")
        res, launched = counted(lambda: lt.lsqr(A, b, DAMP, itnlim=2 * m, **tol))
        paths.append(launched)
        err = float(np.abs(res.x.cpu().numpy() - ref[0]).max() / np.abs(ref[0]).max())
        log(f"  f64 m=n={m} {label} -> {type(A).__name__}: port istop={int(res.istop)} "
            f"itn={int(res.itn)}; scipy istop={ref[1]} (= {istop_ref}) itn={itn_ref}; "
            f"x rel diff {err:.3e}; launches {({k: v for k, v in launched.items() if v})}")
        check(res.x.dtype == torch.float64 and res.x.device.type == dev.type,
              "the f64 solve left the card or f64")
        check(int(res.istop) == istop_ref and abs(int(res.itn) - itn_ref) <= 1,
              f"f64 {label}: istop/itn differ from scipy")
        check(err <= 1e-8, f"f64 {label}: x differs from scipy by {err:.3e}")
        check(launched[kernel] > 0 and launched["dia_pair_shared"] == 0
              and launched["dia_pair"] == 0,
              f"f64 {label} solves run unfused through the f64 product kernel")

    solver = lt.LSQRSolver(3, 3, [1.0, 4.0, 7.0, 2.0, 5.0, 88.0, 3.0, 66.0, 9.0],
                           [0, 1, 2, 0, 1, 2, 0, 1, 2], [0, 0, 0, 1, 1, 1, 2, 2, 2],
                           device=dev)
    r3 = solver.solve([1.0, 2.0, 3.0])
    x3 = r3.x.cpu().numpy()
    log(f"  README 3x3 on {r3.x.device}: istop={int(r3.istop)} x={x3.tolist()}")
    check(int(r3.istop) == 1 and np.allclose(x3, [1.242424, -0.06060606, -0.04040404],
                                               rtol=1e-5), "README 3x3")


def phase_launches(A, b, **extra):
    """Phase 6 (and 7, 8, 10): CUDA launches per iteration of a solve (the
    pair solve, or ``extra``'s), from the profiler: (launches of a
    128-iteration run - a 64-iteration run) / 64."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lsqr_tpu_torch as lt

    counts = {}
    for itnlim in (64, 128):
        kw = dict(itnlim=itnlim, atol=0.0, btol=0.0, conlim=0.0, nconv=itnlim + 1, **extra)
        lt.lsqr(A, b, DAMP, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lt.lsqr(A, b, DAMP, **kw)
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        launch_calls = [e for e in events if "LaunchKernel" in e.name]
        by_name = {}
        for e in kernels:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.device_time / 1e3)
        counts[itnlim] = (len(kernels), len(launch_calls),
                          sum(t for _, t in by_name.values()), by_name)
    per_iter = (counts[128][0] - counts[64][0]) / 64
    calls = (counts[128][1] - counts[64][1]) / 64
    busy = (counts[128][2] - counts[64][2]) / 64
    log(f"  device kernels per iteration: {per_iter:.2f} (runtime launch calls seen: "
        f"{calls:.2f}); kernel time per iteration {busy:.4f} ms")
    check(per_iter > 0, "the profiler saw no CUDA kernels")
    top = sorted(counts[128][3].items(), key=lambda kv: -kv[1][1])[:10]
    for name, (n, t) in top:  # the 128-iteration run, setup included
        log(f"    {t / 128:9.4f} ms/it  {n / 128:6.2f} launches/it  {name[:90]}")
    return dict(kernels_per_iteration=per_iter, kernel_ms_per_iteration=busy)


def phase_packed_solve(dev, m, x_shared, card, paths):
    """Phase 7: the phase-2 problem on the packed layout, same stripes."""
    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_operator_device(m, m, OFFSETS, data)
    del data
    check(isinstance(A, lt.DIAOperator) and A.prefers_pair and A.prefers_fused,
          "the packed f32 operator on the card must prefer pair and fused modes")
    seg = lt.LSQROptions().loop_segment
    out = {}

    def solve(label, op=None, rhs=None, **kw):
        res, delta, secs = timed_solve(op or A, b if rhs is None else rhs,
                                       f"packed {label}", card, **kw)
        paths.append(delta)
        return res, delta, secs

    kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    solve("warm-up 64 iterations", **kw)
    res, delta, secs = solve("fixed 64 iterations", **kw)
    check(int(res.itn) == 64 and delta["dia_pair"] == 64 and delta["dia_matvec"] == 1,
          f"packed fixed run: expected 64 pair launches and one setup product: {delta}")
    out["ms_per_iteration_fixed64"] = secs * 1e3 / 64

    res_b, delta, secs = solve("(b) atol=btol=1e-6", atol=1e-6, btol=1e-6)
    itn_b, istop_b = int(res_b.itn), int(res_b.istop)
    check(istop_b in (1, 2, 3), f"packed (b) istop {istop_b}")
    check(delta["dia_pair"] == iterations_run(itn_b, seg),
          f"packed (b): pair launches {delta['dia_pair']} != itn + masked")
    ratio = packed_optimality(A, b, res_b.x)
    err = rel(res_b.x, x_shared)
    log(f"  packed (b) independent check {ratio:.3e}; x rel diff to the shared solve "
        f"{err:.3e}")
    check(ratio <= 1e-4, f"packed (b) independent optimality check {ratio:.3e} > 1e-4")
    check(err <= 1e-4, f"packed (b): x differs from the shared layout's by {err:.3e}")
    out["solve_b"] = dict(istop=istop_b, itn=itn_b, ms=secs * 1e3, optimality=ratio,
                          x_rel_to_shared=err)

    res_c, delta, secs = solve("(b) pair=False", atol=1e-6, btol=1e-6, pair=False)
    body = iterations_run(int(res_c.itn), seg)
    check(int(res_c.istop) == istop_b and abs(int(res_c.itn) - itn_b) <= 2,
          "packed pair=False: istop/itn differ")
    check(delta["dia_fused_halfstep"] == 2 * body and delta["dia_pair"] == 0,
          f"packed pair=False: expected {2 * body} fused half-steps: {delta}")
    check(rel(res_c.x, res_b.x) <= 1e-4, "packed pair=False: x differs")
    out["solve_pair_false"] = dict(istop=int(res_c.istop), itn=int(res_c.itn), ms=secs * 1e3)

    res_d, delta, secs = solve("(b) fused=False", atol=1e-6, btol=1e-6, fused=False)
    body = iterations_run(int(res_d.itn), seg)
    check(int(res_d.istop) == istop_b and abs(int(res_d.itn) - itn_b) <= 2,
          "packed fused=False: istop/itn differ")
    check(delta["dia_matvec"] == 2 * body + 1 and delta["dia_pair"] == 0,
          f"packed fused=False: expected two products per iteration run: {delta}")
    check(rel(res_d.x, res_b.x) <= 1e-4, "packed fused=False: x differs")
    out["solve_fused_false"] = dict(istop=int(res_d.istop), itn=int(res_d.itn),
                                    ms=secs * 1e3)

    log("  launch profile of the packed pair solve:")
    out["launch_profile"] = phase_launches(A, b)
    A = None

    # a band wider than the pair kernel's halo: two launches per pair
    mw, nw, ks = WIDE
    data, bw, _ = random_stripes(mw, nw, ks, dev, seed=107, boost=12.0)
    Aw = lt.dia_operator_device(mw, nw, ks, data)
    del data
    res_w, delta, secs = solve(f"wide band {ks} m=n={mw} (b)", op=Aw, rhs=bw,
                               atol=1e-6, btol=1e-6)
    body = iterations_run(int(res_w.itn), seg)
    check(int(res_w.istop) in (1, 2, 3), "wide band: bad stop")
    check(delta["dia_pair"] == 0 and delta["dia_matvec_axpy"] == body
          and delta["dia_matvec"] == body + 1,
          f"wide band: expected the two-launch pair route: {delta}")
    ratio = packed_optimality(Aw, bw, res_w.x)
    log(f"  wide band independent check {ratio:.3e}")
    check(ratio <= 1e-4, f"wide band: optimality check {ratio:.3e} > 1e-4")
    out["solve_wide"] = dict(istop=int(res_w.istop), itn=int(res_w.itn), ms=secs * 1e3,
                             optimality=ratio)
    return out


def phase_bf16(dev, m, x_f32, card, paths):
    """Phase 8: bf16 stripe storage on both layouts at m = n (2^23)."""
    import torch

    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    seg = lt.LSQROptions().loop_segment
    out = {}
    for label, build, pair, axpy, optimal in (
            ("packed", lt.dia_operator_device, "dia_pair[bf16]", "dia_matvec_axpy[bf16]",
             packed_optimality),
            ("shared", lt.dia_shared_operator, "dia_pair_shared[bf16]",
             "dia_product_shared_axpy[bf16]", shared_optimality)):
        A = build(m, m, OFFSETS, data, storage_dtype=torch.bfloat16)
        check(A.is_bf16_storage and A.prefers_pair and not A.prefers_fused,
              f"bf16 {label}: must prefer the pair and not the fused half-step")

        def solve(tag, **kw):
            res, delta, secs = timed_solve(A, b, f"bf16 {label} {tag}", card, **kw)
            paths.append(delta)
            return res, delta, secs

        kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
        solve("warm-up 64 iterations", **kw)
        res, delta, secs = solve("fixed 64 iterations", **kw)
        check(int(res.itn) == 64 and delta[pair] == 64, f"bf16 {label} fixed run: {delta}")
        ms_fixed = secs * 1e3 / 64

        res_b, delta, secs = solve("(b) atol=btol=1e-6", atol=1e-6, btol=1e-6)
        itn_b, istop_b = int(res_b.itn), int(res_b.istop)
        check(istop_b in (1, 2, 3), f"bf16 {label} (b) istop {istop_b}")
        check(delta[pair] == iterations_run(itn_b, seg) > 0,
              f"bf16 {label} (b): pair launches {delta[pair]} != itn + masked")
        ratio = optimal(A, b, res_b.x)  # against the bf16-rounded operator
        err = rel(res_b.x, x_f32)
        log(f"  bf16 {label} (b): independent check {ratio:.3e}; x rel diff to the f32 "
            f"solve {err:.3e}")
        check(ratio <= 1e-4, f"bf16 {label}: optimality check {ratio:.3e} > 1e-4")
        check(err <= 5e-2, f"bf16 {label}: x differs from the f32 x by {err:.3e}")

        # the half-step on bf16 stripes: not preferred, so forced
        res_c, delta, _ = solve("(b) fused=True, pair=False", atol=1e-6, btol=1e-6,
                                fused=True, pair=False)
        body = iterations_run(int(res_c.itn), seg)
        check(int(res_c.istop) == istop_b and abs(int(res_c.itn) - itn_b) <= 2,
              f"bf16 {label} half-steps: istop/itn differ")
        check(delta[axpy] == 2 * body and delta[pair] == 0,
              f"bf16 {label} half-steps: expected {2 * body} axpy launches: {delta}")
        log(f"  launch profile of the bf16 {label} pair solve:")
        out[label] = dict(ms_per_iteration_fixed64=ms_fixed, istop=istop_b, itn=itn_b,
                          ms=secs * 1e3, optimality=ratio, x_rel_to_f32=err,
                          itn_halfsteps=int(res_c.itn), launch_profile=phase_launches(A, b))
        del A
    return out

def mk_modules():
    """{solver: (its megakernel module, the counted call wrapper)}."""
    from lsqr_tpu_torch.ops import megakernel, megakernel_craig, megakernel_lsmr

    return {"lsqr": (megakernel, megakernel.lsqr_megakernel_call),
            "lsmr": (megakernel_lsmr, megakernel_lsmr.lsmr_megakernel_call),
            "craig": (megakernel_craig, megakernel_craig.craig_megakernel_call)}


def mk_pair(solver, A, b):
    """(kernel call, twin call, kernel vectors+state, twin vectors+state):
    one megakernel call of MK_K iterations from the solver's own setup, on
    two copies of it, so the kernel and its twin start equal."""
    mod, wrapper = mk_modules()[solver]
    kw = {} if solver == "craig" else dict(damp=DAMP)
    vectors, state = getattr(mod, f"{solver}_megakernel_prepare")(A, b, itnlim=10_000, **kw)
    mine = [t.clone() for t in (*vectors, state)]
    twin = [t.clone() for t in (*vectors, state)]
    args = dict(offsets=A.offsets, m=A.m, n=A.n, K=MK_K)
    plain = getattr(mod, f"{solver}_megakernel_plain")
    return (lambda: wrapper(A.data, A.tdata, *mine, offsets_t=A.offsets_t,
                            toffsets_t=A.toffsets_t, **args),
            lambda: plain(A.data, A.tdata, *twin, **args), mine, twin)


def phase_megakernels(dev, m, errs, card):
    """Phase 9: each megakernel against its twin on the card, one call of
    MK_K iterations from the same setup; returns {variant: (kernel ms per
    call, twin ms per call)} at the main shape."""
    import torch

    import lsqr_tpu_torch as lt

    times = {}
    shapes = [(m, m, OFFSETS, (torch.float32, torch.bfloat16)),
              (MK_SIDE, MK_SIDE, (0, 1, 2, 3), (torch.float32,)),  # one-sided
              (MK_SIDE + 3, 3 * MK_SIDE // 4 + 5, OFFSETS, (torch.float32,))]  # ragged
    for si, (mm, nn, ks, storages) in enumerate(shapes):
        data, b, g = random_stripes(mm, nn, ks, dev, seed=100 if si == 0 else 200 + si,
                                    boost=12.0)
        xt = torch.randn(nn, generator=g, device=dev)
        for storage in storages:
            A = lt.dia_operator_device(mm, nn, ks, data, storage_dtype=storage)
            sfx = "" if storage == torch.float32 else "[bf16]"
            for solver in ("lsqr", "lsmr", "craig"):
                rhs = A.matvec(xt) if solver == "craig" else b  # CRAIG: consistent
                kernel, plain, mine, twin = mk_pair(solver, A, rhs)
                state0 = mine[-1].clone()
                kernel()
                plain()
                torch.cuda.synchronize()
                name = f"{solver}_megakernel{sfx}"
                got, ref = mine[-1].double(), twin[-1].double()
                scale = ref.abs().clamp_min(1e-6)
                worst = float(((got - ref).abs() / scale).max())
                errs[name] = max(errs.get(name, 0.0), absdiff(got, ref))
                for a, r in zip(mine[:-1], twin[:-1]):
                    worst = max(worst, rel(a, r))
                    errs[name] = max(errs[name], absdiff(a, r))
                _, wrapper = mk_modules()[solver]
                log(f"  {name:24s} m={mm} n={nn} ks={ks[0]}..{ks[-1]} K={MK_K}: "
                    f"itn {int(mine[-1][{'lsqr': 15, 'lsmr': 23, 'craig': 7}[solver]])}, "
                    f"max rel err (state and vectors) {worst:.3e}; grid {wrapper.blocks} "
                    f"blocks x 256, {BARRIERS[solver]} grid barriers per iteration")
                check(worst <= MK_TOL, f"{name} disagrees with its twin: {worst:.3e}")
                if si == 0:
                    # time calls from the same state (restored before each), so
                    # every call runs MK_K live iterations
                    def again(fn, st, s0=state0):
                        st.copy_(s0)
                        fn()
                    ms = time_ms(lambda: again(kernel, mine[-1]), reps=10)
                    plain_ms = time_ms(lambda: again(plain, twin[-1]), reps=2)
                    times[name] = (ms, plain_ms)
                    log(f"    {name}: kernel {ms:.4f} ms per call ({ms / MK_K:.4f} ms per "
                        f"iteration), twin {plain_ms:.4f} ms per call  [{card}]")
                del kernel, plain, mine, twin
            del A
        del data, b, xt
        torch.cuda.empty_cache()
    return times


def mk_solve(label, fn, A, b, card, paths, **kw):
    """One counted solve through ``fn`` (lsqr, lsmr, craig or cgls):
    (result, launches by variant, wall seconds)."""
    import torch

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(A, b, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (res, secs), delta = counted(run)
    paths.append(delta)
    check(bool(torch.isfinite(res.x).all()) and res.x.shape == (A.n,), f"{label}: bad x")
    launched = {k: v for k, v in delta.items() if v}
    log(f"  {label}: istop={int(res.istop)} itn={int(res.itn)} wall={secs * 1e3:.3f} ms "
        f"({secs * 1e3 / max(int(res.itn), 1):.4f} ms/iteration incl. setup, {card}) "
        f"launches={launched}")
    return res, delta, secs


def phase_mk_solves(dev, m, card, paths):
    """Phase 10: megakernel solves against the regular path on the card,
    the fixed-length timing with and without the megakernel, and CGLS."""
    import torch

    import lsqr_tpu_torch as lt

    out = {}
    data, b, g = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    xt = torch.randn(m, generator=g, device=dev)
    for storage in (torch.float32, torch.bfloat16):
        A = lt.dia_operator_device(m, m, OFFSETS, data, storage_dtype=storage)
        sfx = "" if storage == torch.float32 else "[bf16]"
        bc = A.matvec(xt)
        for solver, fn, rhs, kw in (
                ("lsqr", lt.lsqr, b, dict(damp=DAMP)),
                ("lsmr", lt.lsmr, b, dict(damp=DAMP)),
                ("craig", lt.craig, bc, {})):
            kw.update(atol=1e-6, btol=1e-6)
            ref, delta, _ = mk_solve(f"{solver}{sfx} regular", fn, A, rhs, card, paths, **kw)
            pair = "dia_pair" + sfx
            check(delta[pair] > 0, f"{solver}{sfx} regular: no {pair} launches {delta}")
            res, delta, secs = mk_solve(f"{solver}{sfx} megakernel=True", fn, A, rhs, card,
                                        paths, megakernel=True, **kw)
            name = f"{solver}_megakernel{sfx}"
            check(delta[name] > 0 and delta[pair] == 0,
                  f"{solver}{sfx}: megakernel=True must launch {name} only: {delta}")
            err = rel(res.x, ref.x)
            log(f"    x rel diff to the regular path {err:.3e}; {delta[name]} launches")
            check(int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 1,
                  f"{solver}{sfx} megakernel: istop/itn differ from the regular path")
            check(err <= 1e-3, f"{solver}{sfx} megakernel: x differs by {err:.3e}")
            entry = dict(istop=int(res.istop), itn=int(res.itn), itn_regular=int(ref.itn),
                         ms=secs * 1e3, x_rel_to_regular=err)
            if solver == "lsqr":
                ratio = packed_optimality(A, b, res.x)
                log(f"    independent check (f64, twins) {ratio:.3e}")
                check(ratio <= 1e-4, f"lsqr{sfx} megakernel: optimality {ratio:.3e}")
                entry["optimality"] = ratio
            out[f"{solver}{sfx}"] = entry
        del A
    torch.cuda.empty_cache()

    # CGLS on the f32 packed operator, regular and pair=True
    A = lt.dia_operator_device(m, m, OFFSETS, data)
    for label, kw, kernel in (("cgls regular", {}, "dia_matvec"),
                              ("cgls pair=True", dict(pair=True), "dia_pair")):
        res, delta, secs = mk_solve(label, lt.cgls, A, b, card, paths, damp=DAMP,
                                    atol=1e-6, btol=1e-6, **kw)
        ratio = packed_optimality(A, b, res.x)
        log(f"    independent check {ratio:.3e}")
        check(int(res.istop) in (1, 2) and delta[kernel] > 0, f"{label}: {delta}")
        check(ratio <= 1e-4, f"{label}: optimality {ratio:.3e} > 1e-4")
        out[label.replace(" ", "_")] = dict(istop=int(res.istop), itn=int(res.itn),
                                            ms=secs * 1e3, optimality=ratio)
    del A, data, b, xt
    torch.cuda.empty_cache()

    # fixed 64 iterations with and without the megakernel, at 2^23 and 2^19
    for mm in (m, M_SMALL):
        data, b, _ = random_stripes(mm, mm, OFFSETS, dev, seed=100, boost=12.0)
        A = lt.dia_operator_device(mm, mm, OFFSETS, data)
        del data
        row = {}
        for label, extra in (("regular", {}), ("megakernel", dict(megakernel=True))):
            kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65, **extra)
            mk_solve(f"m=n={mm} {label} warm-up 64 iterations", lt.lsqr, A, b, card, paths,
                     damp=DAMP, **kw)
            res, delta, secs = mk_solve(f"m=n={mm} {label} fixed 64 iterations", lt.lsqr, A,
                                        b, card, paths, damp=DAMP, **kw)
            check(int(res.itn) == 64, f"fixed run {label}: itn {int(res.itn)} != 64")
            log(f"  launch profile, m=n={mm} {label}:")
            row[label] = dict(ms_per_iteration=secs * 1e3 / 64,
                              launch_profile=phase_launches(A, b, **extra))
        out[f"fixed64_m{mm}"] = row
        del A, b
        torch.cuda.empty_cache()
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from lsqr_tpu_torch.ops import _cuda, spmv

    dev = torch.device("cuda")
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    card = smi.splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(sh(_cuda._nvcc(), "--version").splitlines()[-1])
    t_start = t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"kernel library {lib.path.name}: ready in {time.perf_counter() - t0:.2f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line.lower():
            log("  ptxas:", line.strip())

    log("phase 1: kernels vs twins")
    errs = {}
    times = phase_kernels(dev, [(M_MAIN, M_MAIN, OFFSETS),
                                (300_001, 200_003, (-60, -3, 0, 5)),
                                (200_000, 300_007, (0, 1, 7)), WIDE], errs)
    for name, (ms, plain_ms, m, n, nd, esize) in times.items():
        vm, vn = VECTORS[base(name)]
        moved = nd * m * esize + (vm * m + vn * n) * (8 if esize == 8 else 4)
        log(f"  {name:30s} m={m} n={n}: kernel {ms:.4f} ms ({moved / (ms * 1e6):.1f} GB/s "
            f"of the {moved / 1e6:.0f} MB it must move), twin {plain_ms:.4f} ms  [{card}]")

    paths = []  # launches by variant of every path run below
    log("phases 2-3: main-path solves, shared layout")
    A, b, x_shared, solves = phase_main_solve(dev, M_MAIN, card, paths)
    log("phase 4: auto_operator")
    phase_auto_operator(dev, 2 ** 20, paths)
    log("phase 5: f64 conformance")
    phase_f64(dev, 2 ** 16, paths)
    log("phase 6: launches per iteration")
    solves["launch_profile"] = phase_launches(A, b)
    del A, b
    torch.cuda.empty_cache()
    log("phase 7: the packed layout")
    solves["packed"] = phase_packed_solve(dev, M_MAIN, x_shared, card, paths)
    torch.cuda.empty_cache()
    log("phase 8: bf16 stripe storage")
    solves["bf16"] = phase_bf16(dev, M_MAIN, x_shared, card, paths)
    torch.cuda.empty_cache()
    log("phase 9: megakernels vs twins")
    mk_times = phase_megakernels(dev, M_MAIN, errs, card)
    log("phase 10: solves through the megakernels")
    solves["megakernel"] = phase_mk_solves(dev, M_MAIN, card, paths)
    times.update({name: (ms, plain_ms) for name, (ms, plain_ms) in mk_times.items()})

    launches = {k: sum(p[k] for p in paths) for k in spmv.launch_counts(by_variant=True)}
    log(f"  launches on the paths of phases 2-5, 7, 8 and 10: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on a path")
    log(json.dumps({"solves": solves, "card": card,
                    "seconds": time.perf_counter() - t_start}))

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[base(name)][0],
         "replaces": KERNELS[base(name)][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name in launches]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
