#!/usr/bin/env python3
"""Drive lsqr_tpu_torch's banded main path once on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA device (it exits non-zero, printing no result, without one),
nvcc under $CUDA_HOME or /usr/local/cuda, and scipy. It builds the kernels
from lsqr_tpu_torch/csrc into build/lsqr_tpu_torch/, then runs six phases;
each raises on failure:

1. each hand-written kernel against its plain PyTorch twin on the card, at
   the main path's shape (m = n = 2^23, 11 diagonals), a ragged rectangular
   one and a wide one; the kernels' and the twins' times at the main shape;
2. the main-path solve at m = n = 2^23: f32 stripes from a seeded
   generator with 12 added to the main diagonal, damp 0.01 — a run to the
   machine-precision guards within 64 iterations, a fixed 64-iteration run
   for the time per iteration, and a run to atol = btol = 1e-6 whose answer
   is checked independently with the twins in f64;
3. the same solve with pair=False (the product+axpy kernel);
4. ``auto_operator`` on the COO triplets of a 2^20 banded f32 matrix and a
   short solve, against the same solve on the host;
5. f64 conformance at 2^16 against ``scipy.sparse.linalg.lsqr``, and the
   README 3x3 system through ``LSQRSolver(device="cuda")``;
6. the CUDA kernel launches one iteration of the f32 pair solve makes.

Every kernel's launch count is reset just before phases 2-3 (the main path)
and read just after; each kernel must have run there. The second-to-last
line of output is a JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

M_MAIN = 2 ** 23
OFFSETS = tuple(range(-5, 6))
DAMP = 0.01
TOL = 1e-5  # f32 kernel vs twin, relative to the max: summation order only
SOURCE = "lsqr_tpu_torch/csrc/dia_shared.cu"
REPLACES = {
    "dia_pair_shared": "lsqr_tpu/ops/pallas_spmv.py:1969",
    "dia_product_shared": "lsqr_tpu/ops/pallas_spmv.py:1653",
    "dia_product_shared_axpy": "lsqr_tpu/ops/pallas_spmv.py:2081",
}


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


def random_stripes(m, n, offsets, device, seed, boost=0.0):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randn((len(offsets), m), generator=g, device=device)
    data[offsets.index(0)] += boost
    return data, torch.randn(m, generator=g, device=device), g


# ---------------------------------------------------------------------------


def phase_kernels(dev, shapes, errs):
    """Phase 1: every kernel against its twin on the card; returns the
    kernels' and twins' times at the first (main-path) shape."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    times = {}
    for si, (m, n, ks) in enumerate(shapes):
        data, y, g = random_stripes(m, n, ks, dev, seed=si)
        A = lt.dia_shared_operator(m, n, ks, data)
        v = torch.randn(n, generator=g, device=dev)
        c1 = torch.tensor(0.8, device=dev)
        c2 = torch.tensor(1.1, device=dev)
        kw = dict(offsets=ks, m=m, n=n)
        calls = {
            "dia_product_shared": [
                (lambda adj=adj: spmv.dia_product_shared(A.dp, y if adj else v, adjoint=adj,
                                                         offsets_t=A.offsets_t, **kw),
                 lambda adj=adj: spmv.dia_product_shared_plain(A.dp, y if adj else v,
                                                               adjoint=adj, **kw))
                for adj in (False, True)],
            "dia_product_shared_axpy": [
                (lambda adj=adj: spmv.dia_product_shared_axpy(
                    A.dp, y if adj else v, v if adj else y, c1, c2, adjoint=adj,
                    offsets_t=A.offsets_t, **kw),
                 lambda adj=adj: spmv.dia_product_shared_axpy_plain(
                    A.dp, y if adj else v, v if adj else y, c1, c2, adjoint=adj, **kw))
                for adj in (False, True)],
            "dia_pair_shared": [
                (lambda: spmv.dia_pair_shared(A.dp, v, y, c1, c2, offsets_t=A.offsets_t, **kw),
                 lambda: spmv.dia_pair_shared_plain(A.dp, v, y, c1, c2, **kw))],
        }
        for name, pairs in calls.items():
            for kernel, plain in pairs:
                got, ref = kernel(), plain()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    r = rel(a, b)
                    errs[name] = max(errs.get(name, 0.0), absdiff(a, b))
                    log(f"  {name:24s} m={m} n={n} nd={len(ks)}: max rel err {r:.3e}")
                    check(r <= TOL, f"{name} disagrees with its twin: {r:.3e} > {TOL}")
            if si == 0:
                kernel, plain = pairs[0]
                times[name] = (time_ms(kernel), time_ms(plain))
        if si == 1:  # the f64 product kernel (f64 solves on the card use it)
            # full-width f64 values: products of f32 values would be exact
            A64 = lt.dia_shared_operator(m, n, ks, torch.randn(
                data.shape, generator=g, device=dev, dtype=torch.float64))
            x64 = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
            r = rel(spmv.dia_product_shared(A64.dp, x64, adjoint=False, **kw),
                    spmv.dia_product_shared_plain(A64.dp, x64, adjoint=False, **kw))
            log(f"  dia_product_shared f64     m={m} n={n}: max rel err {r:.3e}")
            check(r <= 1e-12, f"f64 dia_product_shared disagrees with its twin: {r:.3e}")
        del A, data, y, v
    return times


def phase_main_solve(dev, m, card):
    """Phase 2-3: the main-path solves at m = n (2^23 on the card)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_shared_operator(m, m, OFFSETS, data)
    del data
    check(A.prefers_pair, "the f32 operator on the card must take pair mode")
    seg = lt.LSQROptions().loop_segment
    out = {}

    def solve(label, **kw):
        before = spmv.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.lsqr(A, b, DAMP, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in spmv.launch_counts().items()}
        itn, istop = int(res.itn), int(res.istop)
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (m,), f"{label}: bad x")
        log(f"  {label}: istop={istop} itn={itn} rnorm={float(res.rnorm):.6e} "
            f"arnorm={float(res.arnorm):.6e} wall={secs * 1e3:.3f} ms "
            f"({secs * 1e3 / max(itn, 1):.4f} ms/iteration incl. setup, {card}) "
            f"launches={delta}")
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
    body = -(-itn_b // seg) * seg  # iterations run: itn plus the masked rest
    check(delta["dia_pair_shared"] == body,
          f"(b) pair launches {delta['dia_pair_shared']} != itn + masked = {body}")
    out["solve_b"] = dict(istop=int(res_b.istop), itn=itn_b, ms=secs * 1e3)

    # independent check of (b), in f64 with the twins: the damped normal
    # equations' residual ||A'r - damp^2 x|| / (||A||_F ||(r; damp x)||)
    # (xcheck's test3, lsqr.f90:1089-1094)
    from lsqr_tpu_torch.ops.spmv import dia_product_shared_plain

    dp64 = A.dp.double()
    kwp = dict(offsets=OFFSETS, m=m, n=m)
    x64 = res_b.x.double()
    r = b.double() - dia_product_shared_plain(dp64, x64, adjoint=False, **kwp)
    grad = dia_product_shared_plain(dp64, r, adjoint=True, **kwp) - DAMP ** 2 * x64
    rho = torch.sqrt(r.norm() ** 2 + (DAMP * x64.norm()) ** 2)
    ratio = float(grad.norm() / (dp64.norm() * rho))
    log(f"  (b) independent check ||A'r - damp^2 x|| / (||A||_F ||(r; damp x)||)"
        f" = {ratio:.3e}")
    check(ratio <= 1e-4, f"(b) independent optimality check {ratio:.3e} > 1e-4")
    del dp64, r, grad
    out["optimality_b"] = ratio

    # phase 3: pair=False goes through the product+axpy kernel
    res_c, delta, secs = solve("(b) pair=False", atol=1e-6, btol=1e-6, pair=False)
    check(int(res_c.istop) == int(res_b.istop), "pair=False: istop differs")
    check(abs(int(res_c.itn) - itn_b) <= 2, "pair=False: itn differs by more than 2")
    body = -(-int(res_c.itn) // seg) * seg
    check(delta["dia_product_shared_axpy"] == 2 * body and delta["dia_pair_shared"] == 0,
          f"pair=False: expected {2 * body} axpy launches: {delta}")
    check(rel(res_c.x, res_b.x) <= 1e-4, "pair=False: x differs")
    out["solve_pair_false"] = dict(istop=int(res_c.istop), itn=int(res_c.itn), ms=secs * 1e3)
    return A, b, out


def phase_auto_operator(dev, m):
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
    res = lt.lsqr(A, b, DAMP, atol=1e-6, btol=1e-6)
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


def phase_f64(dev, m):
    """Phase 5: f64 on the card against scipy, and the README 3x3."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    rng = np.random.default_rng(5)
    data = rng.standard_normal((len(OFFSETS), m))
    data[OFFSETS.index(0)] += 12.0
    b = rng.standard_normal(m)
    A = lt.dia_shared_operator(m, m, OFFSETS, data, device=dev)
    i = np.arange(m)
    ok = [(i + k >= 0) & (i + k < m) for k in OFFSETS]
    S = scipy.sparse.coo_matrix(
        (np.concatenate([data[d][ok[d]] for d in range(len(OFFSETS))]),
         (np.concatenate([i[ok[d]] for d in range(len(OFFSETS))]),
          np.concatenate([i[ok[d]] + k for d, k in enumerate(OFFSETS)]))),
        shape=(m, m)).tocsr()
    tol = dict(atol=1e-10, btol=1e-10, conlim=1e8)
    before = spmv.launch_counts()
    res = lt.lsqr(A, b, DAMP, itnlim=2 * m, **tol)
    launched = {k: v - before[k] for k, v in spmv.launch_counts().items()}
    ref = scipy.sparse.linalg.lsqr(S, b, damp=DAMP, iter_lim=2 * m, **tol)
    istop_ref, itn_ref = scipy_istop(ref[1], DAMP > 0), ref[2]
    err = float(np.abs(res.x.cpu().numpy() - ref[0]).max() / np.abs(ref[0]).max())
    log(f"  f64 m=n={m}: port istop={int(res.istop)} itn={int(res.itn)}; scipy istop="
        f"{ref[1]} (= {istop_ref}) itn={itn_ref}; x rel diff {err:.3e}; launches {launched}")
    check(res.x.dtype == torch.float64 and res.x.device.type == dev.type,
          "the f64 solve left the card or f64")
    check(int(res.istop) == istop_ref and abs(int(res.itn) - itn_ref) <= 1,
          "f64: istop/itn differ from scipy")
    check(err <= 1e-8, f"f64: x differs from scipy by {err:.3e}")
    check(launched["dia_product_shared"] > 0 and launched["dia_pair_shared"] == 0,
          "f64 solves run unfused through the f64 product kernel")

    solver = lt.LSQRSolver(3, 3, [1.0, 4.0, 7.0, 2.0, 5.0, 88.0, 3.0, 66.0, 9.0],
                           [0, 1, 2, 0, 1, 2, 0, 1, 2], [0, 0, 0, 1, 1, 1, 2, 2, 2],
                           device=dev)
    r3 = solver.solve([1.0, 2.0, 3.0])
    x3 = r3.x.cpu().numpy()
    log(f"  README 3x3 on {r3.x.device}: istop={int(r3.istop)} x={x3.tolist()}")
    check(int(r3.istop) == 1 and np.allclose(x3, [1.242424, -0.06060606, -0.04040404],
                                               rtol=1e-5), "README 3x3")


def phase_launches(A, b):
    """Phase 6: CUDA launches per iteration of the f32 pair solve, from the
    profiler: (launches of a 128-iteration run - a 64-iteration run) / 64."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lsqr_tpu_torch as lt

    counts = {}
    for itnlim in (64, 128):
        kw = dict(itnlim=itnlim, atol=0.0, btol=0.0, conlim=0.0, nconv=itnlim + 1)
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
    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"kernel library {lib.path.name}: ready in {time.perf_counter() - t0:.2f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line.lower():
            log("  ptxas:", line.strip())

    log("phase 1: kernels vs twins")
    errs = {}
    times = phase_kernels(dev, [(M_MAIN, M_MAIN, OFFSETS),
                                (300_001, 200_003, (-60, -3, 0, 5)),
                                (200_000, 300_007, (0, 1, 7))], errs)
    nd, m = len(OFFSETS), M_MAIN
    vectors = {"dia_product_shared": 2, "dia_product_shared_axpy": 3, "dia_pair_shared": 4}
    for name, (ms, plain_ms) in times.items():
        gbs = (nd * m + vectors[name] * m) * 4 / (ms * 1e6)
        log(f"  {name:24s} at m=n=2^23, 11 diagonals: kernel {ms:.4f} ms "
            f"({gbs:.1f} GB/s of the {(nd + vectors[name]) * m * 4 / 1e6:.0f} MB it must "
            f"move), twin {plain_ms:.4f} ms  [{card}]")

    log("phases 2-3: main-path solves (launch counts reset)")
    spmv.reset_launch_counts()
    A, b, solves = phase_main_solve(dev, M_MAIN, card)
    launches = spmv.launch_counts()
    log(f"  launches in the main path: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")

    log("phase 4: auto_operator")
    phase_auto_operator(dev, 2 ** 20)
    log("phase 5: f64 conformance")
    phase_f64(dev, 2 ** 16)
    log("phase 6: launches per iteration")
    per_iter = phase_launches(A, b)
    log(json.dumps({"solves": solves, "launch_profile": per_iter, "card": card}))

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("dia_pair_shared", "dia_product_shared", "dia_product_shared_axpy")]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
