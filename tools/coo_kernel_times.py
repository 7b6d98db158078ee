#!/usr/bin/env python3
"""Device times of the WCOO/WWCOO and DIA pair kernels of one or more
checkouts.

    python3 tools/coo_kernel_times.py [ROOT ...] [--no-coo | --only-coo] [--out FILE]

Each ROOT (default: this checkout) is a checkout of the repository whose
``lsqr_tpu_torch`` is imported and whose kernels are built, in a process of
its own, in the order given; to compare a commit with its parent on one
card, unpack the parent into a git-ignored directory of this checkout
(``git archive <rev> | tar -x -C build/parent``) and pass it before and
after this one: ``build/parent . . build/parent``.

At ``bench.py``'s Zipf shapes (m = 2^21, 10,485,760 entries, seed 0; WCOO
at n = 2048, RWCOO at n = 65,536 through ``auto_operator``) each process
times, through the public wrappers of ``lsqr_tpu_torch.ops.spmv_wcoo``:
the WCOO forward, adjoint and pair; RWCOO's hot forward and adjoint and
its cold forward, adjoint and pair; each forward again on its packing with
every row emptied (gpe = -1: the per-row work alone, gpe, y and u); and
``torch.sparse_csr_tensor`` products of the same matrices (A, A', the cold
stream's A and A'). On RWCOO also: the cold stream's pair (u, z) saved
with the dumps below; the operator's ``fused_pair`` (hot forward, cold
pair, hot adjoint); and ``chip_smoke.py`` phase 15's RWCOO solves (b from
seed 15, damp ``DAMP``): the fixed 64-iteration one's wall ms an iteration
(host clock, setup included) and kernel ms an iteration from the profiler
((128-iteration run - 64-iteration run) / 64), and the solve to atol =
btol = 1e-6 (istop, itn, wall ms; x saved). ``--no-coo`` skips all of
these. Then (unless ``--only-coo``) ``spmv.dia_pair``
and ``spmv.dia_pair_shared`` on ``bench.py``'s banded shape (m = n = 2^23,
11 diagonals, ``chip_smoke.random_stripes``) and at 2^19, f32 and bf16
stripes, beside the two-call CSR time of the same matrix (``A @ x``, then
the CSR of A' ``@ u``); and the shared layout's f32 pair solve of
``chip_smoke.py`` phase 2 (b) (2^23, damped, to atol = btol = 1e-6): its
istop and itn. The pairs' u and z at 2^23 and the solve's x go to
``build/coo_kernel_times/<run>.pt``, and this process prints the largest
|difference| of each run's from the first run's (the same inputs on the
same card). Last (unless ``--only-coo``), ``stream_copy`` and ``x.mul_``
on ``bench.py``'s roofline shape (1024 x 2^18 f32), timed in turns five
times each. Every checkout is
timed by this checkout's ``chip_smoke.time_ms`` (the mean device time of
``--reps`` calls, the card spinning while the host queues them) and its
CSR built by ``chip_smoke.csr_of``. Prints one JSON line per checkout (the
card's name and power limit with it) and, with ``--out FILE``, writes them
all there. Needs one CUDA device.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
M, N, N_WIDE, NNZ = 2 ** 21, 2048, 65536, 10 * 2 ** 20


def yardstick():
    """This checkout's ``chip_smoke.py`` (loaded by path, so that a checkout
    under test cannot replace it): its ``time_ms`` and ``csr_of`` time and
    build every checkout's products alike."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pair_times(smoke, dev, reps, saved):
    """dia_pair's and dia_pair_shared's times at 2^23 and 2^19 x 11
    diagonals, f32 and bf16 stripes, and the two-call CSR time of each
    shape; the 2^23 results, and the shared pair solve's, put in
    ``saved``."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    out = {}
    ks = smoke.OFFSETS
    for m in (2 ** 23, 2 ** 19):
        data, y, g = smoke.random_stripes(m, m, ks, dev, seed=100, boost=12.0)
        v = torch.randn(m, generator=g, device=dev)
        c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
        rows, cols, vals = smoke.stripe_triplets(data, ks, m, m)
        a, at = smoke.csr_of(rows, cols, vals, m, m), smoke.csr_of(cols, rows, vals, m, m)
        out[f"csr_two_calls_{m}"] = smoke.time_ms(lambda: (a @ v, at @ y), reps)
        del a, at, rows, cols, vals
        for tag, storage in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            packed = lt.dia_operator_device(m, m, ks, data, storage_dtype=storage)
            shared = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
            calls = {
                "dia_pair": lambda p=packed: spmv.dia_pair(
                    p.data, y, v, c1, c2, offsets=ks, m=m, n=m, offsets_t=p.offsets_t),
                "dia_pair_shared": lambda s=shared: spmv.dia_pair_shared(
                    s.dp, v, y, c1, c2, offsets=ks, m=m, n=m, offsets_t=s.offsets_t)}
            for name, call in calls.items():
                out[f"{name}_{tag}_{m}"] = smoke.time_ms(call, reps)
                if m == 2 ** 23:
                    saved[f"{name}_{tag}"] = [t.cpu() for t in call()]
            del packed, shared
        del data, y, v
        torch.cuda.empty_cache()
    m = 2 ** 23
    data, b, _ = smoke.random_stripes(m, m, ks, dev, seed=100, boost=12.0)
    res = lt.lsqr(lt.dia_shared_operator(m, m, ks, data), b, smoke.DAMP, atol=1e-6,
                  btol=1e-6)
    out["shared_solve"] = dict(istop=int(res.istop), itn=int(res.itn))
    saved["shared_solve_x"] = [res.x.cpu()]
    del data, b, res
    torch.cuda.empty_cache()
    return out


def rwcoo_solves(smoke, A, dev, saved):
    """Phase 15's RWCOO solves on ``A``: the fixed 64-iteration one (wall
    and kernel ms an iteration) and the one to 1e-6 (istop, itn, wall; x
    put in ``saved``)."""
    import time

    import torch

    import lsqr_tpu_torch as lt

    b = torch.randn(A.m, generator=torch.Generator(device=dev).manual_seed(15), device=dev)
    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    out = {}
    for key, kw in (("rwcoo_fixed64", fixed), ("rwcoo_solve", dict(atol=1e-6, btol=1e-6))):
        lt.lsqr(A, b, smoke.DAMP, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.lsqr(A, b, smoke.DAMP, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[key] = dict(istop=int(res.istop), itn=int(res.itn), wall_ms=ms,
                        wall_ms_per_iteration=ms / max(1, int(res.itn)))
    saved["rwcoo_solve_x"] = [res.x.cpu()]
    busy = [smoke.profile_run(A, b, itn)[2] for itn in (64, 128)]
    out["rwcoo_fixed64"]["kernel_ms_per_iteration"] = (busy[1] - busy[0]) / 64
    return out


def stream_turns(smoke, dev, reps):
    """stream_copy and x.mul_ at bench.py's roofline shape, in turns, five
    times each."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import roofline

    x = torch.randn((roofline.ROWS, roofline.COLS), device=dev)
    copy, mul = [], []
    for _ in range(5):
        copy.append(smoke.time_ms(lambda: lt.stream_copy(x), reps))
        mul.append(smoke.time_ms(lambda: x.mul_(roofline.SCALE), reps))
    return {"stream_copy_turns": copy, "mul_turns": mul}


def one(root, reps, dump, coo=True, dia=True):
    """Times of the kernels of the checkout at ``root`` (this process); the
    WCOO/WWCOO ones only with ``coo``, the DIA pairs and stream_copy only
    with ``dia``; the results compared across runs saved to ``dump``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo
    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    assert Path(lt.__file__).resolve().is_relative_to(Path(root).resolve()), lt.__file__
    smoke = yardstick()
    csr = smoke.csr_of
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(0.3, device=dev)
    out, saved = {}, {}

    def t(fn):
        return smoke.time_ms(fn, reps)

    for label, n in (("wcoo", N), ("rwcoo", N_WIDE)) if coo else ():
        trip = zipf_column_coo(M, n, NNZ, seed=0)
        A = lt.auto_operator(M, n, *trip, device=dev)
        y = torch.randn(M, generator=g, device=dev)
        tri = [torch.from_numpy(a).to(dev) for a in (trip[1], trip[2], trip[0])]
        x = torch.randn(n, generator=g, device=dev)
        a, at = csr(*tri, M, n), csr(tri[1], tri[0], tri[2], n, M)
        out[f"{label}_csr"], out[f"{label}_csr_t"] = t(lambda: a @ x), t(lambda: at @ y)
        del a, at
        if label == "wcoo":
            packs = [("wcoo", A.packed, "wcoo")]
        else:
            packs = [("hot", A.hot, "wcoo"), ("cold", A.cold, "wwcoo")]
            cold = ~np.isin(trip[2], A.hotmap.cpu().numpy())
            ct = [tr[torch.from_numpy(cold).to(dev)] for tr in tri]
            a, at = csr(*ct, M, n), csr(ct[1], ct[0], ct[2], n, M)
            out["cold_csr"], out["cold_csr_t"] = t(lambda: a @ x), t(lambda: at @ y)
            del a, at, ct
        for key, p, kind in packs:
            fwd, adj, pair = (getattr(sw, f"{kind}_{s}") for s in ("forward", "adjoint", "pair"))
            xp = torch.randn(p.n, generator=g, device=dev)
            empty = dataclasses.replace(p, gpe=torch.full_like(p.gpe, -1))
            out[f"{key}_forward"] = t(lambda: fwd(p, xp, c1, c2, y))
            out[f"{key}_forward_rows_only"] = t(lambda: fwd(empty, xp, c1, c2, y))
            out[f"{key}_adjoint"] = t(lambda: adj(p, y))
            if key != "hot":
                out[f"{key}_pair"] = t(lambda: pair(p, y, xp, c1, c2))
            if key == "cold":
                saved["cold_pair"] = [r.cpu() for r in pair(p, y, xp, c1, c2)]
        if label == "rwcoo":
            out["rwcoo_fused_pair"] = t(lambda: A.fused_pair(y=y, win=x, c1=c1, c2=c2))
            out.update(rwcoo_solves(smoke, A, dev, saved))
        del A, tri
        torch.cuda.empty_cache()
    if dia:
        out.update(pair_times(smoke, dev, reps, saved))
        out.update(stream_turns(smoke, dev, reps))
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(HERE)])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-coo", action="store_true",
                    help="skip the WCOO/WWCOO kernels and their CSR products")
    ap.add_argument("--only-coo", action="store_true",
                    help="skip the DIA pairs, their solve and stream_copy")
    ap.add_argument("--out", help="write the runs to this JSON file too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.reps, args.dump, not args.no_coo,
                             not args.only_coo)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("coo_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = []
    dumps = HERE / "build" / "coo_kernel_times"
    for i, root in enumerate(args.roots):
        root = str(Path(root).resolve())
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--reps",
                               str(args.reps), "--dump", str(dumps / f"{i}.pt"),
                               *(["--no-coo"] if args.no_coo else []),
                               *(["--only-coo"] if args.only_coo else [])],
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append({"root": root, "card": card, **json.loads(proc.stdout.splitlines()[-1])})
        if i:  # the pairs' u and z, the solve's x, against the first run's
            first, this = (torch.load(dumps / f"{k}.pt") for k in (0, i))
            runs[-1]["max_abs_diff_to_first"] = {
                tag: [float((a.double() - b.double()).abs().max())
                      for a, b in zip(this[tag], first[tag])] for tag in this}
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
