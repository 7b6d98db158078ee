#!/usr/bin/env python3
"""Device times of the WCOO/WWCOO and packed-pair kernels of one or more
checkouts.

    python3 tools/coo_kernel_times.py [ROOT ...] [--out FILE]

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
stream's A and A'). Then ``spmv.dia_pair`` on ``bench.py``'s banded
shape (m = n = 2^23, 11 diagonals, ``chip_smoke.random_stripes``) and at
2^19, f32 and bf16 stripes; its u and z at 2^23 go to
``build/coo_kernel_times/<run>.pt``, and this process prints the largest
|difference| of each run's from the first run's (the same inputs on the
same card). Last, ``stream_copy`` and ``x.mul_`` on ``bench.py``'s roofline
shape (1024 x 2^18 f32), timed in turns five times each. Every checkout is
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


def pair_times(smoke, dev, reps, dump):
    """dia_pair's times at 2^23 and 2^19 x 11 diagonals, f32 and bf16
    stripes; the 2^23 results saved to ``dump``."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    out, saved = {}, {}
    for m in (2 ** 23, 2 ** 19):
        data, y, g = smoke.random_stripes(m, m, smoke.OFFSETS, dev, seed=100, boost=12.0)
        v = torch.randn(m, generator=g, device=dev)
        c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
        offsets_t = torch.tensor(smoke.OFFSETS, dtype=torch.int32, device=dev)
        for tag, d in (("f32", data), ("bf16", data.bfloat16())):
            def call(d=d):
                return spmv.dia_pair(d, y, v, c1, c2, offsets=smoke.OFFSETS, m=m, n=m,
                                     offsets_t=offsets_t)
            out[f"dia_pair_{tag}_{m}"] = smoke.time_ms(call, reps)
            if m == 2 ** 23:
                saved[tag] = [t.cpu() for t in call()]
        del data, y, v
        torch.cuda.empty_cache()
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
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


def one(root, reps, dump):
    """Times of the kernels of the checkout at ``root`` (this process)."""
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
    out = {}

    def t(fn):
        return smoke.time_ms(fn, reps)

    for label, n in (("wcoo", N), ("rwcoo", N_WIDE)):
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
        del A, tri
        torch.cuda.empty_cache()
    out.update(pair_times(smoke, dev, reps, dump))
    out.update(stream_turns(smoke, dev, reps))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(HERE)])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="write the runs to this JSON file too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.reps, args.dump)), flush=True)
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
                               str(args.reps), "--dump", str(dumps / f"{i}.pt")],
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append({"root": root, "card": card, **json.loads(proc.stdout.splitlines()[-1])})
        if i:  # dia_pair's u and z against the first run's, on the same inputs
            first, this = (torch.load(dumps / f"{k}.pt") for k in (0, i))
            runs[-1]["dia_pair_max_abs_diff_to_first"] = {
                tag: [float((a.double() - b.double()).abs().max())
                      for a, b in zip(this[tag], first[tag])] for tag in this}
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
