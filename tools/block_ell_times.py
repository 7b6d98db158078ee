#!/usr/bin/env python3
"""Device times of the BlockELL kernels, and the BlockELL solves, of one or
more checkouts.

    python3 tools/block_ell_times.py [ROOT ...] [--reps N] [--out FILE]

Each ROOT (default: this checkout) is a checkout of the repository whose
``lsqr_tpu_torch`` is imported and whose kernels are built, in a process of
its own, in the order given; to compare a commit with its parent on one
card, unpack the parent into a git-ignored directory of this checkout
(``git archive <rev> | tar -x -C build/parent``) and pass it before and
after this one: ``build/parent . . build/parent``.

On ``chip_smoke.py``'s BlockELL operators (phases 11-12: m = n = 2^18 with
128 x 128 blocks, 3 per block row, seed 13, whose transpose packing has
kt = 10; the tall 76,763 x 1,485, seed 15, kt = 164) each process times,
through the public wrappers of ``lsqr_tpu_torch.ops.spmv_sparse``:
``block_ell_matvec`` and ``block_ell_matvec_windowed`` on each packing they
take (the windowed one where the packing fits its window: not the tall
transpose) and ``block_ell_pair_windowed`` at 2^18. Then the three
phase-12 solves (damped, to atol = btol = 1e-6: the 2^18 operator with its
products, with ``pair=True``, and the tall one): istop, itn, the wall ms
per iteration of a fixed 64-iteration run after a warm-up one (host clock,
set-up included) and its kernel ms per iteration
(``chip_smoke.phase_launches``, the profiler). The products' results and
the solves' x go to ``build/block_ell_times/<run>.pt``, and this process
prints the largest |difference| of each run's from the first run's (the
same inputs on the same card) and, for x, that difference over max |x|.
Every checkout is timed by this checkout's ``chip_smoke.time_ms`` (the
mean device time of ``--reps`` calls, the card spinning while the host
queues them). Prints one JSON line per checkout (the card's name and power
limit with it) and, with ``--out FILE``, writes them all there. Needs one
CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def yardstick():
    """This checkout's ``chip_smoke.py`` (loaded by path, so that a checkout
    under test cannot replace it): its shapes, seeds and ``time_ms``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root, reps, dump):
    """Times, solves and results of the checkout at ``root`` (this process)."""
    sys.path.insert(0, str(root))
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import random_block_coo
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    assert Path(lt.__file__).resolve().is_relative_to(Path(root).resolve()), lt.__file__
    smoke = yardstick()
    dev = torch.device("cuda")
    out, saved = {}, {}
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    for key, (m, n), seed in (("2^18", (smoke.M_BELL, smoke.M_BELL), 13),
                              ("tall", smoke.BELL_TALL, 15)):
        A = lt.block_ell_operator(m, n, *random_block_coo(m, n, diag=2.0, seed=seed),
                                  device=dev)
        x, y = smoke.padded_vectors(dev, A, seed)
        sides = {"forward": (A.blocks, A.bcols, x), "transpose": (A.tblocks, A.tbrows, y)}
        for side, args in sides.items():
            kernels = [("block_ell_matvec", sp.block_ell_matvec)]
            if smoke.fits_window(args[0]):
                kernels.append(("block_ell_matvec_windowed", sp.block_ell_matvec_windowed))
            for name, fn in kernels:
                tag = f"{name}[{key} {side}, kb={args[0].shape[1]}]"
                out[tag] = smoke.time_ms(lambda fn=fn, args=args: fn(*args), reps)
                saved[tag] = [fn(*args).cpu()]
        if key == "2^18":
            tag = "block_ell_pair_windowed[2^18]"
            args = (A.blocks, A.bcols, x, y, c1, c2)
            out[tag] = smoke.time_ms(lambda: sp.block_ell_pair_windowed(*args), reps)
            saved[tag] = [t.cpu() for t in sp.block_ell_pair_windowed(*args)]
        b = torch.randn(A.m, generator=torch.Generator(device=dev).manual_seed(22), device=dev)
        fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
        for label, kw in (("windowed", {}), ("pair=True", dict(pair=True))) if key == "2^18" \
                else (("tall", {}),):
            res = lt.lsqr(A, b, smoke.DAMP, atol=1e-6, btol=1e-6, **kw)
            lt.lsqr(A, b, smoke.DAMP, **fixed, **kw)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lt.lsqr(A, b, smoke.DAMP, **fixed, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 64
            prof = smoke.phase_launches(A, b, **kw)
            out[f"solve {label}"] = dict(istop=int(res.istop), itn=int(res.itn),
                                         kernel_ms_per_iteration=prof["kernel_ms_per_iteration"],
                                         wall_ms_per_iteration=wall)
            saved[f"x {label}"] = [res.x.cpu()]
        del A, x, y, sides, b
        torch.cuda.empty_cache()
    Path(dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, dump)
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
        print("block_ell_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = []
    dumps = HERE / "build" / "block_ell_times"
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
        if i:  # each result against the first run's
            first, this = (torch.load(dumps / f"{k}.pt") for k in (0, i))
            runs[-1]["max_abs_diff_to_first"] = {
                tag: [float((a.double() - b.double()).abs().max())
                      for a, b in zip(this[tag], first[tag])] for tag in this}
            runs[-1]["x_rel_diff_to_first"] = {
                tag: float((this[tag][0].double() - first[tag][0].double()).abs().max()
                           / first[tag][0].double().abs().max())
                for tag in this if tag.startswith("x ")}
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
