#!/usr/bin/env python3
"""How far apart the two runs of ``chip_smoke.phase_launches`` are, repeated.

    python3 tools/launch_profile_counts.py [--reps 12] [--out FILE]

Phase 10 of ``chip_smoke.py`` counts the CUDA launches per iteration of a
fixed LSQR solve as (device events of a 128-iteration run - a 64-iteration
run) / 64, from the profiler. On chip_smoke's packed f32 operator (11
diagonals, seed 100) at m = n = 2^23 and 2^19, this profiles that pair of
runs ``--reps`` times through the megakernel (one launch per K iterations)
and, every fourth time, on the regular path, with
``chip_smoke.profile_run``. It prints each pair's device event counts, and
the kernels whose counts differ, with the card's name and power limit;
``--out`` also writes them as JSON. Needs one CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch

    import chip_smoke as cs
    import lsqr_tpu_torch as lt

    if not torch.cuda.is_available():
        print("launch_profile_counts: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0]
    cs.log(card)
    rows = []
    for m in (cs.M_MAIN, cs.M_SMALL):
        data, b, _ = cs.random_stripes(m, m, cs.OFFSETS, dev, seed=100, boost=12.0)
        A = lt.dia_operator_device(m, m, cs.OFFSETS, data)
        del data
        for rep in range(args.reps):
            paths = [("megakernel", dict(megakernel=True))]
            if rep % 4 == 0:
                paths.insert(0, ("regular", {}))
            for label, extra in paths:
                counts = {itnlim: cs.profile_run(A, b, itnlim, **extra)[::3]
                          for itnlim in (64, 128)}
                (n64, by64), (n128, by128) = counts[64], counts[128]
                cs.log(f"m={m} {label} rep {rep}: {n64} / {n128} device events, "
                       f"difference {n128 - n64}")
                differ = {}
                for name in sorted(set(by64) | set(by128)):
                    a, c = by64.get(name, (0, 0.0))[0], by128.get(name, (0, 0.0))[0]
                    if label == "megakernel" and a != c:
                        cs.log(f"    {a:6d} / {c:6d}  {name[:90]}")
                        differ[name] = (a, c)
                rows.append(dict(m=m, path=label, rep=rep, events64=n64, events128=n128,
                                 differ=differ))
        del A, b
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
