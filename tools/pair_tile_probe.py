#!/usr/bin/env python3
"""The shared pair's unstaged kernel against the staged kernel in smaller
tiles, where ``pair_tile``'s rule finds none, in turns, on one card.

    python3 tools/pair_tile_probe.py [--turns 3] [--reps 20] [--out FILE]

On ``chip_smoke.py``'s MANY band (m = n = 2^20, 81 diagonals, phase 4's
stripes), f32 and bf16: ``pair_tile`` gives 0 there (T = 1024 k - halo
stages too many bytes), so ``dia_pair_shared`` takes the unstaged kernel.
This runs the staged kernel (``spmv._dia_pair_shared_launch``) at every
tile T = 256, or T = 256 j - (lo + hi rounded up to 4) >= 256, whose two
stages fit one block an SM (the kernel's shared-memory layout,
``PairLayout`` of csrc/dia_pair_staged.cuh, mirrored in
``staged_bytes``), checks that it gives the unstaged kernel's bits, and
times the unstaged kernel and each tile in turns with
``chip_smoke.time_ms``. Prints one JSON object with the
card's name and power limit; ``--out`` also writes it. Needs one CUDA
device.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def round_up(v, q):
    return -(-v // q) * q


def staged_bytes(nd, lo, hi, T, esize):
    """The staged pair's dynamic shared memory for a tile of T (PairLayout)."""
    span = T + lo + hi
    v = 16 // esize
    L = round_up(span + v - 1, v)
    LX = round_up(span + lo + hi + 3, 4)
    LY = round_up(span + 3, 4)
    U = round_up(span + 3, 4)
    stage = nd * L * esize + (LX + LY) * 4
    return 2 * stage + (U + T) * 4 + 3 * nd * 4


def main():
    import torch

    if not torch.cuda.is_available():
        print("pair_tile_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    card = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0]
    dev = torch.device("cuda")
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    m, ks, boost = cs.MANY
    lo, hi = spmv._halos(ks)
    halo = round_up(lo + hi, 4)
    data, b, g = cs.random_stripes(m, m, ks, dev, seed=104, boost=boost)
    v = torch.randn(m, generator=g, device=dev)
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    kw = dict(offsets=ks, m=m, n=m)
    result = {"card": card, "m": m, "nd": len(ks), "lo": lo, "hi": hi, "optin": optin}
    cs.log(card)
    for storage in (torch.float32, torch.bfloat16):
        tag = str(storage)[6:]
        A = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
        skw = dict(kw, offsets_t=A.offsets_t)
        tile = spmv.pair_tile(dev, storage, len(ks), lo, hi)
        tiles = [T for T in sorted({256, *(256 * j - halo for j in range(1, 33))})
                 if T >= max(256, lo + hi) and T + lo + hi <= 8192
                 and staged_bytes(len(ks), lo, hi, T, storage.itemsize) <= optin]
        calls = {"unstaged": lambda: spmv._dia_pair_shared_launch(A.dp, v, b, c1, c2, tile=0,
                                                                  **skw)}
        for T in tiles:
            calls[f"staged T={T}"] = (lambda T=T: spmv._dia_pair_shared_launch(
                A.dp, v, b, c1, c2, tile=T, **skw))
        ref = calls["unstaged"]()
        same = {}
        for name, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            same[name] = all(torch.equal(a, r) for a, r in zip(got, ref))
        turns = {name: [] for name in calls}
        for _ in range(args.turns):
            for name, fn in calls.items():
                turns[name].append(cs.time_ms(fn, args.reps))
        bytes_moved = len(ks) * m * storage.itemsize + 4 * 4 * m
        bound_ms = bytes_moved / cs.HBM_BYTES_PER_S * 1e3
        result[tag] = {"pair_tile": tile, "tiles": tiles, "bit_equal": same,
                       "turns_ms": turns, "bound_ms": bound_ms,
                       "staged_bytes": {T: staged_bytes(len(ks), lo, hi, T, storage.itemsize)
                                        for T in tiles}}
        for name, t in turns.items():
            cs.log(f"  {tag} {name:14s} {min(t):.5f}-{max(t):.5f} ms "
                   f"(bound {bound_ms:.5f}; bit-equal {same[name]})  [{card}]")
        del A, calls
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if all(all(r["bit_equal"].values()) for r in
                    (result["float32"], result["bfloat16"])) else 1


if __name__ == "__main__":
    sys.exit(main())
