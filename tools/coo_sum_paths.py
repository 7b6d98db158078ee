#!/usr/bin/env python3
"""The COO products' two fixed-order sums, timed against each other.

    python3 tools/coo_sum_paths.py

At ``bench.py``'s Zipf shapes (m = 2^21, 10,485,760 entries, seed 0, n =
2048 and 65,536) it times, with ``chip_smoke.time_ms``, each of the COO
operator's sums (``by_row`` for A x, ``by_col`` for A' y) both ways, one
thread a destination (``short=True``) and one block a destination, which
one the operator chose, and ``index_add_`` of the same products (float
atomics, the sum before the fixed order) beside. Prints one line, the
card's name and power limit with it. Needs one CUDA device.
"""

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch

    import chip_smoke as cs
    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo

    if not torch.cuda.is_available():
        print("coo_sum_paths: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    m = 2 ** 21
    out = {"card": cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader").splitlines()[0]}
    for n in (2048, 65536):
        coo = lt.coo_operator(m, n, *zipf_column_coo(m, n, 10 * 2 ** 20, seed=0), device=dev)
        x = torch.randn(n, device=dev)
        y = torch.randn(m, device=dev)
        for side, g, v in (("row", coo.by_row, x), ("col", coo.by_col, y)):
            for short in (True, False):
                h = dataclasses.replace(g, short=short)
                out[f"{n}_{side}_short={short}"] = cs.time_ms(lambda: h(v), 10)
            out[f"{n}_{side}_chosen_short"] = g.short
        out[f"{n}_index_add_row"] = cs.time_ms(lambda: torch.zeros(m, device=dev).index_add_(
            0, coo.rows, coo.vals * x[coo.cols]), 10)
        out[f"{n}_index_add_col"] = cs.time_ms(lambda: torch.zeros(n, device=dev).index_add_(
            0, coo.cols, coo.vals * y[coo.rows]), 10)
        del coo
        torch.cuda.empty_cache()
    print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
