#!/usr/bin/env python3
"""Whether CUDA's sum of a row of a (k, n) tensor depends on where the row
lies: each row's sum against the sum of its copy (a fresh, aligned tensor),
for f32 and f64 rows at three lengths, with each row's address modulo 64.

    python3 tools/row_sum_alignment.py

Needs a CUDA device. The solves over rows (lsqr_tpu_torch.multidamp.row_ssq)
copy a row off the 64-byte grid before its sum because of what this prints.
"""

import torch


def main():
    if not torch.cuda.is_available():
        raise SystemExit("row_sum_alignment: needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float32, torch.float64):
        for n in (100_003, 2 ** 20 + 3, 2 ** 23 + 1):
            mat = torch.randn((3, n), generator=g, device=dev, dtype=dt)
            rows = [(row.data_ptr() % 64, bool(torch.equal(row.sum(), row.clone().sum())),
                     float(row.sum() - row.clone().sum())) for row in mat]
            print(dt, n, "(address % 64, equal to the copy's sum, difference):", rows,
                  flush=True)


if __name__ == "__main__":
    main()
