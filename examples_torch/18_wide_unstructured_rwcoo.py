"""Wide-n unstructured sparsity: hot/cold column routing.

Example 17 covers unstructured patterns with n <= 4096 (WCOO). Real
recommendation / text / graph least-squares problems are WIDER: tens of
thousands of columns with power-law popularity. For
4096 < n <= 262,144, ``rwcoo_operator`` routes the entries at pack time:
the top-4096 columns by count (~86% of the mass at Zipf(1.1)) stream
through the compacted WCOO kernels, and the sparse tail through the
WWCOO wide-n kernels (per-chunk column compaction decouples the O(n)
range walk from the per-entry gathers). PERF.md section 6 has the
kernels' times on the card.

auto_operator picks RWCOO on its own for f32 patterns in that range with
real column concentration; near-uniform wide patterns are refused by the
packer and fall back to ELL/HYB/COO. The distributed forms are
``lsqr_tpu_torch.parallel.lsqr_sharded_rwcoo`` (+ LSMR/CRAIG/CGLS
siblings): row blocks per rank, one global hot column set, one all-reduce
per iteration.

Run: python examples_torch/18_wide_unstructured_rwcoo.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="wide unstructured sparsity through RWCOO")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
m, n = 1 << 20, 1 << 16         # 1M observations, 65,536 features
nnz = 2 * (1 << 20)             # ~2 entries/row: the tall-sparse regime
# (denser-than-~6-entries/row patterns exceed the hot panel's per-chunk
# budget, which the port keeps from the JAX package so that both route
# alike; the packers refuse and auto_operator falls back)

# power-law column popularity (Zipf 1.1), uniform rows: no structure
cols = rng.zipf(1.1, size=6 * nnz) - 1
cols = cols[cols < n][:nnz]
rows = rng.integers(0, m, nnz)
vals = rng.standard_normal(nnz).astype(np.float32)

A = lt.auto_operator(m, n, vals, rows, cols, device=args.device)
print("auto_operator picked:", type(A).__name__)   # RWCOOOperator
print(f"hot panel: {A.hotmap.shape[0]} columns; "
      f"cold stream live: {A.cold is not None}")

x_true = rng.standard_normal(n).astype(np.float32)
b = A.matvec(torch.as_tensor(x_true, device=A.device))

# heavily damped: wide Zipf systems are rank-deficient in the tail
res = lt.lsqr(A, b, damp=0.1, atol=1e-5, btol=1e-5)
print(f"istop={int(res.istop)} itn={int(res.itn)} "
      f"rnorm={float(res.rnorm):.3e}")
