"""General (non-banded) sparse matrices: format auto-selection, the JDIA
streaming path, and the RCM reorder bridge.

The reference accepts arbitrary COO triples (lsqr.f90:91-127) and runs a
serial scatter loop. The port packs the pattern into a streaming format
instead, whose products run hand-written kernels on the card:

  auto_operator  -- inspects the pattern, picks DIA / JDIA / BlockELL /
                    ELL / WCOO
  jdia_operator  -- jittered diagonals: each entry lands in a (diagonal
                    group, jitter slot); products stream like DIA
                    (the ``jdia_matvec`` kernel)
  plan_general   -- for scrambled orderings: RCM-reorders rows/cols to
                    concentrate the band, solves, scatters x back

Run: python examples_torch/07_general_sparsity.py [--device cuda|cpu]
"""

import argparse

import numpy as np

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="general sparsity")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
m = n = 4096

# a banded-ish pattern with jitter: diagonals 0, +-1, +-7 plus noise offsets
nnz_per_row = 7
rows = np.repeat(np.arange(m), nnz_per_row)
jitter = rng.integers(-9, 10, size=rows.size)
cols = np.clip(rows + jitter, 0, n - 1)
vals = rng.standard_normal(rows.size)
# prepend an explicit dominant main diagonal -> well-conditioned
rows = np.concatenate([np.arange(m), rows])
cols = np.concatenate([np.arange(n), cols])
vals = np.concatenate([np.full(m, 8.0), vals])
# deduplicate (keep first) so the operator matches the dense oracle
key = rows.astype(np.int64) * n + cols
_, first = np.unique(key, return_index=True)
rows, cols, vals = rows[first], cols[first], vals[first].astype(np.float32)

A = lt.auto_operator(m, n, vals, rows, cols, device=args.device)
print("auto_operator chose:", type(A).__name__)

b = rng.standard_normal(m)
res = lt.lsqr(A, b, atol=1e-8, btol=1e-8, itnlim=2000)
dense = np.zeros((m, n))
dense[rows, cols] = vals
print(f"istop={int(res.istop)} itn={int(res.itn)} "
      f"||Ax-b||={np.linalg.norm(dense @ res.x.cpu().numpy() - b):.3e} "
      f"(rnorm estimate {float(res.rnorm):.3e})")

# scrambled row/col order destroys the bandedness...
perm_r, perm_c = rng.permutation(m), rng.permutation(n)
s_rows, s_cols = perm_r[rows], perm_c[cols]
plan = lt.plan_general(m, n, vals, s_rows, s_cols, device=args.device)
was_reordered = not np.array_equal(plan.row_order, np.arange(m))
print("scrambled pattern plan: reordered =", was_reordered,
      "format =", type(plan.op).__name__)
res2 = plan.solve(b, atol=1e-8, btol=1e-8, itnlim=2000)
dense2 = np.zeros((m, n))
dense2[s_rows, s_cols] = vals
print(f"scrambled solve: istop={int(res2.istop)} itn={int(res2.itn)} "
      f"||Ax-b||={np.linalg.norm(dense2 @ res2.x.cpu().numpy() - b):.3e}")
