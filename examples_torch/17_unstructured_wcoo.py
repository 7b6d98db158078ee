"""Fully unstructured sparsity at scale: the WCOO format.

The reference runs arbitrary COO triples through a serial scatter loop
(lsqr.f90:156-194). When the pattern has NO structure to exploit (no
band, no bounded jitter, no blocks) but n <= 4096 (the tall-skinny
least-squares regime, e.g. a regression with millions of observations and
a few thousand features), ``wcoo_operator`` re-lays the entries in chunks
of rows whose products run the port's WCOO kernels on the card
(``wcoo_forward``, ``wcoo_adjoint`` and the fused ``wcoo_pair``;
PERF.md section 6 has their times on the card).

auto_operator picks WCOO on its own for real f32 patterns with
n <= 4096 and m >= 16384 (falling back to COO when the packer refuses a
pathological row distribution); the distributed form is
``lsqr_tpu_torch.parallel.lsqr_sharded_wcoo`` (each rank's row block packs
its own WCOO shard; one all-reduce per iteration).

Run: python examples_torch/17_unstructured_wcoo.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="unstructured sparsity through WCOO")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
m, n = 1 << 18, 2048            # 262k observations, 2048 features
nnz = 1 << 20                   # 4 entries a row: at 8 (the JAX package's
# example) the packer's per-chunk budget, which the port keeps from the JAX
# package, refuses the pattern and both packages route it to HYB

# power-law column popularity (Zipf 1.1), uniform rows: no structure
cols = rng.zipf(1.1, size=4 * nnz) - 1
cols = cols[cols < n][:nnz]
rows = rng.integers(0, m, nnz)
vals = rng.standard_normal(nnz).astype(np.float32)

A = lt.auto_operator(m, n, vals, rows, cols, device=args.device)
print("auto_operator picked:", type(A).__name__)   # WCOOOperator

x_true = rng.standard_normal(n).astype(np.float32)
b = A.matvec(torch.as_tensor(x_true, device=A.device))

res = lt.lsqr(A, b, damp=0.01, atol=1e-6, btol=1e-6)
print(f"istop={int(res.istop)} itn={int(res.itn)} "
      f"rnorm={float(res.rnorm):.3e}")
err = np.abs(res.x.cpu().numpy() - x_true).max()
print(f"max |x - x_true| = {err:.2e}")
