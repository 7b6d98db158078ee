"""Damped least squares with standard errors and posterior verification:
solve min ||[A; damp I] x - [b; 0]|| on a sparse random system, then run
acheck/xcheck (the library self-tests, lsqr.f90:908-1154).

Run: python examples_torch/02_damped_least_squares.py [--device cuda|cpu]
"""

import argparse

import numpy as np

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="damped least squares")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
m, n, nnz = 2000, 800, 20_000
A = lt.coo_operator(
    m, n,
    rng.standard_normal(nnz),
    rng.integers(0, m, nnz),
    rng.integers(0, n, nnz),
    device=args.device,
)
b = rng.standard_normal(m)

assert int(lt.acheck(A).inform) == 0, "operator adjoint inconsistency"

res = lt.lsqr(A, b, damp=0.1, atol=1e-8, btol=1e-8, wantse=True)
print("istop  =", int(res.istop), "->", res.istop_message)
print("itn    =", int(res.itn))
print("rnorm  =", float(res.rnorm), " acond =", float(res.acond))
print("se[:5] =", res.se[:5].cpu().numpy())

check = lt.xcheck(A, b=b, x=res.x, damp=0.1, anorm=res.anorm)
print("xcheck inform =", int(check.inform), "(3 = damped LS solution)")
