"""The four solvers on one operator: LSQR, LSMR, CRAIG, CGLS.

All cost the same two hot products per iteration (lsqr.f90:681-699) on the
same LinearOperator; they differ in what they minimize / how:

  lsqr  -- min ||Ax - b||          (the reference algorithm; also damped)
  lsmr  -- same, but ||A'r|| decreases monotonically -> safer early stop
  craig -- min ||x|| s.t. Ax = b   (consistent systems only, cheapest/iter)
  cgls  -- min ||Ax - b|| via CG on the normal equations (the classic
           alternative the LSQR paper benchmarks against)

Run: python examples_torch/06_solver_family.py [--device cuda|cpu]
"""

import argparse

import numpy as np

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="the four solvers")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
m, n = 120, 300  # under-determined => consistent, min-norm is interesting
dense = rng.standard_normal((m, n))
r, c = np.nonzero(dense)
A = lt.coo_operator(m, n, dense[r, c], r, c, device=args.device)
b = dense @ rng.standard_normal(n)

results = [(name, getattr(lt, name)(A, b, atol=1e-10, btol=1e-10, itnlim=500))
           for name in ("lsqr", "lsmr", "craig", "cgls")]

for name, res in results:
    x = res.x.cpu().numpy()
    print(
        f"{name:5s}: istop={int(res.istop)} itn={int(res.itn):3d} "
        f"||x||={np.linalg.norm(x):.6f} "
        f"||Ax-b||={np.linalg.norm(dense @ x - b):.2e}"
    )

# on a consistent system all four land on the same minimum-norm solution
x_mn = np.linalg.pinv(dense) @ b
for name, res in results:
    err = np.abs(res.x.cpu().numpy() - x_mn).max()
    print(f"{name:5s}: max deviation from pinv minimum-norm solution {err:.2e}")
