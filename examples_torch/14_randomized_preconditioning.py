"""LSRN: randomized preconditioning makes iteration count conditioning-free.

The reference documents right preconditioning but leaves constructing M to
the user (lsqr.f90:322-328): in serial Fortran building a good M costs as
much as the solve. On the card the construction is cheap where it
matters: the Gaussian sketch G A is a matrix product (or chunked adjoint
products for sparse operators) and the SVD of the small (s, n) sketch runs
on the host. LSRN (Meng-Saunders-Mahoney 2014) then guarantees
cond(A N) <~ 3 w.h.p., so preconditioned LSQR converges in a few tens of
iterations no matter how ill-conditioned A is, and rank-deficient
problems, where plain LSQR stagnates, are handled by truncating the sketch
SVD.

Run: python examples_torch/14_randomized_preconditioning.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="LSRN preconditioning")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()
dev = torch.device(args.device)

rng = np.random.default_rng(0)
m, n = 4000, 400

# An ill-conditioned dense A: geometric singular-value decay over 8 decades.
U, _ = np.linalg.qr(rng.standard_normal((m, n)))
V, _ = np.linalg.qr(rng.standard_normal((n, n)))
sig = np.logspace(0, -8, n)
A = lt.DenseOperator(torch.tensor((U * sig) @ V.T, device=dev))

x_true = rng.standard_normal(n)
b = A.matvec(torch.tensor(x_true, device=dev))


def err(x):
    return float(np.linalg.norm(x.cpu().numpy() - x_true) / np.linalg.norm(x_true))


# Plain LSQR: iteration count scales with cond(A) ~ 1e8; it runs to the
# limit without recovering x.
plain = lt.lsqr(A, b, itnlim=200, atol=1e-10, btol=1e-10)
print(f"plain LSQR    itn={int(plain.itn):4d}  istop={int(plain.istop)}  "
      f"rel.err={err(plain.x):.2e}")

# LSRN: ceil(gamma*n) sketch products + one small host SVD, then LSQR on
# A N with cond(A N) <~ 3: convergence in a few tens of iterations.
res = lt.lsrn(A, b, gamma=4.0, itnlim=200, atol=1e-10, btol=1e-10)
print(f"LSRN + LSQR   itn={int(res.result.itn):4d}  "
      f"istop={int(res.result.istop)}  rel.err={err(res.x):.2e}  "
      f"rank={res.rank}  cond(AN) <= {res.cond_bound:.2f} w.h.p.")

# at cond(A) ~ 1e8 the answer to atol = 1e-10 is good to ~1e-3, hundreds
# of times closer than the plain solve's
assert err(res.x) < 0.01 * err(plain.x)

# Rank-deficient: plain LSQR cannot reveal rank; LSRN truncates it in the
# sketch SVD and returns the minimum-norm LS solution.
r = 150
dense = (U[:, :r] * sig[:r]) @ V.T[:r]
Ad = lt.DenseOperator(torch.tensor(dense, device=dev))
bd = Ad.matvec(torch.tensor(x_true, device=dev))
resd = lt.lsrn(Ad, bd, rcond=1e-6, itnlim=200)
x_pinv = np.linalg.pinv(dense, rcond=1e-6) @ bd.cpu().numpy()
print(f"rank-deficient: detected rank={resd.rank} (true {r}), "
      f"||x - pinv|| = {np.linalg.norm(resd.x.cpu().numpy() - x_pinv):.2e}")
