"""Hybrid LSQR: semiconvergence handled automatically.

Plain LSQR on a noisy ill-posed problem SEMICONVERGES: the error drops,
bottoms out, then grows as the Krylov subspace starts fitting noise. The
reference can only counter that with a damp fixed in advance
(lsqr.f90:264-273). ``hybrid_lsqr`` regularizes the PROJECTED problem
instead: the Golub-Kahan basis is stored (and reorthogonalized), a tiny
(k+1, k) Tikhonov problem is solved per iteration with a GCV-chosen
lambda on the host, and the iteration stops when the projected GCV
flattens. No noise level, no damp, no iteration count to guess.

Run: python examples_torch/13_hybrid_regularization.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="hybrid regularization")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
n = 2000
noise = 0.05

# A: Gaussian blur (banded, 13 diagonals), severely smoothing, ill-posed
offsets = tuple(range(-6, 7))
kernel = np.exp(-0.5 * (np.arange(-6, 7) / 2.2) ** 2).astype(np.float32)
kernel /= kernel.sum()
data = np.repeat(kernel[:, None], n, axis=1).astype(np.float32)
A = lt.dia_operator(n, n, offsets, data, device=args.device)

t = np.linspace(0, 6 * np.pi, n).astype(np.float32)
x_true = (np.sin(t) + 0.5 * np.sin(0.3 * t)).astype(np.float32)
e = rng.standard_normal(n).astype(np.float32)
e *= noise / np.linalg.norm(e)
b = A.matvec(torch.as_tensor(x_true, device=A.device)).cpu().numpy() + e


def err(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))


# ---- plain LSQR, run "too long": semiconvergence ---------------------------
for k in (5, 15, 40, 120):
    r = lt.lsqr(A, b, atol=0.0, btol=0.0, conlim=0.0, itnlim=k)
    print(f"plain LSQR  itn={int(r.itn):4d}  rel err = {err(r.x):.4f}")

# ---- hybrid: lambda and stopping point chosen by projected GCV -------------
res = lt.hybrid_lsqr(A, b, k=60)
print(f"\nhybrid_lsqr chose k = {res.k} (ran {res.k_run}), "
      f"lambda = {res.lam:.4g}")
print(f"hybrid      rel err = {err(res.x):.4f}")

# The stored factorization is reusable: re-solve at another lambda for free
y = lt.projected_tikhonov(res.basis.bidiagonal(),
                          float(res.basis.beta[0]), 10 * res.lam)
x_over = y @ np.asarray(res.basis.V.cpu() if isinstance(res.basis.V, torch.Tensor)
                        else res.basis.V)
print(f"re-solve at 10x lambda (no products): rel err = {err(x_over):.4f}")
