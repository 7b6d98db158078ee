"""General-form Tikhonov regularization: min ||A x - b||^2 + lam^2 ||L x||^2.

The reference's built-in ``damp`` is the L = I special case
(lsqr.f90:264-273); real inverse problems usually regularize a DERIVATIVE
of x (smoothness prior). Here: recover a smooth signal from noisy,
blurred measurements using a first-difference L, solved as the stacked
least-squares system [A; lam*L] x = [b; 0] where each block keeps its own
product path (A banded DIA, L banded DIA).

Run: python examples_torch/10_tikhonov_regularization.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="Tikhonov regularization")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
n = 4000

# A: a narrow Gaussian blur (banded, 7 diagonals)
offsets = tuple(range(-3, 4))
kernel = np.exp(-0.5 * (np.arange(-3, 4) / 1.2) ** 2).astype(np.float32)
kernel /= kernel.sum()
data = np.repeat(kernel[:, None], n, axis=1).astype(np.float32)
A = lt.dia_operator(n, n, offsets, data, device=args.device)

# ground truth: a smooth signal; measurements: blurred + noise
t = np.linspace(0, 6 * np.pi, n).astype(np.float32)
x_true = (np.sin(t) + 0.5 * np.sin(0.3 * t)).astype(np.float32)
b = A.matvec(torch.as_tensor(x_true, device=A.device)).cpu().numpy() + 0.01 * \
    rng.standard_normal(n).astype(np.float32)

# L: first differences (the smoothness prior), itself a DIA operator
Ld = np.stack([-np.ones(n - 1, np.float32), np.ones(n - 1, np.float32)])
L = lt.dia_operator(n - 1, n, (0, 1), Ld, device=args.device)


def error(res):
    return float(np.linalg.norm(res.x.cpu().numpy() - x_true) / np.linalg.norm(x_true))


for lam in (0.0, 0.05, 0.5):
    if lam == 0.0:
        # unregularized deblurring diverges (noise amplification): cap it
        res = lt.lsqr(A, b, atol=1e-8, btol=1e-8, itnlim=500)
    else:
        res = lt.tikhonov(A, b, L, lam, atol=1e-8, btol=1e-8)
    print(
        f"lam = {lam:4.2f}: istop {int(res.istop)}, itn {int(res.itn):4d}, "
        f"relative reconstruction error {error(res):.4f}"
    )

# the same stacked problem through the sibling solvers
for solver in ("lsmr", "cgls"):
    res = lt.tikhonov(A, b, L, 0.05, solver=solver, atol=1e-8, btol=1e-8)
    print(f"{solver}: itn {int(res.itn):4d}, error {error(res):.4f}")
