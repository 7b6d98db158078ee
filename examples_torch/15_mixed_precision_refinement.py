"""Iterative refinement: float64 answers from float32 device solves.

The reference picks ONE precision at compile time (lsqr_kinds.F90:16-24)
and its accuracy is bound by it (lsqr.f90:429-430). On the card the fast
precision is f32, but the warm-start recipe the reference documents
(solve ``A dx = b - A x0``, lsqr.f90:303-320) becomes a precision LADDER
the moment the residual is evaluated in f64: ``lsqr_refined`` runs
Bjorck's augmented-system refinement (f32 device solves, whose operator
products take every kernel path; f64 host residuals) and converges to the
f64 least-squares solution of the stored matrix. Ill-conditioned problems
switch the inner solves to an LSRN preconditioner so the contraction stays
~1e-6 per cycle.

Run: python examples_torch/15_mixed_precision_refinement.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="mixed-precision refinement")
parser.add_argument("--device", default="cuda", help="where the f32 solves run (default: cuda)")
args = parser.parse_args()
dev = torch.device(args.device)

rng = np.random.default_rng(0)
m, n = 2000, 200

# Moderately ill-conditioned (cond = 1e5), INCOMPATIBLE system: the
# hardest case for plain f32: the attainable error carries both a
# cond * eps32 term and a cond^2 * ||r_LS|| * eps32 term.
U, _ = np.linalg.qr(rng.standard_normal((m, n)))
V, _ = np.linalg.qr(rng.standard_normal((n, n)))
sig = np.logspace(0, -5, n)
a32 = ((U * sig) @ V.T).astype(np.float32)
b = rng.standard_normal(m)

x_star, *_ = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)


def err(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.linalg.norm(x.astype(np.float64) - x_star) / np.linalg.norm(x_star))


A = lt.DenseOperator(torch.tensor(a32, device=dev))

# one plain f32 solve: stalls at the f32 accuracy floor
plain = lt.lsqr(A, b.astype(np.float32))
print(f"plain f32 LSQR   itn={int(plain.itn):4d}   rel.err={err(plain.x):.2e}")

# refinement: a handful of f32 solves + f64 host residuals
ref = lt.lsqr_refined(A, b, cycles=12)
print(f"lsqr_refined     cycles={ref.cycles}   rel.err={err(ref.x):.2e}   "
      f"preconditioned={ref.preconditioned}")
print(f"  per-cycle ||dx||: {np.array2string(ref.dx_norms, precision=1)}")
assert err(ref.x) < 1e-9

# the damped problem refines the same way (istop semantics preserved by
# the stacked correction form)
damp = 0.1
xd = np.linalg.solve(a32.astype(np.float64).T @ a32.astype(np.float64)
                     + damp**2 * np.eye(n),
                     a32.astype(np.float64).T @ b)
refd = lt.lsqr_refined(A, b, damp, cycles=8)
errd = float(np.linalg.norm(np.asarray(refd.x) - xd) / np.linalg.norm(xd))
print(f"damped refined   cycles={refd.cycles}   rel.err={errd:.2e}")
assert errd < 1e-11

# TRUTH MODE: when the f64 original of the data exists, pass it as host
# closures: the device still only stores f32, but the refined answer is
# the F64 problem's solution (beyond anything pure f32 can reach: at this
# conditioning the f32-rounded matrix's own LS solution already differs
# from the f64 one measurably)
a64 = (U * sig) @ V.T                       # the unrounded data
x64, *_ = np.linalg.lstsq(a64, b, rcond=None)
rep_gap = float(np.linalg.norm(x_star - x64) / np.linalg.norm(x64))
reft = lt.lsqr_refined(A, b, cycles=12,
                       host_matvec=lambda x: a64 @ x,
                       host_rmatvec=lambda y: a64.T @ y)
errt = float(np.linalg.norm(np.asarray(reft.x) - x64) / np.linalg.norm(x64))
print(f"f64-truth mode   cycles={reft.cycles}   rel.err vs f64 solution="
      f"{errt:.2e}   (f32 representation gap was {rep_gap:.2e})")
assert errt < 1e-9
