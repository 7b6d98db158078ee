"""The whole regularization path from ONE bidiagonalization.

The damping parameter enters LSQR only after the bidiagonalization
(lsqr.f90:703-710), so ``lsqr_multidamp`` solves a whole grid of damp
values while computing the two operator products (the entire
memory-heavy cost) once per iteration. Here: a noisy deblurring problem
where the damp is chosen automatically, by Morozov's discrepancy
principle when the noise level is known, by the L-curve corner when it is
not.

Run: python examples_torch/12_regularization_path.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="a regularization path")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
n = 4000
noise = 0.02

# A: Gaussian blur (banded, 9 diagonals), poorly conditioned
offsets = tuple(range(-4, 5))
kernel = np.exp(-0.5 * (np.arange(-4, 5) / 1.6) ** 2).astype(np.float32)
kernel /= kernel.sum()
data = np.repeat(kernel[:, None], n, axis=1).astype(np.float32)
A = lt.dia_operator(n, n, offsets, data, device=args.device)

t = np.linspace(0, 6 * np.pi, n).astype(np.float32)
x_true = (np.sin(t) + 0.5 * np.sin(0.3 * t)).astype(np.float32)
e = rng.standard_normal(n).astype(np.float32)
e *= noise / np.linalg.norm(e)
b = A.matvec(torch.as_tensor(x_true, device=A.device)).cpu().numpy() + e

# ---- one sweep: 16 damps, ONE shared bidiagonalization -------------------
path = lt.reg_sweep(A, b, num=16, damp_min=1e-5, damp_max=1.0,
                    atol=1e-7, btol=1e-7, itnlim=400)
print("damp grid:", np.array2string(path.damps.cpu().numpy(), precision=1))
for d, r, xn, it in zip(path.damps.tolist(), path.residual_norm.tolist(),
                        path.solution_norm.tolist(), path.result.itn.tolist()):
    print(f"  damp={d:9.2e}  ||b-Ax||={r:9.3e}  ||x||={xn:8.3f}  itn={int(it)}")

# ---- choose damp two ways -------------------------------------------------
damp_dp, x_dp, _ = lt.discrepancy_damp(
    A, b, noise, tau=1.05, damps=path.damps, atol=1e-7, btol=1e-7, itnlim=400
)
damp_lc, x_lc, _ = lt.lcurve_corner(path)


def err(x):
    return float(np.linalg.norm(x.cpu().numpy() - x_true) / np.linalg.norm(x_true))


print(f"\nnoise level {noise:.3e}")
print(f"discrepancy principle: damp = {float(damp_dp):.3e}, rel err {err(x_dp):.3e}")
print(f"L-curve corner:        damp = {float(damp_lc):.3e}, rel err {err(x_lc):.3e}")
print(f"unregularized end:     damp = {float(path.damps[0]):.3e}, "
      f"rel err {err(path.x[0]):.3e}")
