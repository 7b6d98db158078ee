"""Differentiable solves: learn a regularization weight, then an
operator's stored values, by gradient descent THROUGH the solver
(``lsqr_tpu_torch.lsqr_grad``, a ``torch.autograd.Function``).

Part 1. Noisy linear measurements b = A x_true + noise. The damped
solution x(damp) trades data fit against ||x||; we tune damp to minimize
reconstruction error on a validation target with ``torch.autograd``:
gradients flow through the LSQR solve via the implicit function theorem
(no differentiation of the iteration; one extra CG solve per backward
pass). A Fortran library cannot do this at all.

Part 2. The gradient also reaches the values a sparse operator stores,
here a BlockELL operator (16 x 16 blocks) whose products run the port's
BlockELL kernels on the card: we calibrate its values so that the solve
reproduces a measured solution. The operator is built from the values by
a gather: each stored position (forward blocks and their transpose copy)
takes its entry, found once by packing the entry numbers, so autograd
carries the gradient of both copies back to the entries.

Run: python examples_torch/11_differentiable_solves.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="gradients through the solver")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()
dev = torch.device(args.device)

rng = np.random.default_rng(0)
m, n = 300, 120
# ill-posed operator: geometrically decaying singular values (condition
# ~1e4), the regime where the damp choice actually matters
U, _ = np.linalg.qr(rng.standard_normal((m, n)))
V, _ = np.linalg.qr(rng.standard_normal((n, n)))
svals = np.logspace(0, -4, n)
A = lt.DenseOperator(torch.tensor((U * svals) @ V.T, dtype=torch.float32, device=dev))
x_true = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
b = A.matvec(x_true) + 0.01 * torch.tensor(rng.standard_normal(m), dtype=torch.float32,
                                           device=dev)


def recon_error(log_damp):
    x = lt.lsqr_grad(A, b, torch.exp(log_damp), atol=1e-10, btol=1e-10)
    return torch.mean((x - x_true) ** 2)


log_damp = torch.tensor(np.log(0.5), dtype=torch.float32, device=dev,
                        requires_grad=True)  # start badly over-damped
lr = 0.5
for step in range(30):
    loss = recon_error(log_damp)
    (g,) = torch.autograd.grad(loss, log_damp)
    with torch.no_grad():
        log_damp -= lr * g
    if step % 5 == 0:
        print(f"step {step:2d}: damp = {float(torch.exp(log_damp.detach())):.5f}  "
              f"reconstruction MSE = {loss.item():.6f}")

print(f"learned damp = {float(torch.exp(log_damp.detach())):.5f}")

# sanity: the learned damp beats both extremes
for d in (1e-5, float(torch.exp(log_damp.detach())), 0.5):
    x = lt.lsqr(A, b, d, atol=1e-10, btol=1e-10).x
    print(f"damp = {d:.5f}: MSE = {float(torch.mean((x - x_true) ** 2)):.6f}")

# ---- part 2: calibrate a BlockELL operator's values -------------------------
bm = 512
vals, rows, cols = lt.random_block_coo(bm, bm, block=16, per_row=3, diag=2.0, seed=1)
nnz = vals.size
# the packings of the entry numbers 1..nnz (0: padding), once
numbers = lt.block_ell_operator(bm, bm, np.arange(1, nnz + 1, dtype=np.float64), rows,
                                cols, block=(16, 16), device=dev)
fwd, adj = numbers.blocks.long(), numbers.tblocks.long()


def block_ell(v):
    """The BlockELL operator storing the values v (a differentiable gather)."""
    vp = torch.cat([v.new_zeros(1), v])
    return lt.BlockELLOperator(blocks=vp[fwd], bcols=numbers.bcols, tblocks=vp[adj],
                               tbrows=numbers.tbrows, m=bm, n=bm)


v_true = torch.tensor(vals, device=dev)
rhs = torch.randn(bm, generator=torch.Generator().manual_seed(2)).to(dev)
x_measured = lt.lsqr(block_ell(v_true), rhs, 0.1, atol=1e-7, btol=1e-7).x
noisy = v_true + 0.05 * torch.randn(nnz, generator=torch.Generator().manual_seed(3)).to(dev)
v = noisy.clone().requires_grad_(True)
opt = torch.optim.Adam([v], lr=2e-3)
for step in range(40):
    x = lt.lsqr_grad(block_ell(v), rhs, 0.1, atol=1e-7, btol=1e-7, itnlim=200)
    loss = torch.sum((x - x_measured) ** 2)
    opt.zero_grad()
    loss.backward()
    opt.step()
    if step % 10 == 0 or step == 39:
        print(f"BlockELL step {step:2d}: ||x(v) - x_measured||^2 = {float(loss):.3e}")
print(f"BlockELL values moved by {float((v - noisy).norm()):.3f} "
      f"(the noise was {float((noisy - v_true).norm()):.3f})")
