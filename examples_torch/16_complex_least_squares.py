"""Complex least squares: recover a complex-valued signal from partial
Fourier measurements (the MRI/radar reconstruction shape).

The reference is real-only (compile-time real32/64/128,
lsqr_kinds.F90:16-24). Over C the Golub-Kahan bidiagonalization applies
verbatim with A' read as the CONJUGATE transpose: ``rmatvec`` conjugates,
every recurrence scalar stays real, and the istop taxonomy is unchanged,
so the full solver family (lsqr/lsmr/cgls/craig) accepts complex operators
directly. The port has no ``enable_x64`` switch: the precision is the
tensors' dtype, complex128 here.

Model: b = F_omega x + noise, where F_omega keeps a random subset of DFT
rows (an under-determined system solved with damped LSQR; the operator is
matrix-free via CallbackOperator: torch.fft, never a dense DFT matrix).

Run: python examples_torch/16_complex_least_squares.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="complex least squares")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
args = parser.parse_args()
dev = torch.device(args.device)

rng = np.random.default_rng(0)
n = 1024          # signal length
m = 400           # measurements kept (under-determined)

# sparse-ish complex signal
x_true = np.zeros(n, complex)
support = rng.choice(n, 25, replace=False)
x_true[support] = rng.standard_normal(25) + 1j * rng.standard_normal(25)

keep = np.sort(rng.choice(n, m, replace=False))
keep_t = torch.as_tensor(keep, device=dev)
scale = 1.0 / np.sqrt(n)  # unitary DFT scaling

# complex "coil sensitivity" modulation in front of the Fourier sampling:
# without it the kept DFT rows are orthonormal and LSQR converges in one
# iteration; the modulation makes the system genuinely iterative
sens_np = ((1.0 + 0.5 * np.cos(2 * np.pi * np.arange(n) / n))
           * np.exp(1j * np.pi * np.sin(6 * np.pi * np.arange(n) / n)))
sens = torch.as_tensor(sens_np, device=dev)


def matvec(x):
    return torch.fft.fft(sens * x)[keep_t] * scale


def rmatvec(y):
    # adjoint of (subsample o FFT o diag(sens)): zero-fill + inverse FFT +
    # conjugate modulation
    full = torch.zeros(n, dtype=y.dtype, device=y.device)
    full[keep_t] = y
    return torch.conj(sens) * torch.fft.ifft(full) * (n * scale)


A = lt.CallbackOperator(m=m, n=n, _matvec=matvec, _rmatvec=rmatvec,
                        dtype=torch.complex128, _device=dev)

# the adjoint dot-product test catches a missing conjugate in rmatvec
assert int(lt.acheck(A).inform) == 0

b = matvec(torch.as_tensor(x_true, device=dev)).cpu().numpy() + 0.001 * (
    rng.standard_normal(m) + 1j * rng.standard_normal(m)
)

res = lt.lsqr(A, b, damp=0.01, atol=1e-10, btol=1e-10, itnlim=200)
x_hat = res.x.cpu().numpy()

# the damped minimum-norm solution matches the closed form built from the
# dense matrix DFT[keep, :] @ diag(sens) (oracle only: the solve itself
# never materializes F)
F = np.fft.fft(np.diag(sens_np), axis=0)[keep] * scale
x_oracle = F.conj().T @ np.linalg.solve(F @ F.conj().T + 1e-4 * np.eye(m), b)

err_oracle = np.abs(x_hat - x_oracle).max()
err_signal = np.linalg.norm(x_hat - x_true) / np.linalg.norm(x_true)
print(f"istop={int(res.istop)} itn={int(res.itn)} rnorm={float(res.rnorm):.3e}")
print(f"max |x - closed_form| = {err_oracle:.3e}")
print(f"relative signal error  = {err_signal:.3f} (underdetermined; "
      "min-norm recovers the support energy, not sparsity)")
assert err_oracle < 1e-8
assert int(lt.xcheck(A, b=b, x=res.x, damp=0.01, anorm=res.anorm).inform) == 3
print("OK")
