"""Self-verification: the adjoint dot-product test and the posterior
solution classifier.

PyTorch counterpart of :mod:`lsqr_tpu.diagnostics`, porting the reference's
``acheck`` (lsqr.f90:908-994) and ``xcheck`` (lsqr.f90:1015-1154).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import default_dtype, eps_for, real_dtype
from .ops.blas import nrm2
from .ops.linop import as_operator, as_tensor

__all__ = ["acheck", "xcheck", "ACheckResult", "XCheckResult"]


class ACheckResult(NamedTuple):
    inform: torch.Tensor  #: 0 = products consistent, 1 = inconsistent
    error: torch.Tensor   #: |y'w - x'v| / (1 + |y'w| + |x'v|)
    tol: float


class XCheckResult(NamedTuple):
    inform: torch.Tensor  #: 0: b=0 & x=0; 1/2/3: solves system 1/2/3; 4: none
    test1: torch.Tensor   #: ||r|| / (||b|| + ||A|| ||x||)
    test2: torch.Tensor   #: ||A'r|| / (||A|| ||r||)
    test3: torch.Tensor   #: ||A'r - damp^2 x|| / (||A|| rho2)
    rnorm: torch.Tensor   #: ||b - A x||
    tol: float


def acheck(A, *, m=None, n=None, eps=None, power: float = 0.5) -> ACheckResult:
    """Check that matvec and rmatvec describe one matrix, by the dot-product
    test y'(y + Ax) = x'(x + A'y) on the reference's deterministic unit
    vectors (lsqr.f90:946-992); tol = eps**power. Over C, A' is the
    conjugate transpose: an adjoint without the conjugate fails."""
    A = as_operator(A, m=m, n=n)
    m, n = A.shape
    dtype = getattr(A, "dtype", None) or default_dtype()
    rdtype = real_dtype(dtype)
    dev = A.device
    tol = float(eps if eps is not None else eps_for(rdtype)) ** power

    x = torch.sqrt(torch.arange(2, n + 2, dtype=rdtype, device=dev))
    y = 1.0 / torch.sqrt(torch.arange(2, m + 2, dtype=rdtype, device=dev))
    x = (x / nrm2(x)).to(dtype)
    y = (y / nrm2(y)).to(dtype)

    w = y + A.matvec(x)
    v = x + A.rmatvec(y)
    # over C: <y, y + Ax> = <x + A^H y, x>, both sides holding y^H A x;
    # vdot conjugates its first argument, as jnp.vdot does
    alfa = torch.vdot(y.to(w.dtype), w)
    beta = torch.vdot(v, x.to(v.dtype))
    error = torch.abs(alfa - beta) / (1.0 + torch.abs(alfa) + torch.abs(beta))
    inform = torch.where(error <= tol, 0, 1).to(torch.int32)
    return ACheckResult(inform=inform, error=error, tol=tol)


def xcheck(A, *, b, x, damp=0.0, anorm, m=None, n=None, eps=None,
           power: float = 0.5) -> XCheckResult:
    """Classify which problem x solves (lsqr.f90:1015-1154): 1. Ax = b,
    2. min ||Ax - b||, 3. damped least squares. ``anorm`` is the solve's
    norm estimate (LSQRResult.anorm)."""
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    x = as_tensor(x, dtype=b.dtype, device=b.device)
    rdtype = real_dtype(b.dtype)  # the norms and tests are real
    tol = float(eps if eps is not None else eps_for(rdtype)) ** power
    damp = as_tensor(damp, dtype=rdtype, device=b.device)
    anorm = as_tensor(anorm, dtype=rdtype, device=b.device)
    dampsq = damp * damp

    u = b - A.matvec(x)              # r   (lsqr.f90:1073-1076)
    v = A.rmatvec(u)                 # A'r (lsqr.f90:1080-1083)
    w = v - dampsq * x               # A'r - damp^2 x (lsqr.f90:1089-1094)

    bnorm = nrm2(b)
    xnorm = nrm2(x)
    rho1 = nrm2(u)
    sigma1 = nrm2(v)

    damped = damp != 0
    rho2 = torch.where(damped, torch.sqrt(rho1**2 + dampsq * xnorm**2), rho1)
    sigma2 = torch.where(damped, nrm2(w), sigma1)

    one = torch.ones((), dtype=rdtype, device=b.device)
    trivial = (bnorm == 0) & (xnorm == 0)
    den1 = bnorm + anorm * xnorm
    test1 = torch.where(den1 > 0, rho1 / torch.where(den1 > 0, den1, one), 0.0)
    test2 = torch.where(rho1 > 0, sigma1 / torch.where(rho1 > 0, anorm * rho1, one), 0.0)
    test3 = torch.where(rho2 > 0, sigma2 / torch.where(rho2 > 0, anorm * rho2, one), test2)

    inform = torch.full((), 4, dtype=torch.int32, device=b.device)
    inform = torch.where(test3 <= tol, 3, inform)
    inform = torch.where(test2 <= tol, 2, inform)
    inform = torch.where(test1 <= tol, 1, inform)
    inform = torch.where(trivial, 0, inform)
    zero = torch.zeros((), dtype=rdtype, device=b.device)
    return XCheckResult(
        inform=inform,
        test1=torch.where(trivial, zero, test1),
        test2=torch.where(trivial, zero, test2),
        test3=torch.where(trivial, zero, test3),
        rnorm=rho1,
        tol=tol,
    )
