"""Paige–Saunders least-squares test problems: the implicit operator
A = HY · D · HZ (Householder reflections around a diagonal of known
singular values).

PyTorch counterpart of :mod:`lsqr_tpu.models.paige_saunders`
(reference: test/lsqrtest_module.f90: hprod :385-403, aprod1/aprod2
:319-377, lstp :422-505).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..config import as_dtype, default_dtype, resolve_device
from ..ops.blas import nrm2
from ..ops.linop import LinearOperator, as_tensor

__all__ = ["PaigeSaundersOperator", "lstp", "LSTPProblem", "hprod", "suite_configs"]


def hprod(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Householder apply y = (I - 2 h h') x (lsqrtest_module.f90:385-403)."""
    return x - (2.0 * torch.vdot(h, x)) * h


@dataclasses.dataclass(frozen=True, eq=False)
class PaigeSaundersOperator(LinearOperator):
    """Implicit A = HY * D * HZ (m x n): hy (m,), hz (n,) unit Householder
    vectors, d (min(m, n),) the singular values."""

    hy: torch.Tensor
    hz: torch.Tensor
    d: torch.Tensor

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.hy.shape[0]

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.hz.shape[0]

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    def matvec(self, x):
        # aprod1 (lsqrtest_module.f90:319-343): y = HY (D (HZ x)), D
        # truncating or zero-padding to m
        minmn = min(self.m, self.n)
        w = hprod(self.hz, x)
        wm = torch.zeros(self.m, dtype=self.dtype, device=self.device)
        wm[:minmn] = self.d * w[:minmn]
        return hprod(self.hy, wm)

    def rmatvec(self, y):
        # aprod2 (lsqrtest_module.f90:353-377), transposed pipeline
        minmn = min(self.m, self.n)
        w = hprod(self.hy, y)
        wn = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        wn[:minmn] = self.d * w[:minmn]
        return hprod(self.hz, wn)


class LSTPProblem(NamedTuple):
    A: PaigeSaundersOperator
    b: torch.Tensor        #: right-hand side b = r + A x_true
    x_true: torch.Tensor   #: true solution (projected for m < n)
    acond: torch.Tensor    #: exact condition number of Abar
    rnorm: torch.Tensor    #: exact residual norm ||r||


def lstp(m: int, n: int, nduplc: int, npower: int, damp: float, x_true=None,
         *, dtype=None, device=None) -> LSTPProblem:
    """Generate problem P(m, n, nduplc, npower, damp)
    (lstp, lsqrtest_module.f90:422-505) on ``device`` (the card when None);
    see the JAX package's ``lstp``."""
    dtype = as_dtype(dtype) or default_dtype()
    device = resolve_device(device)
    minmn = min(m, n)
    damp = torch.tensor(damp, dtype=dtype, device=device)
    dampsq = damp * damp

    # Householder vectors (:443-455)
    fourpi = 4.0 * math.pi
    i_m = torch.arange(1, m + 1, dtype=dtype, device=device)
    i_n = torch.arange(1, n + 1, dtype=dtype, device=device)
    hy = torch.sin(i_m * (fourpi / m))
    hz = torch.cos(i_n * (fourpi / n))
    hy = -hy / nrm2(hy)
    hz = -hz / nrm2(hz)

    # singular values in duplicated steps (:460-465)
    i0 = torch.arange(minmn, device=device)
    j = i0 // nduplc + 1
    t = (j * nduplc).to(dtype) / minmn
    d = t ** npower

    acond = torch.sqrt((d[minmn - 1] ** 2 + dampsq) / (d[0] ** 2 + dampsq))
    A = PaigeSaundersOperator(hy=hy, hz=hz, d=d)

    # true solution x = Z (w; 0) (:474-481)
    if x_true is None:
        x_true = 0.1 * torch.arange(1, n + 1, dtype=dtype, device=device)
    else:
        x_true = as_tensor(x_true, dtype=dtype, device=device)
    w = hprod(hz, x_true)
    if m < n:
        w[m:] = 0.0
    x_true = hprod(hz, w)

    # residual (:484-497): D r1bar = dampsq x1bar, r2bar = 1, r = HY rbar
    r = torch.zeros(m, dtype=dtype, device=device)
    r[:minmn] = dampsq * w[:minmn] / d
    if m > minmn:
        r[minmn:] = 1.0
    r = hprod(hy, r)

    rnorm = nrm2(r)
    b = r + A.matvec(x_true)    # (:499-503)
    return LSTPProblem(A=A, b=b, x_true=x_true, acond=acond, rnorm=rnorm)


def suite_configs():
    """The 18 reference suite configurations (lsqrtest_module.f90:55-94):
    (m, n) in {(2000,1000), (1000,1000), (1000,2000)} x ndamp in 2..7, with
    nduplc=40, npower=ndamp, damp=10**(-ndamp-6). Yields
    (m, n, nduplc, npower, damp) in reference order."""
    nbar, nduplc = 1000, 40
    for m, n in ((2 * nbar, nbar), (nbar, nbar), (nbar, 2 * nbar)):
        for ndamp in range(2, 8):
            yield (m, n, nduplc, ndamp, 10.0 ** (-ndamp - 6))
