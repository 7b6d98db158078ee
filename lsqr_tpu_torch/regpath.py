"""Regularization paths on top of :func:`~lsqr_tpu_torch.lsqr_multidamp`.

PyTorch counterpart of :mod:`lsqr_tpu.regpath`. The reference solves one
damp per LSQR call (lsqr.f90:264-273) and leaves the choice of damp to the
user. Here a whole damp grid costs one multi-damp sweep (one product pair an
iteration for every grid point):

* :func:`reg_sweep`: solve a damp grid and return the path (the true
  residual norm ``||b - A x||``, the solution norm and x of each point);
* :func:`discrepancy_damp`: Morozov's discrepancy principle, the largest
  damp whose residual is at most ``tau * noise_norm``;
* :func:`lcurve_corner`: Hansen's L-curve corner, the grid point of most
  curvature of (log residual, log solution norm);
* :func:`gcv_damp`: generalized cross-validation with Hutchinson probes.

LSQR's rnorm is the augmented residual ``||[b - Ax; -damp x]||``
(lsqr.f90:545-549), so the true residual follows from the exit estimates
without a product,

    ||b - A x||^2 = rnorm^2 - damp^2 * xnorm^2

(clamped at 0 for rounding); ``reg_sweep(exact_residual=True)`` computes it
with one product a damp instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import LSQROptions, real_dtype
from .multidamp import lsqr_multidamp
from .ops.blas import abs2
from .ops.linop import as_operator, as_tensor
from .solver import LSQRResult

__all__ = ["RegPath", "reg_sweep", "discrepancy_damp", "lcurve_corner", "gcv_damp"]


class RegPath(NamedTuple):
    """A solved regularization path over a damp grid."""

    damps: torch.Tensor          #: (k,) the grid
    x: torch.Tensor              #: (k, n) solutions
    residual_norm: torch.Tensor  #: (k,) ||b - A x_j|| (true, unaugmented)
    solution_norm: torch.Tensor  #: (k,) ||x_j||
    result: LSQRResult           #: the multi-damp result (istop/itn/estimates)


def _matvec_rows(A, X):
    """A x_j for each row of X, one product a row."""
    return torch.stack([A.matvec(x) for x in X])


def reg_sweep(A, b, damps=None, *, num: int = 16, damp_min: Optional[float] = None,
              damp_max: Optional[float] = None, exact_residual: bool = False,
              options: Optional[LSQROptions] = None, **option_overrides) -> RegPath:
    """Solve ``min ||[A; damp I] x - [b; 0]||`` over a damp grid.

    Args:
      damps: the grid (1-D, in any order). None: ``num`` log-spaced points
        on [damp_min, damp_max], by default ``[1e-6, 1] * ||A'b|| / ||b||``
        (alpha_1 of the bidiagonalization, the scale above which damping
        dominates the spectrum).
      exact_residual: compute ``||b - A x_j||`` with one product a damp
        instead of the exit-estimate identity (module docstring).

    Returns a :class:`RegPath`.
    """
    A = as_operator(A)
    b = as_tensor(b, device=A.device)
    if damps is None:
        if damp_max is None or damp_min is None:
            bn = torch.linalg.vector_norm(b)
            scale = float(torch.linalg.vector_norm(
                A.rmatvec(b / torch.where(bn > 0, bn, torch.ones_like(bn)))))
            scale = scale if scale > 0 else 1.0
            damp_max = damp_max if damp_max is not None else scale
            damp_min = damp_min if damp_min is not None else 1e-6 * scale
        damps = np.logspace(np.log10(damp_min), np.log10(damp_max), num)
    res = lsqr_multidamp(A, b, damps, options=options, **option_overrides)
    # damps and norms stay real, also for complex solutions
    damps = torch.atleast_1d(as_tensor(damps, dtype=real_dtype(res.x.dtype),
                                       device=res.x.device))
    if exact_residual:
        resid = b.to(res.x.dtype)[None, :] - _matvec_rows(A, res.x)
        residual_norm = torch.sqrt(torch.sum(abs2(resid), dim=-1))
        solution_norm = torch.sqrt(torch.sum(abs2(res.x), dim=-1))
    else:
        # ||b - Ax||^2 = rnorm_aug^2 - damp^2 ||x||^2  (lsqr.f90:545-549)
        residual_norm = torch.sqrt(torch.clamp(
            torch.square(res.rnorm) - torch.square(damps * res.xnorm), min=0.0))
        solution_norm = res.xnorm
    return RegPath(damps=damps, x=res.x, residual_norm=residual_norm,
                   solution_norm=solution_norm, result=res)


def discrepancy_damp(A, b, noise_norm: float, *, tau: float = 1.0, damps=None,
                     num: int = 16, options: Optional[LSQROptions] = None,
                     **option_overrides):
    """Morozov's discrepancy principle on a damp grid: the largest grid damp
    whose residual satisfies ``||b - A x|| <= tau * noise_norm`` (the most
    regularized solution the noise allows); where no grid point does, the
    damp with the smallest residual.

    Returns ``(damp, x, path)``.
    """
    path = reg_sweep(A, b, damps, num=num, options=options, **option_overrides)
    ok = path.residual_norm <= tau * noise_norm
    order = torch.argsort(path.damps)
    ok_sorted = ok[order]
    if bool(ok_sorted.any()):
        # the largest acceptable damp in the sorted grid
        idx_sorted = int(torch.nonzero(ok_sorted).max())
    else:
        idx_sorted = int(torch.argmin(path.residual_norm[order]))
    idx = order[idx_sorted]
    return path.damps[idx], path.x[idx], path


def lcurve_corner(path: RegPath):
    """The L-curve corner of a solved path: the grid point of largest
    curvature of ``(log ||b - Ax||, log ||x||)`` (Hansen 1992), by centered
    differences along the grid sorted by damp, parameterized by log damp.

    Returns ``(damp, x, curvature)``, curvature (k,) signed, the ends -inf.
    A grid of fewer than 3 points raises ValueError.
    """
    if path.damps.shape[0] < 3:
        raise ValueError("lcurve_corner needs a grid of at least 3 damps")
    order = torch.argsort(path.damps)
    eps = torch.finfo(path.residual_norm.dtype).tiny
    lr = torch.log(path.residual_norm[order] + eps)
    lx = torch.log(path.solution_norm[order] + eps)
    t = torch.log(path.damps[order] + eps)
    dt, dr, dx = (torch.gradient(f)[0] for f in (t, lr, lx))
    dr, dx = dr / dt, dx / dt
    ddr = torch.gradient(dr)[0] / dt
    ddx = torch.gradient(dx)[0] / dt
    denom = (dr ** 2 + dx ** 2) ** 1.5
    kappa = (dr * ddx - ddr * dx) / torch.where(denom > 0, denom, torch.ones_like(denom))
    kappa[0] = kappa[-1] = -torch.inf
    idx = order[torch.argmax(kappa)]
    curv = torch.full_like(kappa, -torch.inf)
    curv[order] = kappa
    return path.damps[idx], path.x[idx], curv


def gcv_damp(A, b, *, damps=None, num: int = 16, probes=1,
             generator: Optional[torch.Generator] = None,
             options: Optional[LSQROptions] = None, **option_overrides):
    """Generalized cross-validation (Golub, Heath and Wahba 1979) on a damp
    grid: the minimum of

        GCV(damp) = m ||b - A x_damp||^2 / trace(I - H_damp)^2,

    H_damp = A (A'A + damp^2 I)^-1 A'. The trace comes from Hutchinson's
    estimate: for a Rademacher probe w, trace(H) ~ w' A y_w with y_w the
    damped LSQR solution for right-hand side w. So the curve costs
    1 + probes multi-damp sweeps.

    Args:
      probes: the number of Rademacher probes, drawn from ``generator``
        (seeded with 0 when None) on b's device; or the probe vectors
        themselves, a (p, m) array.

    Returns ``(damp, x, path, gcv)``, gcv (k,) aligned with ``path.damps``.
    """
    A = as_operator(A)
    b = as_tensor(b, device=A.device)
    path = reg_sweep(A, b, damps, num=num, options=options, **option_overrides)
    if isinstance(probes, int):
        if generator is None:
            generator = torch.Generator(device=b.device).manual_seed(0)
        signs = torch.randint(0, 2, (probes, A.m), generator=generator, device=b.device)
        probes = (2 * signs - 1).to(b.dtype)
    else:
        probes = as_tensor(probes, dtype=b.dtype, device=b.device)
    trace_h = torch.zeros_like(path.residual_norm)
    for w in probes:
        probe = lsqr_multidamp(A, w, path.damps, options=options, **option_overrides)
        # w' A y_w for each damp, one product a damp (real for a real w:
        # H is Hermitian)
        est = _matvec_rows(A, probe.x) @ w
        trace_h = trace_h + (est.real if est.is_complex() else est) / len(probes)
    m = A.m
    denom = torch.clamp(m - trace_h, min=torch.finfo(trace_h.dtype).tiny)
    gcv = m * torch.square(path.residual_norm) / torch.square(denom)
    idx = torch.argmin(gcv)
    return path.damps[idx], path.x[idx], path, gcv
