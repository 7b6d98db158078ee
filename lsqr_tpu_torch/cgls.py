"""CGLS: conjugate gradients on the normal equations ``(A'A + damp² I) x =
A'b`` without forming ``A'A`` (Hestenes & Stiefel 1952; Björck 1996, §7.4).

PyTorch counterpart of :mod:`lsqr_tpu.cgls`, with the same recurrences in
the same operation order: ``rnorm`` computed directly from the maintained
residual, ``arnorm = ||A'r - damp² x||``, the Rayleigh lower bound
``max_k ||A p_k|| / ||p_k||`` for ``anorm``, and the noise-floor divergence
guard (istop 6, returning the best iterate). Pair mode is opt-in, as in the
JAX package: one stripe pass gives ``q = A p`` and ``A'q``, and ``A'r`` is
kept by the recurrence ``A'r -= alpha A'q``.

The loop is the LSQR core's masked segments. Complex problems as in LSQR:
complex vectors, real scalars.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import tracing
from .config import real_dtype
from .lsmr import check_complex_pair, sibling_tolerances, solve_dtype
from .ops.blas import nrm2, side_norms
from .ops.linop import LinearOperator, as_operator, as_tensor
from .solver import _run_segments, damped_warm_start, resolve_pair

__all__ = ["CGLSResult", "cgls", "CGLS_ISTOP_MESSAGES"]

CGLS_ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "A x = b is solved to the requested tolerance",
    2: "min ||A x - b|| is solved to the requested tolerance (A'r small)",
    4: "The search direction broke down (delta == 0): x is optimal to "
       "working precision",
    5: "The iteration limit has been reached",
    6: "The recurrence diverged past the working-precision noise floor; "
       "x is the best iterate seen (smallest optimality residual)",
}


class CGLSResult(NamedTuple):
    """CGLS outputs, 0-d tensors on the solve's device except ``x`` (n,)."""

    x: torch.Tensor
    istop: torch.Tensor
    itn: torch.Tensor
    rnorm: torch.Tensor   #: ||b - A x|| (damped: sqrt(||r||² + damp² ||x||²))
    arnorm: torch.Tensor  #: ||A'r - damp² x||, the optimality residual
    anorm: torch.Tensor   #: lower-bound estimate of ||A||
    xnorm: torch.Tensor

    @property
    def istop_message(self) -> str:
        return CGLS_ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor       # m-space residual b - A x
    p: torch.Tensor       # n-space search direction
    gamma: torch.Tensor   # ||A'r - damp² x||²
    anorm: torch.Tensor
    rnorm: torch.Tensor
    ar: torch.Tensor      # A'r by recurrence (pair mode; a (1,) placeholder otherwise)
    gmin: torch.Tensor    # smallest gamma seen
    xbest: torch.Tensor   # the iterate at gmin
    rbest: torch.Tensor   # rnorm at gmin


def _build(
    A: LinearOperator,
    b: torch.Tensor,
    damp: torch.Tensor,
    atol: torch.Tensor,
    btol: torch.Tensor,
    *,
    itnlim: int,
    safe_norms: bool,
    pair: bool = False,
):
    """(carry0, cond_fun, body_fun, finalize), the pieces of
    :func:`lsqr_tpu.cgls._build`."""
    m, n = A.shape
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    dev = b.device
    check_complex_pair(A, dtype, pair)
    zero = torch.tensor(0.0, dtype=rdtype, device=dev)
    one = torch.tensor(1.0, dtype=rdtype, device=dev)
    izero = torch.tensor(0, dtype=torch.int32, device=dev)

    norm_m, norm_n = side_norms(A, safe_norms)  # completed over a shard's groups

    # --- setup: r_0 = b, s_0 = A'r_0, p_0 = s_0 ----------------------------
    bnorm = norm_m(b)
    s0 = torch.where(bnorm > zero, A.rmatvec(b), torch.zeros(n, dtype=dtype, device=dev))
    gnorm0 = norm_n(s0)
    gamma0 = gnorm0 * gnorm0
    # A'b == 0 -> x = 0 is the least-squares solution (istop 0)
    active0 = (bnorm > zero) & (gnorm0 > zero)

    carry0 = _Carry(
        itn=izero, istop=izero, x=torch.zeros(n, dtype=dtype, device=dev), r=b, p=s0,
        gamma=gamma0, anorm=zero, rnorm=bnorm,
        ar=s0 if pair else torch.zeros(1, dtype=dtype, device=dev),
        gmin=gamma0, xbest=torch.zeros(n, dtype=dtype, device=dev), rbest=bnorm,
    )

    def cond_fun(c: _Carry):
        return (c.istop == 0) & active0

    def body_fun(c: _Carry, active: torch.Tensor) -> _Carry:
        itn = c.itn + 1

        if pair:
            # q = A p and A'q in one stripe pass (c2 = 0: y is not read)
            q, t_adj = A.fused_pair(y=c.r, win=c.p, c1=one, c2=zero)
        else:
            q = A.matvec(c.p)
        qn = norm_m(q)
        pn = norm_n(c.p)
        delta = qn * qn + damp * damp * pn * pn
        safe_delta = torch.where(delta > zero, delta, one)
        alpha = torch.where(delta > zero, c.gamma / safe_delta, zero)

        x = c.x + alpha * c.p
        r = c.r - alpha * q
        # ||A p|| / ||p|| is a Rayleigh lower bound on ||A||
        safe_pn = torch.where(pn > zero, pn, one)
        anorm = torch.maximum(c.anorm, torch.where(pn > zero, qn / safe_pn, zero))

        if pair:
            ar = c.ar - alpha * t_adj
            s = ar - damp * damp * x
        else:
            ar = c.ar
            s = A.rmatvec(r) - damp * damp * x
        gnorm = norm_n(s)
        gamma = gnorm * gnorm
        safe_gamma = torch.where(c.gamma > zero, c.gamma, one)
        beta = torch.where(c.gamma > zero, gamma / safe_gamma, zero)
        p = s + beta * c.p

        # the damped residual norm, from the maintained r (the recurrence
        # rnorm² -= alpha*gamma collapses under f32 cancellation)
        xnorm = norm_n(x)
        rn = norm_m(r)
        rnorm = torch.sqrt(rn * rn + damp * damp * xnorm * xnorm)

        # stopping, LSQR's test shapes (lsqr.f90:781-810)
        safe_bnorm = torch.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        denom2 = anorm * rnorm
        safe_d2 = torch.where(denom2 > zero, denom2, one)
        test2 = torch.where(denom2 > zero, gnorm / safe_d2, zero)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        istop = izero
        istop = torch.where(itn >= itnlim, 5, istop)
        istop = torch.where(delta <= zero, 4, istop)
        istop = torch.where(one + test2 <= one, 2, istop)
        istop = torch.where(one + test1 <= one, 1, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)

        # noise-floor divergence guard: keep the best iterate by gamma and
        # stop (istop 6) once gamma climbs 1e8 past its minimum
        better = gamma < c.gmin
        gmin = torch.where(better, gamma, c.gmin)
        xbest = torch.where(better, x, c.xbest)
        rbest = torch.where(better, rnorm, c.rbest)
        finite = torch.isfinite(delta) & torch.isfinite(gamma) & torch.isfinite(rnorm)
        diverged = ~finite | (gamma > 1e8 * gmin)
        istop = torch.where(diverged, 6, istop)

        return _Carry(itn=itn, istop=istop, x=x, r=r, p=p, gamma=gamma, anorm=anorm,
                      rnorm=rnorm, ar=ar, gmin=gmin, xbest=xbest, rbest=rbest)

    def finalize(final: _Carry) -> CGLSResult:
        diverged = final.istop == 6
        x = torch.where(diverged, final.xbest, final.x)
        return CGLSResult(
            x=x, istop=final.istop, itn=final.itn,
            rnorm=torch.where(diverged, final.rbest, final.rnorm),
            arnorm=torch.sqrt(torch.where(diverged, final.gmin, final.gamma)),
            anorm=final.anorm, xnorm=norm_n(x),
        )

    return carry0, cond_fun, body_fun, finalize


@tracing.entry("cgls")
def cgls(
    A,
    b,
    damp: float = 0.0,
    *,
    atol: float = 1e-6,
    btol: float = 1e-6,
    itnlim: Optional[int] = None,
    x0=None,
    safe_norms: bool = True,
    loop: Optional[str] = None,
    loop_segment: int = 64,
    m: Optional[int] = None,
    n: Optional[int] = None,
    pair: Optional[bool] = None,
) -> CGLSResult:
    """Solve ``min ||A x - b||`` (optionally damped) by conjugate gradients
    on the normal equations; the conventions of :func:`lsqr_tpu_torch.lsqr`,
    itnlim 4n by default, a zero tolerance meaning machine precision. Pair
    mode is opt-in (``pair=True``). ``x0`` warm-starts with the
    residual-correction recipe (lsqr.f90:303-320); damped, the stacked
    form of :func:`lsqr_tpu_torch.solver.damped_warm_start`."""
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = solve_dtype(b, A)
    b = b.to(dtype)
    atol, btol = sibling_tolerances(dtype, atol, btol)

    if x0 is not None:
        x0 = as_tensor(x0, dtype=dtype, device=b.device)
        if float(damp) != 0.0:  # the stacked undamped form, as lsqr's
            stacked, rhs = damped_warm_start(A, b, x0, damp)
            res = cgls(stacked, rhs, 0.0, atol=atol, btol=btol, itnlim=itnlim,
                       safe_norms=safe_norms, loop_segment=loop_segment)
        else:
            res = cgls(A, b - A.matvec(x0), damp, atol=atol, btol=btol, itnlim=itnlim,
                       safe_norms=safe_norms, loop_segment=loop_segment, pair=pair)
        xw = x0 + res.x
        return res._replace(x=xw, xnorm=nrm2(xw, safe=safe_norms))

    itnlim = int(itnlim) if itnlim is not None else 4 * A.n
    # pair is opt-in for CGLS: the A'r recurrence adds one more level of f32
    # drift to CGLS's weaker stability
    pair = resolve_pair(A, pair, False)

    def scalar(v):  # damp and the tolerances are real, also for complex problems
        return as_tensor(v, dtype=real_dtype(dtype), device=b.device)

    carry0, cond_fun, body_fun, finalize = _build(
        A, b, scalar(damp), scalar(atol), scalar(btol), itnlim=itnlim,
        safe_norms=safe_norms, pair=pair)
    final = _run_segments(carry0, cond_fun, body_fun, A=A, itnlim=itnlim,
                          seg_len=loop_segment)
    return finalize(final)
