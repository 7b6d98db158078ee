"""CRAIG: the minimum-norm solver for consistent systems (Paige & Saunders,
ACM TOMS 1982, §7.4).

PyTorch counterpart of :mod:`lsqr_tpu.craig`, with the same recurrences in
the same operation order. Craig's method runs LSQR's Golub–Kahan
bidiagonalization (lsqr.f90:681-699) but solves ``L_k y_k = beta_1 e_1`` by
forward substitution: ``y_1 = beta_1/alpha_1``, ``y_i = -(beta_i/alpha_i)
y_{i-1}``, ``x_k = x_{k-1} + y_k v_k``, and ``||r_k|| = |beta_{k+1} y_k|``.
It needs ``b`` in range(A); for least squares use ``lsqr`` or ``lsmr``.

The loop is the LSQR core's masked segments. Complex problems as in LSQR:
complex vectors, real scalars (the bidiagonal entries and y_k).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import real_dtype
from .lsmr import check_complex_pair, solve_dtype
from .ops.blas import nrm2
from .ops.linop import LinearOperator, as_operator, as_tensor
from .solver import _run_segments

__all__ = ["CRAIGResult", "craig", "CRAIG_ISTOP_MESSAGES"]

CRAIG_ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "A x = b is solved to the requested tolerance",
    2: "A x = b is solved as accurately as machine precision allows",
    4: "The bidiagonalization broke down (b is not in range(A): "
       "the system is incompatible — use lsqr/lsmr)",
    5: "The iteration limit has been reached",
}


class CRAIGResult(NamedTuple):
    """CRAIG outputs, 0-d tensors on the solve's device except ``x`` (n,)."""

    x: torch.Tensor
    istop: torch.Tensor
    itn: torch.Tensor
    rnorm: torch.Tensor   #: |beta_{k+1} y_k|, the exact ||b - A x||
    anorm: torch.Tensor   #: Frobenius-norm estimate of A
    xnorm: torch.Tensor

    @property
    def istop_message(self) -> str:
        return CRAIG_ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    x: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    y: torch.Tensor
    anorm2: torch.Tensor
    xnorm2: torch.Tensor
    rnorm: torch.Tensor


def _build(
    A: LinearOperator,
    b: torch.Tensor,
    atol: torch.Tensor,
    btol: torch.Tensor,
    *,
    itnlim: int,
    safe_norms: bool,
    pair: bool = False,
):
    """(carry0, cond_fun, body_fun, finalize), the pieces of
    :func:`lsqr_tpu.craig._build`."""
    m, n = A.shape
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    dev = b.device
    check_complex_pair(A, dtype, pair)
    zero = torch.tensor(0.0, dtype=rdtype, device=dev)
    one = torch.tensor(1.0, dtype=rdtype, device=dev)
    izero = torch.tensor(0, dtype=torch.int32, device=dev)

    def norm(vec):
        return nrm2(vec, safe=safe_norms)

    # --- setup: beta_1 u_1 = b, alpha_1 v_1 = A'u_1 ------------------------
    bnorm = norm(b)
    beta0 = bnorm
    safe_beta0 = torch.where(beta0 > zero, beta0, one)
    u0 = torch.where(beta0 > zero, b / safe_beta0, b)
    v0u = torch.where(beta0 > zero, A.rmatvec(u0), torch.zeros(n, dtype=dtype, device=dev))
    alpha0 = torch.where(beta0 > zero, norm(v0u), zero)
    safe_alpha0 = torch.where(alpha0 > zero, alpha0, one)
    v0 = torch.where(alpha0 > zero, v0u / safe_alpha0, v0u)

    # alpha_1 == 0 < beta_1 means A'b = 0: b has no component in range(A)
    # (istop 4); beta_1 == 0 means x = 0 (istop 0)
    istop0 = torch.where((beta0 > zero) & (alpha0 <= zero), 4, izero)

    carry0 = _Carry(
        itn=izero, istop=istop0, u=u0, v=v0,
        x=torch.zeros(n, dtype=dtype, device=dev),
        alpha=alpha0, beta=beta0, y=one,
        anorm2=alpha0 * alpha0 + beta0 * beta0, xnorm2=zero, rnorm=beta0,
    )

    def cond_fun(c: _Carry):
        return (c.istop == 0) & (beta0 > zero)

    def body_fun(c: _Carry, active: torch.Tensor) -> _Carry:
        itn = c.itn + 1

        # forward substitution: y_1 = beta_1/alpha_1, then the sign chain
        y = torch.where(itn == 1, c.beta / c.alpha, -(c.beta / c.alpha) * c.y)
        x = c.x + y * c.v
        xnorm2 = c.xnorm2 + y * y

        # beta_{k+1} u_{k+1} = A v_k - alpha_k u_k
        if pair:
            u, z_adj = A.fused_pair(y=c.u, win=c.v, c1=one, c2=c.alpha)
        else:
            u = A.matvec(c.v) - c.alpha * c.u
        beta = norm(u)
        beta_pos = beta > zero
        safe_beta = torch.where(beta_pos, beta, one)
        u = torch.where(beta_pos, u / safe_beta, u)

        rnorm = beta * torch.abs(y)

        # alpha_{k+1} v_{k+1} = A'u_{k+1} - beta_{k+1} v_k
        if pair:
            v_cand = torch.where(beta_pos, z_adj / safe_beta, z_adj) - beta * c.v
        else:
            v_cand = A.rmatvec(u) - beta * c.v
        alpha_cand = norm(v_cand)
        alpha_pos = alpha_cand > zero
        safe_alpha = torch.where(alpha_pos, alpha_cand, one)
        v = torch.where(beta_pos & alpha_pos, v_cand / safe_alpha, c.v)
        alpha = torch.where(beta_pos & alpha_pos, alpha_cand, c.alpha)

        anorm2 = c.anorm2 + torch.where(
            beta_pos, beta * beta + torch.where(alpha_pos, alpha_cand ** 2, zero), zero)
        anorm = torch.sqrt(anorm2)
        xnorm = torch.sqrt(xnorm2)

        # stopping: LSQR's compatible-system test (lsqr.f90:781-810)
        safe_bnorm = torch.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        istop = izero
        istop = torch.where(itn >= itnlim, 5, istop)
        istop = torch.where(beta_pos & ~alpha_pos, 4, istop)
        istop = torch.where(one + test1 <= one, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)
        istop = torch.where(~beta_pos, 1, istop)

        return _Carry(itn=itn, istop=istop, u=u, v=v, x=x, alpha=alpha, beta=beta,
                      y=y, anorm2=anorm2, xnorm2=xnorm2, rnorm=rnorm)

    def finalize(final: _Carry) -> CRAIGResult:
        return CRAIGResult(x=final.x, istop=final.istop, itn=final.itn,
                           rnorm=final.rnorm, anorm=torch.sqrt(final.anorm2),
                           xnorm=torch.sqrt(final.xnorm2))

    return carry0, cond_fun, body_fun, finalize


def craig(
    A,
    b,
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
    megakernel: Optional[bool] = None,
    pair: Optional[bool] = None,
) -> CRAIGResult:
    """Minimum-norm solution of a consistent system ``A x = b`` by Craig's
    method; the conventions of :func:`lsqr_tpu_torch.lsqr`, itnlim
    min(m, n) by default. ``megakernel=True`` runs K iterations per kernel
    launch (:func:`lsqr_tpu_torch.ops.megakernel_craig.craig_megakernel`);
    None means False. ``x0`` warm-starts with the residual-correction
    recipe (lsqr.f90:303-320)."""
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = solve_dtype(b, A)
    b = b.to(dtype)

    if megakernel:
        from .ops.megakernel_craig import craig_megakernel, craig_megakernel_supported

        if not (dtype == torch.float32 and craig_megakernel_supported(A)):
            raise ValueError(
                "megakernel=True requires an f32 DIAOperator (f32 or bf16 stripes) "
                "(see ops.megakernel_craig.craig_megakernel_supported)")
        return craig_megakernel(A, b, atol=atol, btol=btol, itnlim=itnlim, x0=x0)

    if x0 is not None:
        x0 = as_tensor(x0, dtype=dtype, device=b.device)
        res = craig(A, b - A.matvec(x0), atol=atol, btol=btol, itnlim=itnlim,
                    safe_norms=safe_norms, loop_segment=loop_segment, pair=pair)
        xw = x0 + res.x
        return res._replace(x=xw, xnorm=nrm2(xw, safe=safe_norms))

    itnlim = int(itnlim) if itnlim is not None else min(A.m, A.n)
    if pair is None:
        pair = bool(getattr(A, "prefers_pair", False))
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(f"{type(A).__name__} does not implement fused_pair; set pair=False")
    rdtype = real_dtype(dtype)  # the tolerances are real, also for complex problems
    carry0, cond_fun, body_fun, finalize = _build(
        A, b, as_tensor(atol, dtype=rdtype, device=b.device),
        as_tensor(btol, dtype=rdtype, device=b.device),
        itnlim=itnlim, safe_norms=safe_norms, pair=pair)
    final = _run_segments(carry0, cond_fun, body_fun, itnlim=itnlim, seg_len=loop_segment)
    return finalize(final)
