"""Differentiable least squares: gradients through the solver.

PyTorch counterpart of :mod:`lsqr_tpu.implicit`. The solution of

    x*(A, b, damp) = argmin_x ||A x - b||^2 + damp^2 ||x||^2

is an implicit function of the operator's values, b and damp, defined by
the optimality condition F = A'(A x - b) + damp^2 x = 0. By the implicit
function theorem the backward pass for a cotangent g needs one more solve
with the same (SPD) normal operator,

    (A'A + damp^2 I) s = g,

and then, with r = A x - b,

    d/db    = A s
    d/ddamp = -2 damp <s, x>
    d/dA    = -(r s' + (A s) x'),  sampled on the operator's own pattern.

The adjoint solve is conjugate gradients on the normal operator through the
operator's own products (:func:`normal_cg`), so on the card it runs the
product kernels; no kernel needs a backward of its own. The sampled outer
products are plain tensor operations per layout: for a stripe of offset k,
the product of two shifted vectors on the stripe's valid rows.

Gradients flow to ``b``, ``damp`` and the values of the operators whose
products read them as written here: dense entries (``DenseOperator.a``),
COO values (``COOOperator.vals``), packed DIA stripes (``DIAOperator``:
``data`` takes the forward product's share, ``tdata`` the adjoint's, as
autodiff through the JAX package's two stripe products gives them) and
shared DIA stripes (``DIASharedOperator.dp``: both shares). A tensor that
requires grad on any other operator raises TypeError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .ops.coo import COOOperator
from .ops.linop import DenseOperator, LinearOperator, as_operator, as_tensor
from .ops.structured import DIAOperator, DIASharedOperator
from .solver import _run_segments, lsqr

__all__ = ["lsqr_grad", "normal_cg"]

#: the operators whose values take gradients, and those values' fields
DIFFERENTIABLE = {DenseOperator: ("a",), COOOperator: ("vals",),
                  DIAOperator: ("data", "tdata"), DIASharedOperator: ("dp",)}


def _normal_matvec(A, damp, s):
    return A.rmatvec(A.matvec(s)) + (damp * damp) * s


class _CGCarry(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor  # 1 once the residual is small enough or at maxiter
    s: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor


def normal_cg(A, damp, g, *, tol: float = 1e-10, maxiter: Optional[int] = None,
              loop_segment: int = 64) -> torch.Tensor:
    """Solve the regularized normal equations ``(A'A + damp^2 I) s = g``
    for any right-hand side g by conjugate gradients, through the
    operator's products (two an iteration), until ``||r|| <= tol ||g||`` or
    ``maxiter`` (4n) iterations. This is the adjoint solve of the implicit
    gradient; :func:`~lsqr_tpu_torch.cgls` takes only g = A'b.

    The loop is the solvers' host-stepped masked segments of
    ``loop_segment`` iterations."""
    A = as_operator(A)
    g = as_tensor(g, device=A.device)
    dt = g.dtype
    maxiter = 4 * g.shape[0] if maxiter is None else int(maxiter)
    damp = as_tensor(damp, dtype=dt, device=g.device)
    zero = torch.zeros((), dtype=dt, device=g.device)
    one = torch.ones((), dtype=dt, device=g.device)
    gn2 = torch.sum(g * g)
    small = tol * tol * gn2

    def stop(rs, itn):
        return ((rs <= small) | (itn >= maxiter)).to(torch.int32)

    itn0 = torch.zeros((), dtype=torch.int32, device=g.device)
    carry0 = _CGCarry(itn=itn0, istop=stop(gn2, itn0), s=torch.zeros_like(g), r=g, p=g,
                      rs=gn2)

    def cond_fun(c):
        return c.istop == 0

    def body_fun(c, active):
        q = _normal_matvec(A, damp, c.p)
        pq = torch.sum(c.p * q)
        alpha = torch.where(pq > zero, c.rs / torch.where(pq > zero, pq, one), zero)
        s = c.s + alpha * c.p
        r = c.r - alpha * q
        rs = torch.sum(r * r)
        beta = torch.where(c.rs > zero, rs / c.rs, zero)
        itn = c.itn + 1
        return _CGCarry(itn=itn, istop=stop(rs, itn), s=s, r=r, p=r + beta * c.p, rs=rs)

    final = _run_segments(carry0, cond_fun, body_fun, itnlim=maxiter, seg_len=loop_segment)
    return final.s


def _stripes(offsets, m, n, u, v):
    """The outer product u v' (u of length m, v of n) sampled on
    row-aligned stripes (len(offsets), m): out[d, i] = u[i] v[i + k] on the
    rows i where 0 <= i + k < n, 0 elsewhere."""
    out = u.new_zeros((len(offsets), m))
    for d, k in enumerate(offsets):
        lo, hi = max(0, -k), min(m, n - k)
        if hi > lo:
            out[d, lo:hi] = u[lo:hi] * v[lo + k:hi + k]
    return out


def _value_grads(A, r, s, As, x):
    """-(r s' + (A s) x') sampled on each differentiable tensor of A, in
    the order of ``DIFFERENTIABLE[type(A)]``."""
    if isinstance(A, DenseOperator):
        return (-(torch.outer(r, s) + torch.outer(As, x)),)
    if isinstance(A, COOOperator):
        return (-(r[A.rows] * s[A.cols] + As[A.rows] * x[A.cols]),)
    if isinstance(A, DIAOperator):
        # data serves A x (the share (A s) x'), tdata A' r (the share r s',
        # on the transpose's stripes)
        return (-_stripes(A.offsets, A.m, A.n, As, x),
                -_stripes(A.toffsets, A.n, A.m, s, r))
    grad = torch.zeros((len(A.offsets), A.Lp), dtype=r.dtype, device=r.device)
    grad[:, A.H:A.H + A.m] = -(_stripes(A.offsets, A.m, A.n, r, s)
                               + _stripes(A.offsets, A.m, A.n, As, x))
    return (grad.reshape(-1),)


def _tensors(obj, seen=None):
    """Every tensor held by an operator, through nested operators,
    dataclasses, lists and tuples."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item, seen)
    elif (isinstance(obj, LinearOperator) or dataclasses.is_dataclass(obj)) and id(obj) not in seen:
        seen.add(id(obj))
        for value in vars(obj).values():
            yield from _tensors(value, seen)


class _LSQRGrad(torch.autograd.Function):
    """x = lsqr(A, b, damp).x with the implicit-function backward."""

    @staticmethod
    def forward(ctx, A, options, b, damp, *values):
        x = lsqr(A, b, damp, **options).x
        ctx.A, ctx.options = A, options
        ctx.save_for_backward(b, damp, x)
        return x

    @staticmethod
    def backward(ctx, g):
        A = ctx.A
        b, damp, x = ctx.saved_tensors
        tol = ctx.options.get("atol") or 1e-10
        s = normal_cg(A, damp, g, tol=min(float(tol), 1e-8))
        As = A.matvec(s)
        ddamp = -2.0 * damp * torch.sum(s * x)
        values = (None,) * (len(ctx.needs_input_grad) - 4)
        if any(ctx.needs_input_grad[4:]):
            values = tuple(v.to(t.dtype) for v, t in zip(
                _value_grads(A, A.matvec(x) - b, s, As, x),
                (getattr(A, f) for f in DIFFERENTIABLE[type(A)])))
        return (None, None, As, ddamp, *values)


def lsqr_grad(A, b, damp=0.0, *, m: Optional[int] = None, n: Optional[int] = None,
              **options) -> torch.Tensor:
    """Differentiable ``lsqr(A, b, damp).x``: ``torch.autograd`` gradients
    to b, damp (a tensor) and the operator's values (module docstring) by
    the implicit function theorem, one conjugate-gradient solve on the
    normal operator per backward pass.

    ``options`` are :class:`~lsqr_tpu_torch.LSQROptions` overrides for the
    forward solve, atol = btol = 1e-10 unless given: the gradient is exact
    only at the minimizer, so keep them tight. Complex problems raise
    TypeError (real-only), and so does an operator tensor that requires
    grad on an operator whose values take no gradient here."""
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    if b.is_complex() or (A.dtype is not None and A.dtype.is_complex):
        raise TypeError(
            "lsqr_grad is real-only; the complex-capable surface is the core solver "
            "family (lsqr/lsmr/cgls/craig)")
    fields = DIFFERENTIABLE.get(type(A), ())
    if not fields and any(t.requires_grad for t in _tensors(A)):
        names = ", ".join(cls.__name__ for cls in DIFFERENTIABLE)
        raise TypeError(
            f"lsqr_grad takes gradients to the values of {names} only; a tensor of "
            f"this {type(A).__name__} requires grad")
    options.setdefault("atol", 1e-10)
    options.setdefault("btol", 1e-10)
    damp = as_tensor(damp, dtype=b.dtype, device=b.device)
    return _LSQRGrad.apply(A, options, b, damp, *(getattr(A, f) for f in fields))
