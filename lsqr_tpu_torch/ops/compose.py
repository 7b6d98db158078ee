"""Operator algebra: stacks, scalings, diagonals and sums of operators, and
general-form Tikhonov regularization.

PyTorch counterpart of :mod:`lsqr_tpu.ops.compose`. The reference's only
built-in composition is the damped augmentation ``[A; damp*I]``
(lsqr.f90:264-273); here the general form

    min ||A x - b||^2 + lam^2 ||L x||^2

is a stacked operator (:func:`tikhonov`). Every composite is a
LinearOperator, so each solver runs on it unchanged; a member's own
products launch its own kernels (a stack of shared-stripe DIA operators
runs ``dia_product_shared`` forward and adjoint for each member), and the
composite splits and concatenates the vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .linop import LinearOperator, as_operator, as_tensor

__all__ = [
    "VStackOperator",
    "HStackOperator",
    "ScaledOperator",
    "DiagonalOperator",
    "SumOperator",
    "vstack_operators",
    "hstack_operators",
    "scale_operator",
    "diagonal_operator",
    "add_operators",
    "tikhonov",
]


def _conj(t: torch.Tensor) -> torch.Tensor:
    """conj(t), the identity for a real tensor."""
    return t.conj().resolve_conj() if t.is_complex() else t


@dataclasses.dataclass(frozen=True, eq=False)
class _Members(LinearOperator):
    """Shared properties of the composites of several members."""

    ops: tuple
    m: int
    n: int

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    @property
    def nnz(self):
        return sum(int(getattr(op, "nnz", op.m * op.n)) for op in self.ops)


@dataclasses.dataclass(frozen=True, eq=False)
class VStackOperator(_Members):
    """Vertical stack [A_1; A_2; ...], all members sharing n columns:
    matvec concatenates the members' products, rmatvec sums the members'
    adjoints over the matching slices of y."""

    def matvec(self, x):
        return torch.cat([op.matvec(x) for op in self.ops])

    def rmatvec(self, y):
        out, start = None, 0
        for op in self.ops:
            z = op.rmatvec(y[start:start + op.m])
            out = z if out is None else out + z
            start += op.m
        return out

    def todense(self):
        return torch.cat([op.todense() for op in self.ops], dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class HStackOperator(_Members):
    """Horizontal stack [A_1, A_2, ...], all members sharing m rows."""

    def matvec(self, x):
        out, start = None, 0
        for op in self.ops:
            y = op.matvec(x[start:start + op.n])
            out = y if out is None else out + y
            start += op.n
        return out

    def rmatvec(self, y):
        return torch.cat([op.rmatvec(y) for op in self.ops])

    def todense(self):
        return torch.cat([op.todense() for op in self.ops], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class SumOperator(_Members):
    """A_1 + A_2 + ... (all parts share the full (m, n) shape): a matrix
    split by entry into parts that each keep their own product path, as the
    HYB format's ELL part and COO spill. The products and the adjoint are
    the sums of the parts' (conjugation is each part's own)."""

    def matvec(self, x):
        out = self.ops[0].matvec(x)
        for op in self.ops[1:]:
            out = out + op.matvec(x)
        return out

    def rmatvec(self, y):
        out = self.ops[0].rmatvec(y)
        for op in self.ops[1:]:
            out = out + op.rmatvec(y)
        return out

    def todense(self):
        out = self.ops[0].todense()
        for op in self.ops[1:]:
            out = out + op.todense()
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class ScaledOperator(LinearOperator):
    """alpha * A, alpha a 0-d tensor; the adjoint scales by conj(alpha)."""

    op: LinearOperator
    alpha: torch.Tensor
    m: int
    n: int

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def matvec(self, x):
        return self.alpha * self.op.matvec(x)

    def rmatvec(self, y):
        return _conj(self.alpha) * self.op.rmatvec(y)


@dataclasses.dataclass(frozen=True, eq=False)
class DiagonalOperator(LinearOperator):
    """diag(d) as a square n x n operator; the adjoint is diag(conj(d))."""

    d: torch.Tensor
    m: int
    n: int

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    @property
    def nnz(self):
        return self.n

    def matvec(self, x):
        return self.d * x

    def rmatvec(self, y):
        return _conj(self.d) * y

    def todense(self):
        return torch.diag(self.d)


def _members(ops: Sequence) -> tuple:
    ops = tuple(as_operator(op) for op in ops)
    if not ops:
        raise ValueError("need at least one operator")
    return ops


def add_operators(ops: Sequence) -> SumOperator:
    """A_1 + A_2 + ...; all parts must share the same (m, n) shape."""
    ops = _members(ops)
    m, n = ops[0].m, ops[0].n
    for op in ops:
        if (op.m, op.n) != (m, n):
            raise ValueError(
                f"summed operators must share (m, n): got {[(o.m, o.n) for o in ops]}")
    return SumOperator(ops=ops, m=m, n=n)


def vstack_operators(ops: Sequence) -> VStackOperator:
    """[A_1; A_2; ...]; all members must share the column count."""
    ops = _members(ops)
    n = ops[0].n
    if any(op.n != n for op in ops):
        raise ValueError(f"vstack blocks must share n: got {[o.n for o in ops]}")
    return VStackOperator(ops=ops, m=sum(op.m for op in ops), n=n)


def hstack_operators(ops: Sequence) -> HStackOperator:
    """[A_1, A_2, ...]; all members must share the row count."""
    ops = _members(ops)
    m = ops[0].m
    if any(op.m != m for op in ops):
        raise ValueError(f"hstack blocks must share m: got {[o.m for o in ops]}")
    return HStackOperator(ops=ops, m=m, n=sum(op.n for op in ops))


def scale_operator(op, alpha) -> ScaledOperator:
    """alpha * op; alpha (a number or 0-d tensor) goes to op's device."""
    op = as_operator(op)
    alpha = as_tensor(alpha, device=op.device)
    return ScaledOperator(op=op, alpha=alpha, m=op.m, n=op.n)


def diagonal_operator(d, *, device=None) -> DiagonalOperator:
    """diag(d) on ``device`` (the card when None; a tensor stays where it
    is unless a device is named)."""
    d = as_tensor(d, device=device)
    if d.ndim != 1:
        raise ValueError(f"d must be a vector, got shape {tuple(d.shape)}")
    return DiagonalOperator(d=d, m=d.shape[0], n=d.shape[0])


def tikhonov(A, b, L, lam: float = 1.0, *, solver: str = "lsqr", **kwargs):
    """General-form Tikhonov regularization

        min ||A x - b||^2 + lam^2 ||L x||^2

    solved as the stacked problem ``min || [A; lam*L] x - [b; 0] ||``; the
    reference's ``damp`` is the case L = I (lsqr.f90:264-273). ``L`` is
    any LinearOperator, array or (matvec, rmatvec) pair with L.n == A.n.
    ``solver``: 'lsqr' (default), 'lsmr' or 'cgls'; the other keywords go
    to it. Returns that solver's result on the stacked system (rnorm is the
    augmented residual's norm, as the reference's damped rnorm)."""
    A = as_operator(A)
    L = as_operator(L)
    if L.n != A.n:
        raise ValueError(f"L.n ({L.n}) must equal A.n ({A.n})")
    Ls = scale_operator(L, torch.tensor(lam, dtype=A.dtype or torch.float64)) if lam != 1.0 else L
    stacked = vstack_operators([A, Ls])
    b = as_tensor(b, device=A.device)
    bz = torch.cat([b, torch.zeros(L.m, dtype=b.dtype, device=b.device)])
    if solver == "lsqr":
        from ..solver import lsqr as _solve
    elif solver == "lsmr":
        from ..lsmr import lsmr as _solve
    elif solver == "cgls":
        from ..cgls import cgls as _solve
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return _solve(stacked, bz, **kwargs)
