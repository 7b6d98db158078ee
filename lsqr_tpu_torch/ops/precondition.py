"""Preconditioning and scaling: right preconditioning and column scaling.

PyTorch counterpart of :mod:`lsqr_tpu.ops.precondition`. The reference
documents both aids without implementing them (lsqr.f90:283-291, 322-328):
scale the columns of A to one norm, or solve ``A M^-1 z = b`` and recover
``x = M^-1 z``. The column norms come from each storage format's arrays,
with no products. The composites have no fused pair: a solve on them takes
the two-product route of their members' kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .blas import abs2
from .coo import COOOperator, segment_sum
from .linop import DenseOperator, LinearOperator
from .structured import DIAOperator, DIASharedOperator, ELLOperator

__all__ = [
    "ComposedOperator",
    "ColumnScaledOperator",
    "right_preconditioned",
    "column_norms",
    "column_scaled",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ComposedOperator(LinearOperator):
    """B = outer @ inner (matvec applies inner first)."""

    outer: LinearOperator
    inner: LinearOperator

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.outer.m

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.inner.n

    @property
    def dtype(self):
        return self.outer.dtype

    @property
    def device(self):
        return self.outer.device

    def matvec(self, x):
        return self.outer.matvec(self.inner.matvec(x))

    def rmatvec(self, y):
        return self.inner.rmatvec(self.outer.rmatvec(y))


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnScaledOperator(LinearOperator):
    """A @ diag(scale), scale a real (n,) tensor on A's device."""

    op: LinearOperator
    scale: torch.Tensor

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.op.m

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.op.n

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def matvec(self, x):
        return self.op.matvec(self.scale * x)

    def rmatvec(self, y):
        return self.scale * self.op.rmatvec(y)


def right_preconditioned(A: LinearOperator, M_inv: LinearOperator) -> ComposedOperator:
    """``B = A @ M_inv`` for the right-preconditioning recipe
    (lsqr.f90:322-328): solve ``B z = b``, then ``x = M_inv.matvec(z)``."""
    if M_inv.m != A.n:
        raise ValueError(f"M_inv must map n={A.n} -> n; got shape {M_inv.shape}")
    return ComposedOperator(outer=A, inner=M_inv)


def column_norms(A: LinearOperator) -> torch.Tensor:
    """Euclidean norms of the columns of A, from its storage (no products),
    in the operator's working dtype (f32 for bf16 stripes, f64 for f64
    stripes; the JAX package reads shared stripes in f32 whatever their
    dtype, which this port does not copy).

    COO and ELL storage must hold unique coordinates: squares do not
    distribute over duplicate entries."""
    if isinstance(A, DenseOperator):
        return torch.linalg.vector_norm(A.a, dim=0)
    if isinstance(A, COOOperator):
        # the entries sorted by column once, summed in a fixed order
        return torch.sqrt(segment_sum(abs2(A.by_col.vals), A.by_col.offsets, A.by_col.short))
    if isinstance(A, ELLOperator):
        return torch.sqrt(torch.sum(abs2(A.tvals), dim=1))
    if isinstance(A, DIAOperator):
        return torch.sqrt(torch.sum(abs2(A.tdata.to(A.dtype)), dim=0))
    if isinstance(A, DIASharedOperator):
        # column j holds dp[d, H + j - k_d]; the zero halo makes the
        # positions outside the matrix add exactly 0, and the slice of n
        # never reaches the padding past them
        dp2 = A.dp.view(len(A.offsets), A.Lp)
        acc = torch.zeros(A.n, dtype=A.dtype, device=A.device)
        for d, k in enumerate(A.offsets):
            seg = dp2[d, A.H - k:A.H - k + A.n].to(A.dtype)
            acc = acc + seg * seg
        return torch.sqrt(acc)
    raise TypeError(
        f"column_norms has no analytic rule for {type(A).__name__}; "
        "compute your own scale and use ColumnScaledOperator"
    )


def column_scaled(A: LinearOperator,
                  eps: float = 0.0) -> Tuple[ColumnScaledOperator, torch.Tensor]:
    """Scale the columns to unit norm (the reference's advice,
    lsqr.f90:288-291): (scaled operator, scale) with
    ``scale[j] = 1 / ||a_j||`` where ``||a_j|| > eps``, else 1. Solve with
    the scaled operator, then ``x = scale * z``."""
    norms = column_norms(A)
    ones = torch.ones_like(norms)
    scale = torch.where(norms > eps, 1.0 / torch.where(norms > eps, norms, ones), ones)
    return ColumnScaledOperator(op=A, scale=scale), scale
