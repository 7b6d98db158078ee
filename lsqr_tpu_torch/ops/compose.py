"""Operator algebra: the sum of operators.

PyTorch counterpart of :class:`lsqr_tpu.ops.compose.SumOperator` and
:func:`lsqr_tpu.ops.compose.add_operators` (the rest of the JAX module is
ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .linop import LinearOperator, as_operator

__all__ = ["SumOperator", "add_operators"]


@dataclasses.dataclass(frozen=True, eq=False)
class SumOperator(LinearOperator):
    """A_1 + A_2 + ... (all parts share the full (m, n) shape): a matrix
    split by entry into parts that each keep their own product path, as the
    HYB format's ELL part and COO spill. The products and the adjoint are
    the sums of the parts' (conjugation is each part's own)."""

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


def add_operators(ops: Sequence) -> SumOperator:
    """A_1 + A_2 + ...; all parts must share the same (m, n) shape."""
    ops = tuple(as_operator(op) for op in ops)
    if not ops:
        raise ValueError("need at least one operator")
    m, n = ops[0].m, ops[0].n
    for op in ops:
        if (op.m, op.n) != (m, n):
            raise ValueError(
                f"summed operators must share (m, n): got {[(o.m, o.n) for o in ops]}")
    return SumOperator(ops=ops, m=m, n=n)
