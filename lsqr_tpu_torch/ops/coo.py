"""COO sparse operator: the general correctness path for any pattern.

PyTorch counterpart of :mod:`lsqr_tpu.ops.coo`; ``index_add_`` takes the
place of ``jax.ops.segment_sum``:

    matvec:  zeros(m).index_add_(0, rows, vals * x[cols])
    rmatvec: zeros(n).index_add_(0, cols, vals * y[rows])

Indices are 0-based.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .linop import LinearOperator, as_tensor

__all__ = ["COOOperator", "coo_operator"]


@dataclasses.dataclass(frozen=True)
class COOOperator(LinearOperator):
    """Sparse m x n matrix in coordinate format: vals (nnz,), rows and cols
    (nnz,) int64 indices."""

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    m: int
    n: int

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def matvec(self, x):
        prods = self.vals * x[self.cols]
        return torch.zeros(self.m, dtype=prods.dtype, device=prods.device).index_add_(
            0, self.rows, prods)

    def rmatvec(self, y):
        prods = self.vals.conj() * y[self.rows]
        return torch.zeros(self.n, dtype=prods.dtype, device=prods.device).index_add_(
            0, self.cols, prods)

    def todense(self):
        dense = torch.zeros((self.m, self.n), dtype=self.dtype, device=self.device)
        return dense.index_put_((self.rows, self.cols), self.vals, accumulate=True)


def coo_operator(m, n, vals, rows, cols, *, dtype=None, validate=True,
                 device=None) -> COOOperator:
    """Build a COOOperator with the reference EZ constructor's checks (size
    agreement and index bounds, lsqr.f90:109-111), 0-based."""
    vals = as_tensor(vals, dtype=dtype, device=device)
    rows_np = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows)
    cols_np = np.asarray(cols.cpu() if isinstance(cols, torch.Tensor) else cols)
    if validate:
        if not (vals.shape[0] == rows_np.shape[0] == cols_np.shape[0]):
            raise ValueError(
                f"invalid vals/rows/cols sizes: {vals.shape[0]}, "
                f"{rows_np.shape[0]}, {cols_np.shape[0]}"
            )
        if rows_np.size and (rows_np.min() < 0 or rows_np.max() >= m):
            raise ValueError(f"row indices out of range [0, {m})")
        if cols_np.size and (cols_np.min() < 0 or cols_np.max() >= n):
            raise ValueError(f"column indices out of range [0, {n})")
    return COOOperator(
        vals=vals,
        rows=torch.as_tensor(rows_np.astype(np.int64), device=vals.device),
        cols=torch.as_tensor(cols_np.astype(np.int64), device=vals.device),
        m=int(m),
        n=int(n),
    )
