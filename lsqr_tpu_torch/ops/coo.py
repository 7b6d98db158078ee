"""COO sparse operator: the general correctness path for any pattern.

PyTorch counterpart of :mod:`lsqr_tpu.ops.coo`. Where JAX sums with
``jax.ops.segment_sum``, the port sums each destination's entries in a
fixed order (:class:`GatherSum`): the entries sorted by destination once,
when the operator is built, then a gather and a segmented sum per product,

    matvec:  out[i] = sum over the entries of row i of vals * x[cols]
    rmatvec: out[j] = sum over the entries of column j of conj(vals) * y[rows]

so a product gives the same bits in every run on the card (``index_add_``
adds there with float atomics in no fixed order). Indices are 0-based.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .linop import LinearOperator, as_tensor

__all__ = ["COOOperator", "coo_operator", "GatherSum", "destination_order", "segment_sum"]


def destination_order(dest, length):
    """(order, offsets): the entries' stable sort by destination ``dest``
    (int64, values in [0, length)) and each destination's range of it,
    offsets (length + 1,) int64."""
    dest = dest.long()
    order = torch.argsort(dest, stable=True)
    offsets = torch.zeros(length + 1, dtype=torch.int64, device=dest.device)
    torch.cumsum(torch.bincount(dest, minlength=length), 0, out=offsets[1:])
    return order, offsets


#: the longest segment that :class:`GatherSum` sums one thread a segment
SHORT_SEGMENT = 64


def segment_sum(values, offsets, short=False):
    """The sums of values[offsets[i]:offsets[i + 1]] along dim 0, each in a
    fixed order, 0 for an empty range: ``torch.segment_reduce``, whose CUDA
    sum takes one block per segment for 1-D values (CUB's segmented
    reduction) and one thread per segment and trailing index, in entry
    order, for more dimensions; no atomics, so it gives the same bits in
    every run (the card tests hold it so). ``short`` sums 1-D values one
    thread a segment too (as a column of width 1): faster where every
    segment is short, slower where one is long. Complex values sum their
    real and imaginary parts so."""
    if values.is_complex():
        return torch.complex(segment_sum(values.real.contiguous(), offsets, short),
                             segment_sum(values.imag.contiguous(), offsets, short))
    if short and values.dim() == 1:
        return segment_sum(values[:, None], offsets)[:, 0]
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0, unsafe=True)


@dataclasses.dataclass(frozen=True, eq=False)
class GatherSum:
    """out[i] = the sum, in a fixed order, of vals[k] * vec[src[k]] over the
    entries k with destination i: the entries sorted by destination once
    (:func:`destination_order`), a gather and a :func:`segment_sum` per
    call, one thread a destination where no destination has more than
    SHORT_SEGMENT entries (rows of most patterns), else one block a
    destination (power-law columns)."""

    vals: torch.Tensor     # sorted by destination
    src: torch.Tensor      # int64, in the same order
    offsets: torch.Tensor  # (length + 1,) int64
    short: bool            # every destination has at most SHORT_SEGMENT entries

    @classmethod
    def build(cls, vals, dest, src, length):
        order, offsets = destination_order(dest, length)
        longest = int(torch.diff(offsets).max()) if length else 0
        return cls(vals=vals[order], src=src.long()[order], offsets=offsets,
                   short=longest <= SHORT_SEGMENT)

    def __call__(self, vec):
        return segment_sum(self.vals * vec[self.src], self.offsets, self.short)


@dataclasses.dataclass(frozen=True)
class COOOperator(LinearOperator):
    """Sparse m x n matrix in coordinate format: vals (nnz,), rows and cols
    (nnz,) int64 indices; the products' fixed-order sums by row and by
    column are built with it."""

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    m: int
    n: int
    by_row: GatherSum = dataclasses.field(init=False, repr=False, compare=False)
    by_col: GatherSum = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "by_row", GatherSum.build(self.vals, self.rows, self.cols,
                                                           self.m))
        object.__setattr__(self, "by_col", GatherSum.build(self.vals.conj().resolve_conj(),
                                                           self.cols, self.rows, self.n))

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
        return self.by_row(x)

    def rmatvec(self, y):
        return self.by_col(y)

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
