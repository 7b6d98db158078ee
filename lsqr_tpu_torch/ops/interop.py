"""``auto_operator`` and ``from_scipy``: pick a storage format for a matrix.

PyTorch counterpart of :func:`lsqr_tpu.ops.interop.auto_operator` and
:func:`lsqr_tpu.ops.interop.from_scipy`, with the formats ported so far:

1. no entries                                   -> COO
2. few distinct diagonals covering all entries  -> DIA: the shared-stripe
   layout for f32 (and for any dtype with ``compact=True``), the packed
   ``DIAOperator`` for every other real dtype, as in the JAX package

Complex, jittered-diagonal, WCOO, RWCOO, BlockELL and HYB patterns raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import as_dtype
from .coo import coo_operator
from .linop import LinearOperator
from .structured import dia_operator, dia_shared_operator

__all__ = ["auto_operator", "from_scipy"]


def _numpy(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def auto_operator(m, n, vals, rows, cols, *, dtype=None, device=None,
                  compact=False) -> LinearOperator:
    """Build the operator the JAX package's ``auto_operator`` picks for this
    pattern, on ``device``. The stripes are packed on the host (numpy) and
    moved to the device once. ``compact=True`` takes the shared-stripe
    layout for banded patterns of any dtype (one stripe array for both
    products: half the memory of the packed layout)."""
    rows_np, cols_np, vals_np = _numpy(rows), _numpy(cols), _numpy(vals)
    if len(vals_np) == 0:
        return coo_operator(m, n, vals_np, rows_np, cols_np, dtype=dtype, device=device)
    if np.iscomplexobj(vals_np):
        raise NotImplementedError(
            "complex operators (ZDIA/ZJDIA/COO) are not ported yet "
            "(ROADMAP Queue 1 item 12)"
        )
    diags = np.unique(cols_np.astype(np.int64) - rows_np)
    if len(diags) * m <= 4 * len(vals_np) and len(diags) <= 1024:
        stripes = np.zeros((len(diags), m), vals_np.dtype)
        idx = np.searchsorted(diags, cols_np.astype(np.int64) - rows_np)
        np.add.at(stripes, (idx, rows_np), vals_np)
        offsets = tuple(int(k) for k in diags)
        eff = as_dtype(dtype) or as_dtype(vals_np.dtype)
        build = dia_shared_operator if compact or eff == torch.float32 else dia_operator
        return build(m, n, offsets, stripes, dtype=dtype, device=device)
    raise NotImplementedError(
        "only banded patterns are ported: JDIA, WCOO, RWCOO, BlockELL and "
        "HYB routing is ROADMAP Queue 1 item 11; build a COO operator with "
        "coo_operator meanwhile"
    )


def from_scipy(sp_matrix, *, dtype=None, format: Optional[str] = None,
               device=None) -> LinearOperator:
    """Convert a scipy.sparse matrix (any format) to an operator on
    ``device``.

    format: None (:func:`auto_operator`), 'dia' (the packed DIAOperator of
    the matrix's diagonals) or 'coo'. 'ell' and 'block' are not ported yet
    (ROADMAP Queue 1 item 11) and raise ``NotImplementedError``.
    """
    import scipy.sparse

    if not scipy.sparse.issparse(sp_matrix):
        raise TypeError("from_scipy expects a scipy.sparse matrix")
    coo = sp_matrix.tocoo()
    coo.sum_duplicates()
    m, n = coo.shape
    if np.iscomplexobj(coo.data) and format not in (None, "coo", "dia"):
        raise ValueError(
            f"format={format!r} is real-only; complex matrices use the COO "
            "path (format='coo' or None) or the banded ZDIA path "
            "(format='dia')"
        )
    if format is None:
        return auto_operator(m, n, coo.data, coo.row, coo.col, dtype=dtype,
                             device=device)
    if format == "dia":
        dia = sp_matrix.todia()
        # scipy's DIA stores data[j, c] by COLUMN; the stripes here are
        # row-aligned: data[j, i] = A[i, i + k] = scipy_data[j, i + k]
        offsets = tuple(int(k) for k in dia.offsets)
        stripes = np.zeros((len(offsets), m), dia.data.dtype)
        for j, k in enumerate(offsets):
            i_lo, i_hi = max(0, -k), min(m, n - k)
            if i_hi > i_lo:
                stripes[j, i_lo:i_hi] = dia.data[j, i_lo + k:i_hi + k]
        return dia_operator(m, n, offsets, stripes, dtype=dtype, device=device)
    if format == "coo":
        return coo_operator(m, n, coo.data, coo.row, coo.col, dtype=dtype,
                            device=device)
    if format in ("ell", "block"):
        raise NotImplementedError(
            f"format={format!r}: ELL and BlockELL are not ported yet (ROADMAP "
            "Queue 1 item 11); use format='dia', 'coo' or None"
        )
    raise ValueError(f"unknown format {format!r}")
