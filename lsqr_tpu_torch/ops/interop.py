"""``auto_operator``: pick a storage format from a COO sparsity pattern.

PyTorch counterpart of :func:`lsqr_tpu.ops.interop.auto_operator`, with the
formats ported so far:

1. no entries                                   -> COO
2. few distinct diagonals covering all entries  -> shared-stripe DIA

The JAX package sends f64 banded patterns to the packed ``DIAOperator``;
until that is ported (ROADMAP Queue 1 item 6) they take the shared layout,
as JAX's ``compact=True`` does (the two layouts give bit-identical
products). Complex, jittered-diagonal, WCOO, RWCOO, BlockELL and HYB
patterns raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .coo import coo_operator
from .linop import LinearOperator
from .structured import dia_shared_operator

__all__ = ["auto_operator"]


def _numpy(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def auto_operator(m, n, vals, rows, cols, *, dtype=None, device=None) -> LinearOperator:
    """Build the operator the JAX package's ``auto_operator`` picks for this
    pattern, on ``device``. The stripes are packed on the host (numpy) and
    moved to the device once."""
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
        return dia_shared_operator(m, n, tuple(int(k) for k in diags), stripes,
                                   dtype=dtype, device=device)
    raise NotImplementedError(
        "only banded patterns are ported: JDIA, WCOO, RWCOO, BlockELL and "
        "HYB routing is ROADMAP Queue 1 item 11; build a COO operator with "
        "coo_operator meanwhile"
    )
