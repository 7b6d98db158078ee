"""Host-side (numpy/scipy, float64) export of operators.

PyTorch counterpart of :mod:`lsqr_tpu.ops.host`: each storage format's
device arrays are walked back into plain COO triplets on the host, without
a dense matrix. ``to_scipy(A)`` is the inverse of
:func:`~lsqr_tpu_torch.ops.interop.from_scipy` up to the storage format,
and ``host_products(A)`` gives f64 products over a scipy CSR built once:
the residuals of mixed-precision refinement (:mod:`lsqr_tpu_torch.refine`).

The exported matrix is the operator's STORED values (f32 or bf16 entries
promoted exactly to f64), the matrix the device products apply. Each of an
operator's arrays is copied to the host once; the triplets are built from
it with vectorized numpy.
"""

from __future__ import annotations

import numpy as np

from .linop import to_numpy

__all__ = ["host_coo", "to_scipy", "host_products"]


def _host(t, dtype=None) -> np.ndarray:
    """One device-to-host copy of a tensor; bf16 widened on the host."""
    import torch

    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        t = t.detach().cpu().float()
    return to_numpy(t, dtype)


def _coo_of_dia(offsets, data, m, n, dtype):
    """data[j, i] = A[i, i + offsets[j]] (row-aligned stripes)."""
    rows, cols, vals = [], [], []
    for j, k in enumerate(offsets):
        lo, hi = max(0, -k), min(m, n - k)
        if hi <= lo:
            continue
        i = np.arange(lo, hi, dtype=np.int64)
        rows.append(i)
        cols.append(i + k)
        vals.append(np.asarray(data[j, lo:hi], dtype))
    if not rows:
        z = np.zeros((0,), np.int64)
        return z, z, np.zeros((0,), dtype)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def host_coo(A, *, dtype=np.float64, dense_limit: int = 1 << 25):
    """``(rows, cols, vals)`` numpy COO triplets of the operator's stored
    matrix, promoted to ``dtype``.

    Duplicate (row, col) pairs may appear; they sum (scipy's COO -> CSR
    conversion and ``np.add.at`` both do). Operators without a rule here
    (callbacks, implicit test operators, the formats the JAX package has no
    rule for) take ``todense()`` when ``m * n <= dense_limit``."""
    from .coo import COOOperator
    from .linop import DenseOperator, _TransposedOperator
    from .structured import BlockELLOperator, DIAOperator, DIASharedOperator, ELLOperator

    dtype = np.dtype(dtype)

    if isinstance(A, COOOperator):
        return _host(A.rows, np.int64), _host(A.cols, np.int64), _host(A.vals, dtype)

    if isinstance(A, DenseOperator):
        a = _host(A.a, dtype)
        r, c = np.nonzero(a)
        return r.astype(np.int64), c.astype(np.int64), a[r, c]

    if isinstance(A, (DIAOperator, DIASharedOperator)):
        # DIASharedOperator.data is the (nd, m) view of dp without its halo
        return _coo_of_dia(A.offsets, _host(A.data, dtype), A.m, A.n, dtype)

    if isinstance(A, ELLOperator):
        k = A.vals.shape[1]
        rows = np.repeat(np.arange(A.m, dtype=np.int64), k)
        cols = _host(A.cols, np.int64).reshape(-1)
        vals = _host(A.vals, dtype).reshape(-1)
        keep = vals != 0  # padded entries are (value 0, column 0)
        return rows[keep], cols[keep], vals[keep]

    if isinstance(A, BlockELLOperator):
        blocks = _host(A.blocks, dtype)                    # (mb, kb, bh, bw)
        mb, kb, bh, bw = blocks.shape
        bcols = _host(A.bcols, np.int64)                   # (mb, kb)
        ii, jj = np.meshgrid(np.arange(bh, dtype=np.int64),
                             np.arange(bw, dtype=np.int64), indexing="ij")
        r0 = (np.arange(mb, dtype=np.int64) * bh)[:, None, None, None]
        c0 = (bcols * bw)[:, :, None, None]
        rows = np.broadcast_to(r0 + ii, blocks.shape).reshape(-1)
        cols = np.broadcast_to(c0 + jj, blocks.shape).reshape(-1)
        vals = blocks.reshape(-1)
        keep = (vals != 0) & (rows < A.m) & (cols < A.n)
        return rows[keep], cols[keep], vals[keep]

    if isinstance(A, _TransposedOperator):
        r, c, v = host_coo(A.op, dtype=dtype, dense_limit=dense_limit)
        return c, r, v

    jdia = _try_jdia_coo(A, dtype)
    if jdia is not None:
        return jdia

    comp = _try_composite_coo(A, dtype, dense_limit)
    if comp is not None:
        return comp

    if A.m * A.n > dense_limit:
        raise NotImplementedError(
            f"host_coo: no sparse host export for {type(A).__name__} and "
            f"m*n = {A.m * A.n} exceeds dense_limit = {dense_limit}; pass "
            "host_matvec/host_rmatvec callables instead"
        )
    a = _host(A.todense(), dtype)
    r, c = np.nonzero(a)
    return r.astype(np.int64), c.astype(np.int64), a[r, c]


def _try_jdia_coo(A, dtype):
    from .jdia import JITTER, JDIAOperator

    if not isinstance(A, JDIAOperator):
        return None
    # slot s of row i holds column i + (base[s, i // tm] + JITTER - p_lo)
    # + eoff[s, i]; the slots vectorized over rows
    m = A.m
    data = _host(A.data, dtype)[:, :m]               # (ns, m)
    eoff = _host(A.eoff, np.int64)[:, :m]
    base = _host(A.base, np.int64)
    i = np.arange(m, dtype=np.int64)
    tiles = i // A.tm
    rows, cols, vals = [], [], []
    for s in range(data.shape[0]):
        c = i + base[s, tiles] + JITTER - A.p_lo + eoff[s]
        keep = (data[s] != 0) & (c >= 0) & (c < A.n)
        rows.append(i[keep])
        cols.append(c[keep])
        vals.append(data[s][keep])
    rv = _host(A.rem_vals, dtype)
    if rv.shape[0]:
        keep = rv != 0
        rows.append(_host(A.rem_rows, np.int64)[keep])
        cols.append(_host(A.rem_cols, np.int64)[keep])
        vals.append(rv[keep])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _try_composite_coo(A, dtype, dense_limit):
    from .compose import DiagonalOperator, HStackOperator, ScaledOperator, VStackOperator
    from .precondition import ColumnScaledOperator, ComposedOperator

    if isinstance(A, (VStackOperator, HStackOperator)):
        vertical = isinstance(A, VStackOperator)
        rows, cols, vals = [], [], []
        off = 0
        for op in A.ops:
            r, c, v = host_coo(op, dtype=dtype, dense_limit=dense_limit)
            rows.append(r + off if vertical else r)
            cols.append(c if vertical else c + off)
            vals.append(v)
            off += op.m if vertical else op.n
        return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)

    if isinstance(A, DiagonalOperator):
        d = _host(A.d, dtype)
        i = np.arange(d.shape[0], dtype=np.int64)
        return i, i, d

    if isinstance(A, ScaledOperator):
        r, c, v = host_coo(A.op, dtype=dtype, dense_limit=dense_limit)
        return r, c, v * dtype.type(_host(A.alpha, dtype))

    if isinstance(A, ColumnScaledOperator):
        r, c, v = host_coo(A.op, dtype=dtype, dense_limit=dense_limit)
        return r, c, v * _host(A.scale, dtype)[c]

    if isinstance(A, ComposedOperator):
        import scipy.sparse as sp

        prod = (to_scipy(A.outer, dtype=dtype, dense_limit=dense_limit)
                @ to_scipy(A.inner, dtype=dtype, dense_limit=dense_limit))
        coo = sp.coo_matrix(prod)
        return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data.astype(dtype)

    return None


def to_scipy(A, *, dtype=np.float64, dense_limit: int = 1 << 25):
    """The operator's stored matrix as a ``scipy.sparse.csr_matrix`` in
    ``dtype`` (default float64)."""
    import scipy.sparse as sp

    r, c, v = host_coo(A, dtype=dtype, dense_limit=dense_limit)
    return sp.csr_matrix(sp.coo_matrix((v, (r, c)), shape=(A.m, A.n), dtype=dtype))


def host_products(A, *, dtype=np.float64, dense_limit: int = 1 << 25):
    """``(matvec, rmatvec)`` numpy closures (default float64) applying the
    operator's stored matrix on the host; for a complex ``dtype`` rmatvec
    is the conjugate transpose."""
    sp_a = to_scipy(A, dtype=dtype, dense_limit=dense_limit)
    sp_at = sp_a.T.tocsr()
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        sp_at = sp_a.conj().T.tocsr()

    def matvec(x):
        return sp_a @ np.asarray(x, dtype)

    def rmatvec(y):
        return sp_at @ np.asarray(y, dtype)

    return matvec, rmatvec
