"""``auto_operator``, ``from_scipy`` and ``csr_operator``: pick a storage
format for a matrix.

PyTorch counterpart of :mod:`lsqr_tpu.ops.interop`. ``auto_operator`` takes
the JAX package's steps in its order:

1. no entries                                   -> COO
   few distinct diagonals covering all entries  -> DIA: the shared-stripe
   layout for f32 (and for any dtype with ``compact=True``), the packed
   ``DIAOperator`` for every other real dtype
2. jitter-bounded diagonals (>= 95% slot fit)   -> JDIA
3. unstructured f32, tall (m >= 16384), not blocky at (128, 128) (fill
   ratio > 4x):
   4096 < n <= 262,144                          -> RWCOO (hot/cold routing)
   n <= 4096                                    -> WCOO
   where the packer refuses the pattern, on to 4 and 5
4. blocky at (128, 128) (fill ratio <= 64x)     -> BlockELL
5. otherwise                                    -> HYB (ELL + COO spill)

Complex matrices take JAX's complex branch before these steps: banded
patterns the plane-split ZDIA operator, jittered ones with a slot fit of at
least 0.95 ZJDIA, the rest COO.

The WCOO and WWCOO packers keep JAX's refusals (TPU window and VMEM
bounds), so each pattern lands on the operator JAX picks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import as_dtype, resolve_device
from .coo import coo_operator
from .jdia import JDIAFixpointError, from_packing, pack_triplets
from .linop import LinearOperator, placement, to_numpy
from .rwcoo import rwcoo_operator
from .structured import (block_ell_operator, dia_operator, dia_shared_operator,
                         ell_operator, hyb_operator)
from .wcoo import WCOOPackError, wcoo_operator
from .wwcoo import WWCOOPackError
from .zdia import zdia_operator, zjdia_from_packings, zjdia_pack

__all__ = ["auto_operator", "from_scipy", "csr_operator"]


def auto_operator(m, n, vals, rows, cols, *, dtype=None, device=None,
                  compact=False) -> LinearOperator:
    """Build the operator the JAX package's ``auto_operator`` picks for this
    pattern, on ``device``. The stripes are packed on the host (numpy) and
    moved to the device once. ``compact=True`` takes the shared-stripe
    layout for banded patterns of any dtype (one stripe array for both
    products: half the memory of the packed layout). ``device=None`` means
    the device of a tensor ``vals``, else the card."""
    device = placement(vals, device)
    rows_np, cols_np, vals_np = to_numpy(rows), to_numpy(cols), to_numpy(vals)
    if len(vals_np) == 0:
        return coo_operator(m, n, vals_np, rows_np, cols_np, dtype=dtype, device=device)
    diags = np.unique(cols_np.astype(np.int64) - rows_np)
    banded = len(diags) * m <= 4 * len(vals_np) and len(diags) <= 1024
    if banded:
        stripes = np.zeros((len(diags), m), vals_np.dtype)
        idx = np.searchsorted(diags, cols_np.astype(np.int64) - rows_np)
        np.add.at(stripes, (idx, rows_np), vals_np)
        offsets = tuple(int(k) for k in diags)
    if np.iscomplexobj(vals_np):
        return _complex_operator(m, n, vals_np, rows_np, cols_np, dtype, device,
                                 (offsets, stripes) if banded else None)
    eff = as_dtype(dtype) or as_dtype(vals_np.dtype)
    if banded:
        build = dia_shared_operator if compact or eff == torch.float32 else dia_operator
        return build(m, n, offsets, stripes, dtype=dtype, device=device)

    # 2. JDIA when nearly every entry fits a slot (the rest takes the COO
    # remainder); a packing the host packer refuses goes on to the next
    # steps, as in JAX. Only the refusal is caught: a fault while the
    # arrays move to the device raises.
    try:
        packing, nnz = pack_triplets(m, n, to_numpy(vals_np, dtype), rows_np, cols_np)
    except (ValueError, JDIAFixpointError):
        packing = None
    if packing is not None and 1.0 - len(packing["rem_vals"]) / max(nnz, 1) >= 0.95:
        return from_packing(packing, m, n, nnz, device)

    # 3. RWCOO for a wide n, WCOO for n <= 4096; a pattern the packers
    # refuse goes on to the next steps, as in JAX
    if n <= 262_144 and m >= 16384 and eff == torch.float32 \
            and _block_fill_ratio(rows_np, cols_np, m, n) > 4.0:
        build = rwcoo_operator if n > 4096 else wcoo_operator
        try:
            return build(m, n, vals_np, rows_np, cols_np, dtype=dtype, device=device)
        except (WCOOPackError, WWCOOPackError):
            pass

    # 4. BlockELL; 5. HYB when the blocks would store more than 64x nnz
    try:
        return block_ell_operator(m, n, vals_np, rows_np, cols_np, block=(128, 128),
                                  dtype=dtype, device=device)
    except ValueError:
        return hyb_operator(m, n, vals_np, rows_np, cols_np, dtype=dtype, device=device)


def _complex_operator(m, n, vals, rows, cols, dtype, device, banded):
    """JAX's complex branch: the banded pattern's (offsets, stripes) ->
    ZDIA; else ZJDIA when the host packer fits at least 95% of the entries
    into slots (only its refusal is caught); else COO."""
    if banded is not None:
        return zdia_operator(m, n, *banded, dtype=dtype, device=device)
    try:
        re, im, nnz = zjdia_pack(m, n, vals, rows, cols, dtype=dtype)
    except (ValueError, JDIAFixpointError):
        re = None
    if re is not None and 1.0 - len(re["rem_vals"]) / max(nnz, 1) >= 0.95:
        return zjdia_from_packings(re, im, m, n, nnz, device)
    return coo_operator(m, n, vals, rows, cols, dtype=dtype, device=device)


def _block_fill_ratio(rows, cols, m, n, bh=128, bw=128):
    """Stored values / nnz of the (bh, bw) blocked-ELL packing: the cheap
    O(nnz) form of the block packer's fill check, which decides blocky
    against unstructured routing without packing anything."""
    nnz = len(rows)
    if nnz == 0:
        return float("inf")
    mb = -(-m // bh)
    stride = max(-(-n // bw), mb)
    ids = np.unique(rows.astype(np.int64) // bh * stride + cols.astype(np.int64) // bw)
    per_row = np.bincount((ids // stride).astype(np.int64), minlength=mb)
    kb = max(int(per_row.max()) if per_row.size else 0, 1)
    return float(mb) * kb * bh * bw / nnz


def csr_operator(m, n, indptr, indices, data, *, dtype=None, format="ell",
                 device=None) -> LinearOperator:
    """Build an operator from CSR arrays, expanded to COO triplets and
    packed into ``format``: 'ell', 'coo' or 'block'; on ``device`` (when
    None: the device of a tensor ``data``, else the card)."""
    device = placement(data, device)
    indptr, indices, data = to_numpy(indptr), to_numpy(indices), to_numpy(data)
    if np.iscomplexobj(data) and format != "coo":
        raise ValueError(f"format={format!r} is real-only; complex matrices use "
                         "format='coo'")
    rows = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))
    builder = {"ell": ell_operator, "coo": coo_operator,
               "block": block_ell_operator}.get(format)
    if builder is None:
        raise ValueError(f"unknown format {format!r}")
    return builder(m, n, data, rows, indices, dtype=dtype, device=device)


def from_scipy(sp_matrix, *, dtype=None, format: Optional[str] = None,
               device=None) -> LinearOperator:
    """Convert a scipy.sparse matrix (any format) to an operator on
    ``device`` (the card when None).

    format: None (:func:`auto_operator`), 'dia' (the packed DIAOperator of
    the matrix's diagonals; ZDIA for a complex matrix), 'ell', 'coo' or
    'block' (BlockELL at (128, 128)); a complex matrix takes None, 'coo' or
    'dia'.
    """
    import scipy.sparse

    if not scipy.sparse.issparse(sp_matrix):
        raise TypeError("from_scipy expects a scipy.sparse matrix")
    device = resolve_device(device)
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
    builder = {"ell": ell_operator, "coo": coo_operator,
               "block": block_ell_operator}.get(format)
    if builder is not None:
        return builder(m, n, coo.data, coo.row, coo.col, dtype=dtype, device=device)
    raise ValueError(f"unknown format {format!r}")
