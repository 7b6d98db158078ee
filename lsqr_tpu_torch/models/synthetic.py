"""Synthetic benchmark and test problems.

PyTorch counterpart of :mod:`lsqr_tpu.models.synthetic`. The values come
from numpy's generator, as in the JAX package, so both packages build the
same matrices and right-hand sides from one seed; ``device`` says where the
port's operator and vectors live (the card when None).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.coo import COOOperator, coo_operator
from ..ops.structured import DIAOperator, dia_operator

__all__ = ["banded_problem", "random_coo_problem", "banded_dia", "block_banded_coo",
           "jittered_band_coo", "random_block_coo", "zipf_coo"]


def banded_dia(m, n, offsets: Sequence[int], *, seed=0, dtype=np.float32,
               device=None) -> DIAOperator:
    """Random banded matrix in packed DIA storage with the given offsets."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), m)).astype(dtype)
    return dia_operator(m, n, offsets, data, device=device)


def banded_problem(m, n, bandwidth: int, *, seed=0, dtype=np.float32, device=None):
    """A banded least-squares problem: a DIA operator with
    ``2*bandwidth + 1`` diagonals and a right-hand side. Returns
    (DIAOperator, b tensor, nnz), nnz counting the entries inside the
    matrix."""
    offsets = list(range(-bandwidth, bandwidth + 1))
    A = banded_dia(m, n, offsets, seed=seed, dtype=dtype, device=device)
    rng = np.random.default_rng(seed + 1)
    b = torch.from_numpy(rng.standard_normal(m).astype(dtype)).to(resolve_device(device))
    i = np.arange(m)
    nnz = int(sum(((i + k >= 0) & (i + k < n)).sum() for k in offsets))
    return A, b, nnz


def random_coo_problem(m, n, nnz, *, seed=0, dtype=np.float32, device=None):
    """Uniformly random sparse COO problem (duplicates kept; the products
    sum them). Returns (COOOperator, b tensor)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    b = torch.from_numpy(rng.standard_normal(m).astype(dtype)).to(resolve_device(device))
    return coo_operator(m, n, vals, rows, cols, device=device), b


def block_banded_coo(m, n, block: int, band_blocks: int, *, seed=0,
                     dtype=np.float32, device=None):
    """Block-banded matrix as COO triplets: dense (block x block) blocks on
    the ``2*band_blocks + 1`` central block-diagonals. Returns (vals, rows,
    cols): numpy arrays, or tensors on ``device`` when one is given."""
    rng = np.random.default_rng(seed)
    mb, nb = m // block, n // block
    rows_l, cols_l, vals_l = [], [], []
    ii, jj = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    for rb in range(mb):
        for cb in range(max(0, rb - band_blocks), min(nb, rb + band_blocks + 1)):
            rows_l.append((rb * block + ii).ravel())
            cols_l.append((cb * block + jj).ravel())
            vals_l.append(rng.standard_normal(block * block).astype(dtype))
    out = tuple(np.concatenate(a) for a in (vals_l, rows_l, cols_l))
    if device is None:
        return out
    return tuple(torch.from_numpy(a).to(device) for a in out)


def _first(vals, rows, cols, n):
    """The triplets with only the first of each duplicate (row, col) kept,
    in row-major order."""
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    return vals[first], rows[first], cols[first]


def _add_diagonal(vals, rows, cols, m, n, diag):
    """The triplets plus ``diag`` on the main diagonal (summed into the
    entries there), in row-major order."""
    d = np.arange(min(m, n), dtype=np.int64)
    key = np.concatenate([rows * n + cols, d * n + d])
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.bincount(inv, weights=np.concatenate([vals, np.full(len(d), diag)]),
                         minlength=len(uniq)).astype(vals.dtype)
    return summed, uniq // n, uniq % n


def jittered_band_coo(m, n, *, nnz_per_row=6, spread=20, outliers=0.0, diag=0.0,
                      seed=0, dtype=np.float32):
    """A general sparse matrix with locality, the shape JDIA streams:
    ``nnz_per_row`` entries per row around the diagonals -37, -5, 0, 11 and
    52, each moved by up to ``spread`` columns, and an ``outliers`` share of
    entries moved to uniform random columns (the pattern of the JAX
    package's JDIA tests). Of duplicate entries the first is kept, then
    ``diag`` is added on the main diagonal. Returns numpy (vals, rows, cols), int64 indices."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), nnz_per_row)
    centers = rng.choice([-37, -5, 0, 11, 52], size=rows.size)
    cols = rows + centers + rng.integers(-spread, spread + 1, rows.size)
    n_out = int(outliers * rows.size)
    if n_out:
        idx = rng.choice(rows.size, n_out, replace=False)
        cols[idx] = rng.integers(0, n, n_out)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    rows, cols = _first(rows, rows, cols, n)[1:]
    vals = rng.standard_normal(rows.size).astype(dtype)
    if diag:
        vals, rows, cols = _add_diagonal(vals, rows, cols, m, n, diag)
    return vals, rows, cols


def random_block_coo(m, n, *, block=128, per_row=3, diag=0.0, seed=0,
                     dtype=np.float32):
    """A block-sparse matrix, the shape BlockELL streams: per block row r
    the block in block column r mod nb (the diagonal block when m <= n) and
    ``per_row - 1`` blocks at distinct random block columns, all dense
    with N(0, 1)/sqrt(block * per_row) entries, cut to m x n, with ``diag``
    added on the main diagonal. Returns numpy (vals, rows, cols), int64
    indices, in block order."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-m // block), -(-n // block)
    if per_row > nb:
        raise ValueError(f"{per_row} blocks per block row need {per_row} block columns")
    bcols = np.empty((mb, per_row), np.int64)
    for r in range(mb):
        own = r % nb  # the diagonal block, wrapped when m > n
        others = rng.choice(nb - 1, per_row - 1, replace=False)
        bcols[r] = [own, *(others + (others >= own))]
    br = np.repeat(np.arange(mb, dtype=np.int64), per_row)
    ii = np.repeat(np.arange(block, dtype=np.int64), block)
    jj = np.tile(np.arange(block, dtype=np.int64), block)
    rows = (br[:, None] * block + ii[None, :]).reshape(-1)
    cols = (bcols.reshape(-1)[:, None] * block + jj[None, :]).reshape(-1)
    vals = (rng.standard_normal(rows.size, dtype=np.float32)
            / np.sqrt(block * per_row)).astype(dtype)
    keep = (rows < m) & (cols < n)
    if not keep.all():
        vals, rows, cols = vals[keep], rows[keep], cols[keep]
    if diag:
        vals[rows == cols] += diag
    return vals, rows, cols


def zipf_coo(m, n, *, exponent=2.0, cap=2048, diag=8.0, seed=0, dtype=np.float32):
    """A power-law sparse matrix, the shape HYB serves: row i holds
    L_i = min(Zipf(exponent), cap) entries at uniform random columns,
    N(0, 1/L_i) values (each row's entries of unit norm), the first of
    duplicate entries kept, and ``diag`` added on the main diagonal.
    Returns numpy (vals, rows, cols), int64 indices."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(exponent, m), cap)
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    cols = rng.integers(0, n, rows.size)
    vals = (rng.standard_normal(rows.size) / np.sqrt(lengths[rows])).astype(dtype)
    vals, rows, cols = _first(vals, rows, cols, n)
    return _add_diagonal(vals, rows, cols, m, n, diag)
