"""Synthetic benchmark and test problems.

PyTorch counterpart of :mod:`lsqr_tpu.models.synthetic`. The values come
from numpy's generator, as in the JAX package, so both packages build the
same matrices and right-hand sides from one seed; ``device`` says where the
port's operator and vectors live.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.coo import COOOperator, coo_operator
from ..ops.structured import DIAOperator, dia_operator

__all__ = ["banded_problem", "random_coo_problem", "banded_dia", "block_banded_coo"]


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
    b = torch.from_numpy(rng.standard_normal(m).astype(dtype)).to(device)
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
    b = torch.from_numpy(rng.standard_normal(m).astype(dtype)).to(device)
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
