"""RWCOO: hot/cold column routing for wide unstructured sparsity.

PyTorch counterpart of :mod:`lsqr_tpu.ops.rwcoo`. The packer routes the
entries as JAX does: the top K <= 4096 columns by entry count (sorted, so
``hotmap`` stays monotone) go, renumbered, to an m x K WCOO panel (``hot``);
the rest stay at their columns in a WWCOO stream (``cold``, None when every
column is hot). The products compose the two kernels' wrappers
(:mod:`.spmv_wcoo`):

    u = WCOO_hot.forward(win[hotmap]) c1 - c2 y
    u = WWCOO_cold.forward(win) c1 + u          (pair: the cold pair, -> z_c)
    z = z_c + scatter(hotmap, WCOO_hot.adjoint(u))

The cold forward folds the hot part in through its ``-c2 y`` term with
c2 = -1. The hotmap gather and scatter are ``index_select`` and
``index_add_`` outside the kernels, as they are plain XLA ops outside the
Pallas kernels in JAX; the hotmap holds each column once, so the scatter
has no collisions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import as_dtype
from .coo import COOOperator, coo_operator
from .linop import LinearOperator, placement, to_numpy
from .spmv_wcoo import wcoo_adjoint, wcoo_forward, wwcoo_adjoint, wwcoo_forward, wwcoo_pair
from .wcoo import WCOOPacked, wcoo_pack
from .wwcoo import WWCOOPacked, WWCOOPackError, wwcoo_pack

__all__ = ["RWCOOOperator", "rwcoo_operator"]

#: widest hot panel the n <= 4096 WCOO kernels take
_K_HOT = 4096


@dataclasses.dataclass(frozen=True, eq=False)
class RWCOOOperator(LinearOperator):
    """Hot/cold column-routed general-sparsity operator (f32, wide n). On
    CUDA the products run the WCOO and WWCOO kernels, on the CPU their
    twins; ``prefers_pair`` is true where the kernels run."""

    hot: WCOOPacked                 # m x K compacted hot panel
    hotmap: torch.Tensor            # (K,) int32: the column of hot column j
    cold: Optional[WWCOOPacked]     # None when every column is hot
    coo: COOOperator
    n: int
    #: -1 on the device: the cold forward's c2, read by the kernel
    neg_one: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "neg_one", torch.tensor(-1.0, device=self.hotmap.device))

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.hot.m

    @property
    def dtype(self):
        return torch.float32

    @property
    def device(self):
        return self.hot.device

    @property
    def nnz(self) -> int:
        return self.coo.nnz

    @property
    def prefers_pair(self) -> bool:
        return self.hot.vals.is_cuda

    def _hot_win(self, win):
        return win.index_select(0, self.hotmap)

    def _fwd(self, win, c1, c2, y):
        """u = A(win*c1) - c2*y through the hot and cold streams."""
        u = wcoo_forward(self.hot, self._hot_win(win), c1, c2, y)
        if self.cold is not None:
            u = wwcoo_forward(self.cold, win, c1, self.neg_one, u)
        return u

    def _scatter_hot(self, z, u):
        # each column is in the hotmap once: every z entry takes at most one
        # addition, so this scatter has no order to fix (its bits are the
        # same in every run, atomics or not)
        return z.index_add_(0, self.hotmap, wcoo_adjoint(self.hot, u))

    def matvec(self, x):
        x = x.to(torch.float32)
        return self._fwd(x, 1.0, 0.0, x.new_zeros(0))

    def rmatvec(self, y):
        y = y.to(torch.float32)
        z = (wwcoo_adjoint(self.cold, y) if self.cold is not None
             else y.new_zeros(self.n))
        return self._scatter_hot(z, y)

    def fused_pair(self, *, y, win, c1, c2):
        """u = A(win*c1) - c2*y and z = A' u: the cold stream through its
        pair kernel, the hot entries streamed twice (forward, adjoint)."""
        y, win = y.to(torch.float32), win.to(torch.float32)
        u = wcoo_forward(self.hot, self._hot_win(win), c1, c2, y)
        if self.cold is not None:
            u, z = wwcoo_pair(self.cold, u, win, c1, self.neg_one)
        else:
            z = win.new_zeros(self.n)
        return u, self._scatter_hot(z, u)

    def todense(self):
        return self.coo.todense()


def rwcoo_operator(m, n, vals, rows, cols, *, dtype=None, device=None) -> RWCOOOperator:
    """Build an :class:`RWCOOOperator` from COO triplets (real f32,
    4096 < n <= 262,144), packed on the host and moved to ``device`` once
    (when None: the device of a tensor ``vals``, else the card).

    Routes the top-4096 columns by count through the WCOO hot panel and the
    rest through WWCOO. Raises :class:`~lsqr_tpu_torch.ops.wwcoo.WWCOOPackError`
    or :class:`~lsqr_tpu_torch.ops.wcoo.WCOOPackError` where JAX's packers
    refuse the pattern (a near-uniform wide pattern exceeds the cold
    work-list caps), for complex values and for dtype float64."""
    device = placement(vals, device)
    vals = to_numpy(vals)
    if np.iscomplexobj(vals):
        raise WWCOOPackError("RWCOO is real-only")
    if dtype is not None and as_dtype(dtype) == torch.float64:
        raise WWCOOPackError("RWCOO computes in f32; use COO for f64")
    if n <= _K_HOT:
        raise WWCOOPackError(f"n <= {_K_HOT} is the plain WCOO regime; RWCOO is for wide n")
    vals = vals.astype(np.float32)
    rows = to_numpy(rows).astype(np.int64, copy=False)
    cols = to_numpy(cols).astype(np.int64, copy=False)
    if vals.size == 0:
        raise WWCOOPackError("empty matrix")

    counts = np.bincount(cols, minlength=n)
    k_hot = min(_K_HOT, int((counts > 0).sum()))
    # the top-k columns by count, sorted so the hotmap stays monotone
    hotcols = np.sort(np.argpartition(counts, -k_hot)[-k_hot:])
    hotmask = np.zeros(n, bool)
    hotmask[hotcols] = True
    is_hot = hotmask[cols]
    hpos = np.full(n, -1, np.int64)
    hpos[hotcols] = np.arange(k_hot)

    hot = wcoo_pack(m, k_hot, vals[is_hot], rows[is_hot], hpos[cols[is_hot]], device=device)
    cold = None
    if (~is_hot).any():
        cold = wwcoo_pack(m, n, vals[~is_hot], rows[~is_hot], cols[~is_hot], device=device)
    coo = coo_operator(m, n, vals, rows, cols, dtype=torch.float32, device=device)
    return RWCOOOperator(hot=hot, hotmap=torch.from_numpy(hotcols.astype(np.int32)).to(device),
                         cold=cold, coo=coo, n=int(n))
