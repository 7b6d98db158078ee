"""Bandwidth-reducing reordering: the planner in front of the general
sparse formats.

PyTorch counterpart of :mod:`lsqr_tpu.ops.reorder`. A reverse
Cuthill-McKee pass over the bipartite row-column graph recovers the
locality that JDIA and DIA stream, when an arbitrary numbering hides it.
LSQR is invariant under row and column permutations (the permuted problem
has the same norms, istop and iterations, with x = P_c' z), so the solve
runs in permuted space: the permutation is applied once to b on the way in
and once to x on the way out, never inside the iteration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["bandwidth_orders", "GeneralPlan", "plan_general", "solve_general"]


def bandwidth_orders(m, n, rows, cols):
    """Row and column orders that localize the pattern: reverse
    Cuthill-McKee over the bipartite (rows + cols) graph. Returns
    (row_order, col_order): ``row_order[i]`` is the new index of row i,
    ``col_order[j]`` that of column j. The identity for an empty pattern."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    ident = (np.arange(m), np.arange(n))
    if len(rows) == 0:
        return ident
    import scipy.sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    nv = m + n
    bi = scipy.sparse.coo_matrix((np.ones(len(rows), np.int8), (rows, m + cols)),
                                 shape=(nv, nv))
    bi = (bi + bi.T).tocsr()
    p = np.asarray(reverse_cuthill_mckee(bi, symmetric_mode=True))
    # rank of each vertex within its own side, in p order
    is_row = p < m
    row_rank = np.empty(m, np.int64)
    row_rank[p[is_row]] = np.arange(int(is_row.sum()))
    col_rank = np.empty(n, np.int64)
    col_rank[p[~is_row] - m] = np.arange(n)
    return row_rank, col_rank


class GeneralPlan:
    """A prepared general-sparsity solve: the reordered operator and the
    one-time permutations. Build it with :func:`plan_general` and reuse it
    for many right-hand sides (the pack and the reordering happen once)."""

    def __init__(self, op, row_order, col_order, m, n):
        self.op = op
        self.row_order = row_order      # new index of each original row
        self.col_order = col_order
        self.m = m
        self.n = n

    def _order(self, order, device):
        return torch.as_tensor(order, dtype=torch.int64, device=device)

    def permute_b(self, b):
        """b in the permuted row order, a tensor on the operator's device."""
        dev = self.op.device
        b = b.to(dev) if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.array(b, copy=True)).to(dev)
        return torch.empty_like(b).index_copy_(0, self._order(self.row_order, dev), b)

    def unpermute_x(self, x_perm):
        """x in the original column order, a tensor on the operator's
        device."""
        dev = self.op.device
        x_perm = torch.as_tensor(x_perm, device=dev)
        return x_perm[self._order(self.col_order, dev)]

    def solve(self, b, damp: float = 0.0, **opts):
        """Solve in permuted space; the LSQRResult's x (and se) come back in
        the original column order. The norm estimates, istop and itn do not
        depend on the permutations."""
        from ..solver import lsqr

        res = lsqr(self.op, self.permute_b(b), damp, **opts)
        out = res._replace(x=self.unpermute_x(res.x))
        if res.se is not None:
            out = out._replace(se=self.unpermute_x(res.se))
        return out


def plan_general(m, n, vals, rows, cols, *, reorder: Optional[bool] = None, dtype=None,
                 device=None) -> GeneralPlan:
    """Build a :class:`GeneralPlan` for COO triplets: reorder or not, then
    pick the storage format with :func:`~lsqr_tpu_torch.ops.interop.auto_operator`,
    on ``device`` (the card when None).

    ``reorder=None`` keeps the original order when its operator is DIA or
    a JDIA whose every entry fits, and otherwise packs both orders and keeps
    the better one, judged as JAX judges it: a JDIA operator by its slot-fit
    fraction, a packed ``DIAOperator`` as 1.5, anything else as 0 (so the
    shared-stripe layout of an f32 banded pattern scores 0, as in JAX).
    Where the original order takes JAX's WCOO/RWCOO route (not ported), it
    scores 0 as it does there; the plan raises that route's
    ``NotImplementedError`` only when the reordered operator does not win.
    True/False force the choice."""
    from ..config import resolve_device
    from .interop import auto_operator
    from .jdia import JDIAOperator
    from .linop import to_numpy
    from .structured import DIAOperator

    device = resolve_device(device)
    vals = to_numpy(vals)
    rows = np.ascontiguousarray(to_numpy(rows), np.int64)
    cols = np.ascontiguousarray(to_numpy(cols), np.int64)
    ident = (np.arange(m), np.arange(n))

    def build(ro, co):
        return auto_operator(m, n, vals, ro[rows], co[cols], dtype=dtype, device=device)

    if reorder is False:
        return GeneralPlan(build(*ident), *ident, m, n)
    ro, co = bandwidth_orders(m, n, rows, cols)
    if reorder:
        return GeneralPlan(build(ro, co), ro, co, m, n)

    def fitness(op):
        if isinstance(op, JDIAOperator):
            return op.fit_fraction
        return 1.5 if isinstance(op, DIAOperator) else 0.0

    try:
        plain = build(*ident)
    except NotImplementedError as exc:
        # JAX's WCOO/RWCOO (auto_operator step 3) scores 0 there too: the
        # reordered operator still wins when it scores above 0
        plain, not_ported = None, exc
    if plain is not None and fitness(plain) >= 1.0:
        return GeneralPlan(plain, *ident, m, n)
    reordered = build(ro, co)
    if fitness(reordered) > fitness(plain):
        return GeneralPlan(reordered, ro, co, m, n)
    if plain is None:
        raise not_ported
    return GeneralPlan(plain, *ident, m, n)


def solve_general(m, n, vals, rows, cols, b, damp: float = 0.0, *, device=None, **opts):
    """One-shot general-sparsity solve: reorder if it helps, pack, solve,
    and return the result with x in the original order."""
    return plan_general(m, n, vals, rows, cols, device=device).solve(b, damp, **opts)
