"""``LSQRSolver``: the class-style COO entry point (the reference's
``lsqr_solver_ez``, lsqr.f90:32-65). PyTorch counterpart of
:mod:`lsqr_tpu.api`, with a ``device=`` for where the operator lives.

Indexing is 0-based; validation follows the reference constructor
(lsqr.f90:109-111).
"""

from __future__ import annotations

from typing import Optional

from .config import LSQROptions
from .diagnostics import acheck, xcheck
from .ops.coo import coo_operator
from .ops.linop import LinearOperator
from .solver import LSQRResult, lsqr

__all__ = ["LSQRSolver"]


class LSQRSolver:
    """COO convenience solver. Example (the README 3x3 system)::

        solver = LSQRSolver(
            m=3, n=3,
            a=[1, 4, 7, 2, 5, 88, 3, 66, 9],
            irow=[0, 1, 2, 0, 1, 2, 0, 1, 2],
            icol=[0, 0, 0, 1, 1, 1, 2, 2, 2],
            dtype="float64",
        )
        result = solver.solve(b=[1.0, 2.0, 3.0])
        # result.istop == 1, result.x ~ [1.242424, -0.06060606, -0.04040404]

    Defaults follow the reference EZ class (lsqr.f90:46-51): atol = btol =
    conlim = 0 (machine precision), itnlim = 100.
    """

    def __init__(self, m: int, n: int, a, irow, icol, *, atol: float = 0.0,
                 btol: float = 0.0, conlim: float = 0.0, itnlim: int = 100,
                 dtype=None, device=None, **option_overrides):
        self.op: LinearOperator = coo_operator(m, n, a, irow, icol, dtype=dtype,
                                               device=device)
        self.m = int(m)
        self.n = int(n)
        self.options = LSQROptions(atol=atol, btol=btol, conlim=conlim,
                                   itnlim=itnlim, **option_overrides)

    def solve(self, b, damp: float = 0.0, *, x0=None,
              wantse: Optional[bool] = None, **option_overrides) -> LSQRResult:
        """Solve for one right-hand side (the reference's ``solve_ez``,
        lsqr.f90:207-259)."""
        opts = self.options
        if wantse is not None:
            opts = opts.replace(wantse=wantse)
        if option_overrides:
            opts = opts.replace(**option_overrides)
        return lsqr(self.op, b, damp, x0=x0, options=opts)

    def acheck(self, **kw):
        """Adjoint-consistency self-test of this operator (lsqr.f90:908-994)."""
        return acheck(self.op, **kw)

    def xcheck(self, b, x, damp=0.0, *, anorm, **kw):
        """Posterior classification of a computed solution
        (lsqr.f90:1015-1154)."""
        return xcheck(self.op, b=b, x=x, damp=damp, anorm=anorm, **kw)
