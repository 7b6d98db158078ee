"""Human-readable solver reports: the reference's ``nout`` printing
(lsqr.f90:589-595, 655-671, 813-837, 872-880).

PyTorch counterpart of :mod:`lsqr_tpu.utils.printing`, with the same
strings. The solver records its per-iteration log columns in a trace on the
device (``record_trace=True``); these helpers format it on the host in the
reference's listing style, with its print throttling rule (first and last
10 iterations, every 10th, near convergence, lsqr.f90:815-822)."""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

from ..ops.linop import to_numpy
from ..solver import ISTOP_MESSAGES, LSQRResult

__all__ = [
    "format_header",
    "format_iteration_log",
    "format_exit_block",
    "format_report",
    "format_summary",
]


def format_header(
    m: int,
    n: int,
    *,
    damp: float = 0.0,
    atol: float = 0.0,
    btol: float = 0.0,
    conlim: float = 0.0,
    itnlim: int = 0,
    wantse: bool = False,
) -> str:
    """The reference's named 'Enter LSQR' parameter-echo block
    (lsqr.f90:589-595): problem shape, damp, tolerances and limits, printed
    before the iteration log."""
    return (
        "\n Enter LSQR.       Least-squares solution of  Ax = b\n"
        f" The matrix  A  has{m:7d} rows   and{n:7d} columns\n"
        f" damp   = {damp: .14e}   wantse ={str(wantse).upper():>10s}\n"
        f" atol   = {atol: .2e}               conlim = {conlim: .2e}\n"
        f" btol   = {btol: .2e}               itnlim ={itnlim:10d}\n"
    )


def _throttle_mask(itns, itnlim, n):
    """The reference's print_iter rule (lsqr.f90:815-822), minus the
    tolerance-proximity terms (applied post-hoc to the recorded rows)."""
    last = itns.max() if len(itns) else 0
    return (
        (n <= 40)
        | (itns <= 10)
        | (itns >= itnlim - 10)
        | (itns % 10 == 0)
        | (itns >= last - 10)
    )


def format_iteration_log(
    result: LSQRResult,
    *,
    n: Optional[int] = None,
    itnlim: Optional[int] = None,
    damped: bool = False,
    throttle: bool = True,
) -> str:
    """Format the recorded trace as the reference's iteration listing
    (header at lsqr.f90:655-671; extra columns phi/dknorm/dxk/alfa_opt as
    with extra=.true., lsqr.f90:827-829)."""
    if result.trace is None:
        raise ValueError(
            "no trace recorded: solve with LSQROptions(record_trace=True)"
        )
    trace = to_numpy(result.trace)
    itn = int(result.itn)
    rows = trace[: itn + 1]
    out = io.StringIO()
    name = "Norm Abar Cond Abar" if damped else "   Norm A    Cond A"
    out.write(
        "   Itn       x(1)           Function     Compatible   LS   "
        + name
        + "        phi    dknorm      dxk  alfa_opt\n"
    )
    itns = rows[:, 0].astype(int)
    mask = (
        _throttle_mask(itns, itnlim or itn + 1, n or 0)
        if throttle
        else np.ones(len(rows), bool)
    )
    for row, keep in zip(rows, mask):
        if not keep:
            continue
        (it, x0, rnorm, t1, t2, anorm, acond, phi, dknorm, dxk, alfopt) = row
        out.write(
            f"{int(it):6d} {x0: .9e} {rnorm: .9e} {t1: .2e} {t2: .2e}"
            f" {anorm: .2e} {acond: .1e} {phi: .1e} {dknorm: .1e}"
            f" {dxk: .1e} {alfopt: .1e}\n"
        )
    return out.getvalue()


def format_exit_block(result: LSQRResult) -> str:
    """The reference's exit summary (lsqr.f90:872-880)."""
    istop = int(result.istop)
    xnorm = float(result.xnorm)
    dxmax = float(result.dxmax)
    lines = [
        f" Exit  LSQR.      istop  ={istop:3d}               itn    ={int(result.itn):9d}",
        f" Exit  LSQR.      anorm  ={float(result.anorm): .5e}     acond  ={float(result.acond): .5e}",
        f" Exit  LSQR.      bnorm  ={float(result.bnorm): .5e}     xnorm  ={xnorm: .5e}",
        f" Exit  LSQR.      rnorm  ={float(result.rnorm): .5e}     arnorm ={float(result.arnorm): .5e}",
        f" Exit  LSQR.      max dx ={dxmax: .1e}  occurred at itn {int(result.maxdx):9d}",
        f" Exit  LSQR.             ={dxmax / (xnorm + 1e-20): .1e}  *xnorm",
        f" Exit  LSQR.      {ISTOP_MESSAGES[istop]}",
    ]
    return "\n".join(lines) + "\n"


def format_summary(result) -> str:
    """Solver-generic exit summary: works for any solver's result
    NamedTuple (LSQRResult, LSMRResult, CRAIGResult, CGLSResult) by
    introspecting its scalar fields; the solver name is derived from the
    result type. For the reference's exact LIS exit block use
    :func:`format_exit_block` (LSQR only)."""
    name = type(result).__name__.replace("Result", "")
    skip = {"x", "se", "trace", "istop", "itn"}
    lines = [
        f" Exit  {name}.      istop  ={int(result.istop):3d}"
        f"               itn    ={int(result.itn):9d}"
    ]
    pairs = []
    for field in result._fields:
        if field in skip:
            continue
        v = getattr(result, field)
        if v is None or getattr(v, "ndim", 0) != 0:
            continue
        pairs.append((field, float(v)))
    for i in range(0, len(pairs), 2):
        row = "".join(
            f"{k:<7s}={v: .5e}     " for k, v in pairs[i:i + 2]
        ).rstrip()
        lines.append(f" Exit  {name}.      {row}")
    msg = getattr(result, "istop_message", None)
    if msg is not None:
        lines.append(f" Exit  {name}.      {msg}")
    return "\n".join(lines) + "\n"


def format_report(
    result: LSQRResult,
    *,
    m: Optional[int] = None,
    header_params: Optional[dict] = None,
    **log_kwargs,
) -> str:
    """Full LIS-style report: parameter-echo header (when the problem shape
    is given), iteration log (if recorded), exit block.

    Args:
      m: row count of A; together with ``n`` (a log kwarg) enables the
        header block.
      header_params: optional dict of damp/atol/btol/conlim/itnlim/wantse
        forwarded to :func:`format_header`.
    """
    parts = []
    n = log_kwargs.get("n")
    if m is not None and n is not None:
        parts.append(format_header(m, n, **(header_params or {})))
    if result.trace is not None:
        parts.append(format_iteration_log(result, **log_kwargs))
    parts.append(format_exit_block(result))
    return "\n".join(parts)
