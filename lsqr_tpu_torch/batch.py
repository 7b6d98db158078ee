"""Batched solves: many right-hand sides against one operator.

PyTorch counterpart of :mod:`lsqr_tpu.batch`. JAX vmaps the whole loop; here
every problem is a row of (k, ·) tensors stepped together: each elementwise
step of the recurrence is one launch for all k problems, each problem keeps
its own istop and stops updating once it has stopped (the masked carry of
:func:`~lsqr_tpu_torch.solver._masked_step`, row by row), and the host reads
once a segment whether any problem still runs.

The operator's products are called once a row, on the product kernels the
standalone solve takes (the pair kernel, the half-step or the plain
products, on the same route rules), and every per-problem sum is one
reduction a row (:func:`~lsqr_tpu_torch.multidamp.row_ssq`). So column j
of a batched solve is bit for bit ``lsqr(A, B[j], damp[j])`` (``lsmr``,
``cgls``) on the same route. A product that reads the stripes once for all
k vectors would save bytes, but is a kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import tracing
from .cgls import CGLSResult
from .config import LSQROptions, as_dtype, default_dtype, real_dtype
from .lsmr import LSMRResult, check_complex_pair, sibling_tolerances
from .multidamp import (_Rows, build_lsmr_rows, build_lsqr_rows, reject_options,
                        solve_rows)
from .ops.linop import as_operator, as_tensor
from .solver import LSQRResult, lsqr_routes, resolve_pair

__all__ = ["lsqr_batch", "lsmr_batch", "cgls_batch"]


def _setup(A, B, damp, m, n, *, dtype=None, promote=False):
    """(operator, B in the working dtype, (k,) real damps). The working
    dtype is the standalone solvers': ``dtype`` when given, else B's
    promoted with A's (``promote``, lsqr's rule) or B's (the siblings'),
    ints taking the default float."""
    A = as_operator(A, m=m, n=n)
    B = as_tensor(B, device=A.device)
    if B.ndim != 2 or B.shape[1] != A.m:
        raise ValueError(f"B must have shape (batch, m={A.m}); got {tuple(B.shape)}")
    dtype = as_dtype(dtype) or (torch.promote_types(B.dtype, A.dtype or B.dtype) if promote
                                else B.dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = default_dtype()
    B = B.to(dtype)
    damps = as_tensor(damp, dtype=real_dtype(dtype), device=B.device)
    if damps.shape not in ((), (B.shape[0],)):
        raise ValueError(f"damp must be a number or one per problem ({B.shape[0]},); "
                         f"got shape {tuple(damps.shape)}")
    return A, B, damps.expand(B.shape[0]).clone()


@tracing.entry("lsqr_batch", rows="B")
def lsqr_batch(A, B, damp=0.0, *, options: Optional[LSQROptions] = None,
               m: Optional[int] = None, n: Optional[int] = None,
               **option_overrides) -> LSQRResult:
    """Solve ``min ||[A; damp_i I] x_i - [b_i; 0]||`` for every row b_i of B.

    Args:
      B: right-hand sides, shape (batch, m).
      damp: a number, or one per problem, shape (batch,).
      options / option_overrides: :class:`LSQROptions`, with the routes of
        :func:`~lsqr_tpu_torch.lsqr`; ``record_trace``, ``debug_log`` and
        ``megakernel`` raise ValueError.

    Returns an :class:`LSQRResult` whose fields carry a leading batch axis
    (x: (batch, n), istop: (batch,), ...). Each problem stops at its own
    iteration; the loop runs until the last one has stopped.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    reject_options(opts, "lsqr_batch")
    A, B, damps = _setup(A, B, damp, m, n, dtype=opts.dtype, promote=True)
    itnlim = opts.resolve_itnlim(A.n)
    fused, pair = lsqr_routes(A, opts)

    def scalar(v):  # the tolerances are real, also for complex problems
        return as_tensor(v, dtype=real_dtype(B.dtype), device=B.device)

    with tracing.span("prepare"):
        pieces = build_lsqr_rows(
            A, B, damps, scalar(opts.atol), scalar(opts.btol), scalar(opts.conlim),
            batched=True, itnlim=itnlim, wantse=opts.wantse, nconv=opts.nconv,
            safe_norms=opts.safe_norms, fused=fused, pair=pair,
            scalar_dtype=as_dtype(opts.scalar_dtype))
    return solve_rows(pieces, A=A, itnlim=itnlim, seg_len=opts.loop_segment)


@tracing.entry("lsmr_batch", rows="B")
def lsmr_batch(A, B, damp=0.0, *, atol: float = 1e-6, btol: float = 1e-6,
               conlim: float = 1e8, itnlim: Optional[int] = None, safe_norms: bool = True,
               loop: Optional[str] = None, loop_segment: int = 64,
               m: Optional[int] = None, n: Optional[int] = None,
               pair: Optional[bool] = None) -> LSMRResult:
    """Batched LSMR: every row of B at once, with the arguments and
    defaults of :func:`~lsqr_tpu_torch.lsmr` (``pair`` None: the operator's
    preference, as there). Result fields carry a leading batch axis."""
    A, B, damps = _setup(A, B, damp, m, n)
    atol, btol = sibling_tolerances(B.dtype, atol, btol)
    itnlim = int(itnlim) if itnlim is not None else min(A.m, A.n)
    pair = resolve_pair(A, pair, bool(getattr(A, "prefers_pair", False)))

    def scalar(v):
        return as_tensor(v, dtype=real_dtype(B.dtype), device=B.device)

    with tracing.span("prepare"):
        pieces = build_lsmr_rows(A, B, damps, scalar(atol), scalar(btol), scalar(conlim),
                                 batched=True, itnlim=itnlim, safe_norms=safe_norms,
                                 pair=pair)
    return solve_rows(pieces, A=A, itnlim=itnlim, seg_len=loop_segment)


class _CGLSRows(NamedTuple):
    itn: torch.Tensor     # (k,) and (k, ·) throughout
    istop: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    anorm: torch.Tensor
    rnorm: torch.Tensor
    ar: torch.Tensor      # A'r by recurrence (pair mode; (k, 1) otherwise)
    gmin: torch.Tensor
    xbest: torch.Tensor
    rbest: torch.Tensor


def _build_cgls_rows(A, B, damps, atol, btol, *, itnlim: int, safe_norms: bool, pair: bool):
    """(carry0, cond_fun, body_fun, finalize, shared) of CGLS over the rows
    of B: :func:`~lsqr_tpu_torch.cgls._build`'s operations in its order."""
    m, n = A.shape
    dtype = B.dtype
    rdtype = real_dtype(dtype)
    dev = B.device
    k = B.shape[0]
    check_complex_pair(A, dtype, pair)
    ops = _Rows(A, True)
    col = ops.col
    zero = torch.tensor(0.0, dtype=rdtype, device=dev)
    one = torch.tensor(1.0, dtype=rdtype, device=dev)
    izero = torch.zeros(k, dtype=torch.int32, device=dev)

    def norm(vec, side):
        return ops.norm(vec, safe_norms, side)

    # --- setup: r_0 = b, s_0 = A'r_0, p_0 = s_0 ----------------------------
    bnorm = norm(B, "m")
    s0 = torch.where(col(bnorm > zero), ops.rmatvec(B),
                     torch.zeros((k, n), dtype=dtype, device=dev))
    gnorm0 = norm(s0, "n")
    gamma0 = gnorm0 * gnorm0
    active0 = (bnorm > zero) & (gnorm0 > zero)

    carry0 = _CGLSRows(
        itn=izero, istop=izero, x=torch.zeros((k, n), dtype=dtype, device=dev), r=B, p=s0,
        gamma=gamma0, anorm=torch.zeros(k, dtype=rdtype, device=dev), rnorm=bnorm,
        ar=s0 if pair else torch.zeros((k, 1), dtype=dtype, device=dev),
        gmin=gamma0, xbest=torch.zeros((k, n), dtype=dtype, device=dev), rbest=bnorm,
    )

    def cond_fun(c):
        return (c.istop == 0) & active0

    def body_fun(c):
        itn = c.itn + 1

        if pair:
            q, t_adj = ops.fused_pair(c.r, c.p, one, zero)
        else:
            q = ops.matvec(c.p)
        qn = norm(q, "m")
        pn = norm(c.p, "n")
        delta = qn * qn + damps * damps * pn * pn
        safe_delta = torch.where(delta > zero, delta, one)
        alpha = torch.where(delta > zero, c.gamma / safe_delta, zero)

        x = c.x + col(alpha) * c.p
        r = c.r - col(alpha) * q
        safe_pn = torch.where(pn > zero, pn, one)
        anorm = torch.maximum(c.anorm, torch.where(pn > zero, qn / safe_pn, zero))

        if pair:
            ar = c.ar - col(alpha) * t_adj
            s = ar - col(damps * damps) * x
        else:
            ar = c.ar
            s = ops.rmatvec(r) - col(damps * damps) * x
        gnorm = norm(s, "n")
        gamma = gnorm * gnorm
        safe_gamma = torch.where(c.gamma > zero, c.gamma, one)
        beta = torch.where(c.gamma > zero, gamma / safe_gamma, zero)
        p = s + col(beta) * c.p

        xnorm = norm(x, "n")
        rn = norm(r, "m")
        rnorm = torch.sqrt(rn * rn + damps * damps * xnorm * xnorm)

        safe_bnorm = torch.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        denom2 = anorm * rnorm
        safe_d2 = torch.where(denom2 > zero, denom2, one)
        test2 = torch.where(denom2 > zero, gnorm / safe_d2, zero)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        istop = torch.zeros_like(c.istop)
        istop = torch.where(itn >= itnlim, 5, istop)
        istop = torch.where(delta <= zero, 4, istop)
        istop = torch.where(one + test2 <= one, 2, istop)
        istop = torch.where(one + test1 <= one, 1, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)

        # the noise-floor divergence guard (cgls._build)
        better = gamma < c.gmin
        gmin = torch.where(better, gamma, c.gmin)
        xbest = torch.where(col(better), x, c.xbest)
        rbest = torch.where(better, rnorm, c.rbest)
        finite = torch.isfinite(delta) & torch.isfinite(gamma) & torch.isfinite(rnorm)
        diverged = ~finite | (gamma > 1e8 * gmin)
        istop = torch.where(diverged, 6, istop)

        return _CGLSRows(itn=itn, istop=istop, x=x, r=r, p=p, gamma=gamma, anorm=anorm,
                         rnorm=rnorm, ar=ar, gmin=gmin, xbest=xbest, rbest=rbest)

    def finalize(final) -> CGLSResult:
        diverged = final.istop == 6
        x = torch.where(col(diverged), final.xbest, final.x)
        return CGLSResult(
            x=x, istop=final.istop, itn=final.itn,
            rnorm=torch.where(diverged, final.rbest, final.rnorm),
            arnorm=torch.sqrt(torch.where(diverged, final.gmin, final.gamma)),
            anorm=final.anorm, xnorm=ops.norm(x, safe_norms, "n"),
        )

    return carry0, cond_fun, body_fun, finalize, ()


@tracing.entry("cgls_batch", rows="B")
def cgls_batch(A, B, damp=0.0, *, atol: float = 1e-6, btol: float = 1e-6,
               itnlim: Optional[int] = None, safe_norms: bool = True,
               loop: Optional[str] = None, loop_segment: int = 64,
               m: Optional[int] = None, n: Optional[int] = None,
               pair: Optional[bool] = None) -> CGLSResult:
    """Batched CGLS: every row of B at once, with the arguments and
    defaults of :func:`~lsqr_tpu_torch.cgls` (pair mode opt-in, as there).
    Result fields carry a leading batch axis."""
    A, B, damps = _setup(A, B, damp, m, n)
    atol, btol = sibling_tolerances(B.dtype, atol, btol)
    itnlim = int(itnlim) if itnlim is not None else 4 * A.n
    pair = resolve_pair(A, pair, False)

    def scalar(v):
        return as_tensor(v, dtype=real_dtype(B.dtype), device=B.device)

    with tracing.span("prepare"):
        pieces = _build_cgls_rows(A, B, damps, scalar(atol), scalar(btol), itnlim=itnlim,
                                  safe_norms=safe_norms, pair=pair)
    return solve_rows(pieces, A=A, itnlim=itnlim, seg_len=loop_segment)
