"""Multi-damp LSQR and LSMR: a whole regularization path from one
Golub–Kahan bidiagonalization.

PyTorch counterpart of :mod:`lsqr_tpu.multidamp`. The bidiagonalization
(the two products and the alpha/beta recurrence, lsqr.f90:681-699) depends
only on ``(A, b)``: damp enters at the damp rotation (lsqr.f90:703-710) and
what follows it. So one product pair an iteration (one launch of the pair
kernel on the card) serves all k damps of

    min || [A; damp_j I] x - [b; 0] ||        for j = 1..k,

and each damp carries only its own rows of x and w (LSMR: h, hbar and x)
and its own scalars; a damp that has stopped keeps its state while the
others run on.

Each damp's iterates are those of a standalone solve with that damp, bit
for bit: the shared quantities take the standalone solve's operations, the
per-damp ones the same elementwise operations over (k,) and (k, n)
tensors, and every per-damp sum of squares is one reduction a row
(:func:`row_ssq`), which sums in the order of the standalone solve's
reduction. A reduction over the last axis of the whole (k, n) tensor
orders its sums otherwise.

The loop is the solvers' host-stepped segments
(:func:`~lsqr_tpu_torch.solver._run_segments`), with one host read a
segment of whether any damp still runs.

The machinery over rows here (:func:`row_ssq`, :class:`_Rows`, the two
builders with ``batched=True``) also carries ``lsqr_batch`` and
``lsmr_batch`` (:mod:`.batch`), where each row is a problem of its own: its
own b, damp and bidiagonalization, the products called once a row.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from . import tracing
from .config import LSQROptions, as_dtype, default_dtype, real_dtype
from .lsmr import LSMRResult, _sym_ortho, check_complex_pair, sibling_tolerances, solve_dtype
from .ops.blas import abs2, all_max, all_sum, d2norm, nrm2
from .ops.linop import as_operator, as_tensor
from .solver import LSQRResult, _run_segments, lsqr_routes, resolve_pair

__all__ = ["lsqr_multidamp", "lsmr_multidamp"]


def _standalone(row: torch.Tensor) -> torch.Tensor:
    """A row as a standalone vector would lie: a row off the 64-byte grid
    is copied. CUDA's reduction loads vectors of 4 elements and sums a
    misaligned head apart, so such a row's sum (f32 off 16 bytes, f64 off
    32) came out otherwise on the H100."""
    return row if row.data_ptr() % 64 == 0 else row.clone()


def row_sums(mat: torch.Tensor) -> torch.Tensor:
    """The sum of each row of a (k, ·) tensor, one reduction a row, so each
    row sums in the order a 1-D tensor's sum takes."""
    return torch.stack([_standalone(row).sum() for row in mat])


def row_ssq(mat: torch.Tensor):
    """(|mat|^2, the sum of each row's), each row's as a standalone
    vector's. Real rows: one product for all, one reduction a row. Complex
    rows: one product a row too, since the CPU rounds a complex product in
    its SIMD lanes otherwise than in a loop's scalar tail, and a complex
    vector's |x|^2 is a strided view of the real parts, which reduces in an
    order of its own."""
    if not mat.is_complex():
        sq = abs2(mat)
        return sq, row_sums(sq)
    sqs = [abs2(_standalone(row)) for row in mat]
    return torch.stack(sqs), torch.stack([sq.sum() for sq in sqs])


def _row_nrm2(mat: torch.Tensor, *, safe: bool, group=None) -> torch.Tensor:
    """Row-wise Euclidean norms of a (k, ·) tensor: :func:`~.ops.blas.nrm2`
    of each row, with the same overflow-safe scaling (complex rows give
    real norms; their moduli one row at a time, as in :func:`row_ssq`) and
    the sums of squares taken by :func:`row_ssq`; with ``group``, of rows
    split over its ranks, as ``nrm2``'s."""
    if safe:
        if mat.is_complex():
            amax = torch.stack([row.abs().amax() for row in mat])
        else:
            amax = mat.abs().amax(dim=-1)
        amax = all_max(amax, group)
        one = torch.ones((), dtype=amax.dtype, device=mat.device)
        scale = torch.where(amax > 0, amax, one)
        ssq = all_sum(row_ssq(mat / scale[:, None])[1], group)
        return torch.where(amax > 0, scale * ssq.sqrt(), torch.zeros_like(amax))
    return all_sum(row_ssq(mat)[1], group).sqrt()


class _Rows:
    """The products and reductions of a solve over rows: on one vector and
    its 0-d scalars (``batched=False``, the bidiagonalization that the
    damps of a multi-damp solve share) or on each row of a (k, ·) tensor
    and its (k,) scalars (``batched=True``), one product call a row."""

    def __init__(self, A, batched: bool):
        self.A, self.batched = A, batched
        # the distribution hooks (ops/linop.py), by the vectors' side
        self.groups = dict(m=getattr(A, "axis_name_m", None),
                           n=getattr(A, "axis_name_n", None))

    def col(self, s):
        """A scalar of the bidiagonalization against its vector(s)."""
        return s[:, None] if self.batched else s

    def norm(self, vec, safe: bool, side: str):
        """The norm of an m-vector (``side`` "m") or n-vector ("n"), or of
        each row."""
        group = self.groups[side]
        if self.batched:
            return _row_nrm2(vec, safe=safe, group=group)
        return nrm2(vec, safe=safe, group=group)

    def ssq(self, vec, side: str):
        """The sum of squares (of moduli) of the vector or of each row."""
        return all_sum(row_ssq(vec)[1] if self.batched else torch.sum(abs2(vec)),
                       self.groups[side])

    def _each(self, fn, *args):
        """fn on each row's slice of args (scalars broadcast to the rows),
        its outputs stacked."""
        k = args[0].shape[0]
        rows = [a.expand(k) if a.dim() == 0 else a for a in args]
        outs = [fn(*(a[j] for a in rows)) for j in range(k)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(t) for t in zip(*outs))
        return torch.stack(outs)

    def matvec(self, v):
        return self._each(self.A.matvec, v) if self.batched else self.A.matvec(v)

    def rmatvec(self, u):
        return self._each(self.A.rmatvec, u) if self.batched else self.A.rmatvec(u)

    def fused_pair(self, y, win, c1, c2):
        def pair(y, win, c1, c2):
            return self.A.fused_pair(y=y, win=win, c1=c1, c2=c2)

        return self._each(pair, y, win, c1, c2) if self.batched else pair(y, win, c1, c2)

    def fused_halfstep(self, forward, y, win, c1, c2):
        def half(y, win, c1, c2):
            return self.A.fused_halfstep(forward=forward, y=y, win=win, c1=c1, c2=c2)

        return self._each(half, y, win, c1, c2) if self.batched else half(y, win, c1, c2)


#: the fields of a multi-damp carry that all damps share
SHARED = ("itn", "u", "v", "alpha", "beta")


def _rows_step(c, cond_fun, body_fun, *, shared):
    """One masked iteration over rows (``_masked_step``'s form): a row's
    fields keep their values where its solve has stopped, the ``shared``
    fields where every row's has."""
    active = cond_fun(c)
    new = body_fun(c)
    anyone = active.any()
    out = []
    for name, a, b in zip(c._fields, new, c):
        if a is not b:
            mask = anyone if name in shared else active.view(-1, *[1] * (a.dim() - 1))
            a = torch.where(mask, a, b)
        out.append(a)
    return type(c)(*out)


def solve_rows(pieces, *, A, itnlim: int, seg_len: int):
    """Run the pieces of a builder over rows on operator ``A`` in segments:
    one blocking host read a segment of (every row stopped, iterations
    run), and the same head of each step read without blocking."""
    carry0, cond_fun, body_fun, finalize, shared = pieces

    def head(c):
        return torch.stack([(~cond_fun(c)).all().to(torch.int32), c.itn.max()])

    final = _run_segments(carry0, cond_fun, body_fun, A=A, itnlim=itnlim, seg_len=seg_len,
                          step=partial(_rows_step, shared=shared), head=head)
    with tracing.span("finalize"):
        return finalize(final)


def _per_row(s, k):
    """A shared scalar or vector as k rows (a copy)."""
    return s.expand(k, *s.shape).clone()


class _LSQRRows(NamedTuple):
    itn: torch.Tensor      # () shared, or (k,) batched
    u: torch.Tensor        # (m,) shared, or (k, m)
    v: torch.Tensor        # (n,) shared, or (k, n)
    alpha: torch.Tensor
    beta: torch.Tensor
    istop: torch.Tensor    # (k,) from here on
    nstop: torch.Tensor
    itn_d: torch.Tensor    # the iteration each row stopped at
    x: torch.Tensor        # (k, n)
    w: torch.Tensor        # (k, n)
    se: torch.Tensor       # (k, n) or (k, 1)
    rhobar: torch.Tensor
    phibar: torch.Tensor
    psi: torch.Tensor
    res2: torch.Tensor
    anorm: torch.Tensor
    dnorm: torch.Tensor
    dxmax: torch.Tensor
    maxdx: torch.Tensor
    xnorm: torch.Tensor
    xnorm1: torch.Tensor
    cs2: torch.Tensor
    sn2: torch.Tensor
    z: torch.Tensor
    acond: torch.Tensor
    rnorm: torch.Tensor
    arnorm: torch.Tensor


def build_lsqr_rows(A, b, damps, atol, btol, conlim, *, batched: bool, itnlim: int,
                    wantse: bool, nconv: int, safe_norms: bool, fused: bool = False,
                    pair: bool = False, scalar_dtype: Optional[torch.dtype] = None):
    """(carry0, cond_fun, body_fun, finalize, shared) of LSQR over k rows:
    :func:`~lsqr_tpu_torch.solver._build`'s operations in its order, with a
    leading (k,) axis on every per-row quantity. ``batched=False``: b is
    (m,) and the k damps share its bidiagonalization (``lsqr_multidamp``);
    ``batched=True``: b is (k, m), each row with its own bidiagonalization
    and damp (``lsqr_batch``). ``fused``/``pair`` are the solver's routes
    (the unnormalized carry; the half-step or the pair kernel)."""
    m, n = A.shape
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    is_complex = dtype.is_complex
    dev = b.device
    k = damps.shape[0]
    sdtype = scalar_dtype if scalar_dtype is not None else rdtype
    mixed = sdtype != rdtype
    if fused and mixed:
        raise ValueError(
            "the pair and half-step kernels compute in f32 and cannot carry a wider "
            "scalar_dtype; set pair=False (and fused=False) for the mixed-precision mode")
    if is_complex and (fused or pair) and not (
            pair and getattr(A, "supports_complex_pair", False)):
        raise ValueError("fused/pair half-step kernels are real-f32 only; "
                         "set fused=False, pair=False for complex operators")
    ops = _Rows(A, batched)
    col = ops.col

    def sc(s):  # scalar -> recurrence precision
        return s.to(sdtype) if mixed else s

    def vc(s):  # scalar -> vector-op precision; real scalars stay real
        return s.to(rdtype) if mixed else s

    def const(v, dt=sdtype):
        return torch.tensor(v, dtype=dt, device=dev)

    def rows(s):  # a per-row quantity from the bidiagonalization's
        return s if batched else _per_row(s, k)

    zero = const(0.0)
    one = const(1.0)
    damps, atol, btol, conlim = sc(damps), sc(atol), sc(btol), sc(conlim)

    def norm(vec, side):
        return sc(ops.norm(vec, safe_norms, side))

    damped = damps > zero
    ctol = torch.where(conlim > zero, one / torch.where(conlim > zero, conlim, one), zero)

    # --- setup: beta*u = b, alpha*v = A'u (lsqr.f90:619-646) -------------
    u0 = b
    beta0 = norm(u0, "m")
    safe_beta0 = torch.where(beta0 > zero, beta0, one)
    u0_norm = torch.where(col(beta0 > zero), u0 / col(vc(safe_beta0)), u0)
    v0u = torch.where(col(beta0 > zero), ops.rmatvec(u0_norm),
                      torch.zeros(b.shape[:-1] + (n,), dtype=dtype, device=dev))
    alpha0 = torch.where(beta0 > zero, norm(v0u, "n"), zero)
    safe_alpha0 = torch.where(alpha0 > zero, alpha0, one)
    v0_norm = torch.where(col(alpha0 > zero), v0u / col(vc(safe_alpha0)), v0u)
    u0c, v0c = (u0, v0u) if fused else (u0_norm, v0_norm)
    arnorm0 = alpha0 * beta0
    bnorm = beta0

    izero = torch.zeros(k, dtype=torch.int32, device=dev)
    zeros = torch.zeros(k, dtype=sdtype, device=dev)
    carry0 = _LSQRRows(
        itn=izero if batched else const(0, torch.int32),
        u=u0c, v=v0c, alpha=alpha0, beta=beta0,
        istop=izero, nstop=izero, itn_d=izero,
        x=torch.zeros((k, n), dtype=dtype, device=dev), w=rows(v0_norm),
        se=torch.zeros((k, n if wantse else 1), dtype=rdtype, device=dev),
        rhobar=rows(alpha0), phibar=rows(beta0), psi=zeros, res2=zeros,
        anorm=zeros, dnorm=zeros, dxmax=zeros, maxdx=izero, xnorm=zeros,
        xnorm1=zeros, cs2=-torch.ones(k, dtype=sdtype, device=dev), sn2=zeros, z=zeros,
        acond=zeros, rnorm=rows(beta0), arnorm=rows(arnorm0),
    )

    def cond_fun(c):
        return (c.istop == 0) & (arnorm0 != zero)

    def body_fun(c):
        itn = c.itn + 1

        # --- bidiagonalization step (lsqr.f90:681-699) -----------------
        if fused:
            inv_alpha_prev = torch.where(
                c.alpha > zero, one / torch.where(c.alpha > zero, c.alpha, one), zero)
            inv_beta_prev = torch.where(
                c.beta > zero, one / torch.where(c.beta > zero, c.beta, one), zero)
            if pair:
                u, z_adj = ops.fused_pair(c.u, c.v, inv_alpha_prev,
                                          c.alpha * inv_beta_prev)
                ssq_u = ops.ssq(u, "m")
            else:
                u, ssq_u = ops.fused_halfstep(True, c.u, c.v, inv_alpha_prev,
                                              c.alpha * inv_beta_prev)
            beta = torch.sqrt(ssq_u).to(rdtype)
            temp = d2norm(c.alpha, beta)
            temp = d2norm(temp, damps)
            anorm = d2norm(c.anorm, temp)
            beta_pos = beta > zero
            inv_beta = torch.where(beta_pos, one / torch.where(beta_pos, beta, one), zero)
            if pair:
                v_cand = z_adj * col(vc(inv_beta)) - col(vc(beta * inv_alpha_prev)) * c.v
                ssq_v = ops.ssq(v_cand, "n")
            else:
                v_cand, ssq_v = ops.fused_halfstep(False, c.v, u, inv_beta,
                                                   beta * inv_alpha_prev)
            alpha_cand = torch.sqrt(ssq_v).to(rdtype)
            v = torch.where(col(beta_pos), v_cand, c.v)
            alpha = torch.where(beta_pos, alpha_cand, c.alpha)
            inv_alpha_new = torch.where(
                alpha > zero, one / torch.where(alpha > zero, alpha, one), one)
            v_for_w = v * col(inv_alpha_new)
        else:
            u = ops.matvec(c.v) - col(vc(c.alpha)) * c.u
            beta = norm(u, "m")
            temp = d2norm(c.alpha, beta)
            temp = d2norm(temp, damps)
            anorm = d2norm(c.anorm, temp)
            beta_pos = beta > zero
            safe_beta = torch.where(beta_pos, beta, one)
            u = torch.where(col(beta_pos), u / col(vc(safe_beta)), u)
            v_cand = ops.rmatvec(u) - col(vc(beta)) * c.v
            alpha_cand = norm(v_cand, "n")
            alpha_pos = alpha_cand > zero
            safe_alpha = torch.where(alpha_pos, alpha_cand, one)
            v_cand = torch.where(col(alpha_pos), v_cand / col(vc(safe_alpha)), v_cand)
            v = torch.where(col(beta_pos), v_cand, c.v)
            alpha = torch.where(beta_pos, alpha_cand, c.alpha)
            v_for_w = v

        # --- per-row rotations (lsqr.f90:703-721) ------------------------
        rhbar1_d = d2norm(c.rhobar, damps)
        safe_rhbar1 = torch.where(rhbar1_d > zero, rhbar1_d, one)
        cs1 = c.rhobar / safe_rhbar1
        sn1 = damps / safe_rhbar1
        psi = torch.where(damped, sn1 * c.phibar, c.psi)
        phibar = torch.where(damped, cs1 * c.phibar, c.phibar)
        rhbar1 = torch.where(damped, rhbar1_d, c.rhobar)

        rho = d2norm(rhbar1, beta)
        safe_rho = torch.where(rho > zero, rho, one)
        cs = rhbar1 / safe_rho
        sn = beta / safe_rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # --- per-row x/w/se update (lsqr.f90:724-745) ---------------------
        t1 = phi / safe_rho
        t2 = -theta / safe_rho
        t3 = one / safe_rho
        t = c.w
        x = vc(t1)[:, None] * t + c.x
        w = vc(t2)[:, None] * t + v_for_w
        dk2, dk2_sums = row_ssq(vc(t3)[:, None] * t)
        dknorm = torch.sqrt(sc(all_sum(dk2_sums, ops.groups["n"])))
        se = c.se + dk2 if wantse else c.se

        # --- cancellation monitor (lsqr.f90:747-757) ---------------------
        dnorm = d2norm(c.dnorm, dknorm)
        dxk = torch.abs(phi * dknorm)
        new_max = c.dxmax < dxk
        dxmax = torch.where(new_max, dxk, c.dxmax)
        maxdx = torch.where(new_max, itn, c.maxdx)

        # --- right rotation: xnorm estimator (lsqr.f90:759-771) ----------
        delta = c.sn2 * rho
        gambar = -c.cs2 * rho
        rhs = phi - delta * c.z
        safe_gambar = torch.where(gambar != zero, gambar, one)
        zbar = rhs / safe_gambar
        xnorm = d2norm(c.xnorm1, zbar)
        gamma = d2norm(gambar, theta)
        safe_gamma = torch.where(gamma > zero, gamma, one)
        cs2 = gambar / safe_gamma
        sn2 = theta / safe_gamma
        z = rhs / safe_gamma
        xnorm1 = d2norm(c.xnorm1, z)

        # --- norm/condition estimates (lsqr.f90:773-790) ------------------
        acond = anorm * dnorm
        res2 = d2norm(c.res2, psi)
        rnorm = d2norm(res2, phibar)
        arnorm = alpha * torch.abs(tau)

        safe_bnorm = torch.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        test2 = torch.where(
            rnorm > zero, arnorm / torch.where(rnorm > zero, anorm * rnorm, one), zero)
        safe_acond = torch.where(acond > zero, acond, one)
        test3 = one / safe_acond
        t1_rel = test1 / (one + anorm * xnorm / safe_bnorm)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        # --- stopping tests (lsqr.f90:798-810), per row ------------------
        istop = torch.zeros_like(c.istop)
        istop = torch.where(itn >= itnlim, 5, istop)
        istop = torch.where(one + test3 <= one, 4, istop)
        istop = torch.where(one + test2 <= one, 2, istop)
        istop = torch.where(one + t1_rel <= one, 1, istop)
        istop = torch.where(test3 <= ctol, 4, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)

        # --- nconv consecutive-hit logic (lsqr.f90:843-850) --------------
        nstop = torch.where(istop == 0, 0, c.nstop + 1)
        istop = torch.where((istop != 0) & (nstop < nconv) & (itn < itnlim), 0, istop)

        return _LSQRRows(
            itn=itn, u=u, v=v, alpha=alpha, beta=beta,
            istop=istop, nstop=nstop, itn_d=itn.expand_as(c.itn_d),
            x=x, w=w, se=se, rhobar=rhobar, phibar=phibar, psi=psi, res2=res2,
            anorm=anorm, dnorm=dnorm, dxmax=dxmax, maxdx=maxdx, xnorm=xnorm,
            xnorm1=xnorm1, cs2=cs2, sn2=sn2, z=z, acond=acond, rnorm=rnorm,
            arnorm=arnorm,
        )

    def finalize(final) -> LSQRResult:
        # --- standard errors (lsqr.f90:857-865) --------------------------
        se_out = None
        if wantse:  # of the whole problem: a shard's m and n are its own
            gm = int(getattr(A, "global_m", m))
            gn = int(getattr(A, "global_n", n))
            t_static = float(gm - gn) if gm > gn else 1.0
            t = torch.where(damped, const(float(gm)), const(t_static))
            t = final.rnorm / torch.sqrt(t)
            se_out = vc(t)[:, None] * torch.sqrt(final.se)
        # damped istop 2 -> 3 (lsqr.f90:871)
        istop = torch.where(damped & (final.istop == 2), 3, final.istop)
        return LSQRResult(
            x=final.x, istop=istop, itn=final.itn_d, anorm=final.anorm,
            acond=final.acond, rnorm=final.rnorm, arnorm=final.arnorm,
            xnorm=final.xnorm, bnorm=rows(bnorm), se=se_out, dxmax=final.dxmax,
            maxdx=final.maxdx, trace=None,
        )

    return carry0, cond_fun, body_fun, finalize, () if batched else SHARED


def reject_options(opts: LSQROptions, name: str) -> None:
    """The options that solves over rows do not take."""
    if opts.record_trace or opts.debug_log:
        raise ValueError(f"record_trace/debug_log are not supported by {name}; "
                         "run lsqr per problem for logging")
    if opts.megakernel:
        raise ValueError(f"{name} takes no megakernel route; set megakernel=False")


@tracing.entry("lsqr_multidamp", rows="damps", rows_by_length=True)
def lsqr_multidamp(A, b, damps, *, options: Optional[LSQROptions] = None,
                   m: Optional[int] = None, n: Optional[int] = None,
                   **option_overrides) -> LSQRResult:
    """Solve ``min ||[A; damp_j I] x - [b; 0]||`` for a vector of k damp
    values from one shared bidiagonalization.

    The two products an iteration (one pair-kernel launch on the pair
    route) serve all k problems; each damp carries its own (k, n) rows of x
    and w. Each damp's result is bit for bit that of ``lsqr(A, b, damp_j)``
    on the same product route (``pair=True``, or ``pair=False`` with
    ``fused=False``: the plain products, as in the JAX package, which has
    no half-step route here).

    Args:
      A: a LinearOperator, a dense 2-D array or tensor, or a
        (matvec, rmatvec) tuple with ``m``/``n``.
      b: right-hand side (m,).
      damps: k non-negative damping values (any order; a number is one).
      options / option_overrides: :class:`LSQROptions`. ``pair`` and
        ``scalar_dtype`` are taken; ``record_trace``, ``debug_log`` and
        ``megakernel`` raise ValueError.

    Returns an :class:`LSQRResult` whose fields carry a leading (k,) axis:
    ``x`` is (k, n), ``se`` (k, n) with ``wantse``; ``trace`` is None.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    reject_options(opts, "lsqr_multidamp")
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = as_dtype(opts.dtype) or torch.promote_types(b.dtype, A.dtype or b.dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = default_dtype()
    b = b.to(dtype)
    damps = _damps(damps, dtype, b.device)
    if b.ndim != 1 or (getattr(A, "axis_name_m", None) is None and b.shape[0] != A.m):
        raise ValueError(f"b must be a vector of length m = {A.m}; got shape {tuple(b.shape)}")
    itnlim = opts.resolve_itnlim(A.n)
    _, pair = lsqr_routes(A, opts)  # no half-step route here, as in the JAX package

    def scalar(v):  # damp and the tolerances are real, also for complex problems
        return as_tensor(v, dtype=real_dtype(dtype), device=b.device)

    with tracing.span("prepare"):
        pieces = build_lsqr_rows(
            A, b, damps, scalar(opts.atol), scalar(opts.btol), scalar(opts.conlim),
            batched=False, itnlim=itnlim, wantse=opts.wantse, nconv=opts.nconv,
            safe_norms=opts.safe_norms, fused=pair, pair=pair,
            scalar_dtype=as_dtype(opts.scalar_dtype))
    return solve_rows(pieces, A=A, itnlim=itnlim, seg_len=opts.loop_segment)


def _damps(damps, dtype, device) -> torch.Tensor:
    """A non-empty 1-D tensor of real damps (a number is one damp)."""
    damps = torch.atleast_1d(as_tensor(damps, dtype=real_dtype(dtype), device=device))
    if damps.ndim != 1 or damps.shape[0] == 0:
        raise ValueError("damps must be a non-empty 1-D array of damping values")
    return damps


# ---------------------------------------------------------------------------
# LSMR over rows: damp enters LSMR only through the Phat rotation
# ---------------------------------------------------------------------------


class _LSMRRows(NamedTuple):
    itn: torch.Tensor      # () shared, or (k,) batched
    u: torch.Tensor
    v: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    istop: torch.Tensor    # (k,) from here on
    itn_d: torch.Tensor
    h: torch.Tensor        # (k, n)
    hbar: torch.Tensor     # (k, n)
    x: torch.Tensor        # (k, n)
    alphabar: torch.Tensor
    rho: torch.Tensor
    rhobar: torch.Tensor
    cbar: torch.Tensor
    sbar: torch.Tensor
    zeta: torch.Tensor
    zetabar: torch.Tensor
    betadd: torch.Tensor
    betad: torch.Tensor
    rhodold: torch.Tensor
    tautildeold: torch.Tensor
    thetatilde: torch.Tensor
    d: torch.Tensor
    norma2: torch.Tensor
    maxrbar: torch.Tensor
    minrbar: torch.Tensor
    normr: torch.Tensor
    normar: torch.Tensor
    norma: torch.Tensor
    conda: torch.Tensor
    normx: torch.Tensor


def build_lsmr_rows(A, b, damps, atol, btol, conlim, *, batched: bool, itnlim: int,
                    safe_norms: bool, pair: bool = False):
    """(carry0, cond_fun, body_fun, finalize, shared) of LSMR over k rows:
    :func:`~lsqr_tpu_torch.lsmr._build`'s operations in its order, with a
    leading (k,) axis on every per-row quantity (``batched`` as in
    :func:`build_lsqr_rows`)."""
    m, n = A.shape
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    dev = b.device
    k = damps.shape[0]
    check_complex_pair(A, dtype, pair)
    ops = _Rows(A, batched)
    col = ops.col

    def const(v, dt=rdtype):
        return torch.tensor(v, dtype=dt, device=dev)

    def rows(s):
        return s if batched else _per_row(s, k)

    zero = const(0.0)
    one = const(1.0)
    ones = torch.ones(k, dtype=rdtype, device=dev)
    zeros = torch.zeros(k, dtype=rdtype, device=dev)

    def norm(vec, side):
        return ops.norm(vec, safe_norms, side)

    ctol = torch.where(conlim > zero, one / torch.where(conlim > zero, conlim, one), zero)

    # --- setup: beta u = b, alpha v = A'u ---------------------------------
    normb = norm(b, "m")
    beta0 = normb
    safe_beta0 = torch.where(beta0 > zero, beta0, one)
    u0 = torch.where(col(beta0 > zero), b / col(safe_beta0), b)
    v0u = torch.where(col(beta0 > zero), ops.rmatvec(u0),
                      torch.zeros(b.shape[:-1] + (n,), dtype=dtype, device=dev))
    alpha0 = torch.where(beta0 > zero, norm(v0u, "n"), zero)
    safe_alpha0 = torch.where(alpha0 > zero, alpha0, one)
    v0 = torch.where(col(alpha0 > zero), v0u / col(safe_alpha0), v0u)
    normar0 = alpha0 * beta0

    izero = torch.zeros(k, dtype=torch.int32, device=dev)
    carry0 = _LSMRRows(
        itn=izero if batched else const(0, torch.int32), u=u0, v=v0,
        alpha=alpha0, beta=beta0, istop=izero, itn_d=izero, h=rows(v0),
        hbar=torch.zeros((k, n), dtype=dtype, device=dev),
        x=torch.zeros((k, n), dtype=dtype, device=dev),
        alphabar=rows(alpha0), rho=ones, rhobar=ones, cbar=ones, sbar=zeros,
        zeta=zeros, zetabar=rows(alpha0 * beta0), betadd=rows(beta0), betad=zeros,
        rhodold=ones, tautildeold=zeros, thetatilde=zeros, d=zeros,
        norma2=rows(alpha0 * alpha0), maxrbar=zeros,
        minrbar=torch.full((k,), min(1e100, torch.finfo(rdtype).max / 2), dtype=rdtype,
                           device=dev),
        normr=rows(beta0), normar=rows(normar0), norma=rows(torch.sqrt(alpha0 * alpha0)),
        conda=ones, normx=zeros,
    )

    def cond_fun(c):
        return (c.istop == 0) & (normar0 != zero)

    def body_fun(c):
        itn = c.itn + 1

        # --- bidiagonalization step (identical to LSQR's) -----------------
        if pair:
            u, z_adj = ops.fused_pair(c.u, c.v, one, c.alpha)
        else:
            u = ops.matvec(c.v) - col(c.alpha) * c.u
        beta = norm(u, "m")
        beta_pos = beta > zero
        safe_beta = torch.where(beta_pos, beta, one)
        u = torch.where(col(beta_pos), u / col(safe_beta), u)
        if pair:
            v_cand = (torch.where(col(beta_pos), z_adj / col(safe_beta), z_adj)
                      - col(beta) * c.v)
        else:
            v_cand = ops.rmatvec(u) - col(beta) * c.v
        alpha_cand = norm(v_cand, "n")
        alpha_pos = alpha_cand > zero
        safe_alpha = torch.where(alpha_pos, alpha_cand, one)
        v_cand = torch.where(col(alpha_pos), v_cand / col(safe_alpha), v_cand)
        v = torch.where(col(beta_pos), v_cand, c.v)
        alpha = torch.where(beta_pos, alpha_cand, c.alpha)

        # --- per-row rotations -------------------------------------------
        chat, shat, alphahat = _sym_ortho(c.alphabar, damps, one, zero)

        rhoold = c.rho
        cgiv, sgiv, rho = _sym_ortho(alphahat, beta, one, zero)
        thetanew = sgiv * alpha
        alphabar = cgiv * alpha

        rhobarold = c.rhobar
        zetaold = c.zeta
        thetabar = c.sbar * rho
        rhotemp = c.cbar * rho
        cbar, sbar, rhobar = _sym_ortho(c.cbar * rho, thetanew, one, zero)
        zeta = cbar * c.zetabar
        zetabar = -sbar * c.zetabar

        # --- per-row h, hbar, x --------------------------------------------
        hbar = c.h - (thetabar * rho / (rhoold * rhobarold))[:, None] * c.hbar
        x = c.x + (zeta / (rho * rhobar))[:, None] * hbar
        h = v - (thetanew / rho)[:, None] * c.h

        # --- estimate ||r|| ----------------------------------------------
        betaacute = chat * c.betadd
        betacheck = -shat * c.betadd
        betahat = cgiv * betaacute
        betadd = -sgiv * betaacute
        thetatildeold = c.thetatilde
        ctildeold, stildeold, rhotildeold = _sym_ortho(c.rhodold, thetabar, one, zero)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * c.betad + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * c.tautildeold) / rhotildeold
        taud = (zeta - thetatilde * tautildeold) / rhodold
        d = c.d + betacheck * betacheck
        normr = torch.sqrt(d + torch.square(betad - taud) + betadd * betadd)

        # --- estimate ||A|| and cond(A) ----------------------------------
        norma2 = c.norma2 + beta * beta
        norma = torch.sqrt(norma2)
        norma2 = norma2 + alpha * alpha
        maxrbar = torch.maximum(c.maxrbar, rhobarold)
        minrbar = torch.where(itn > 1, torch.minimum(c.minrbar, rhobarold), c.minrbar)
        conda = torch.maximum(maxrbar, rhotemp) / torch.minimum(minrbar, rhotemp)

        # --- convergence tests -------------------------------------------
        normar = torch.abs(zetabar)
        normx = _row_nrm2(x, safe=safe_norms, group=ops.groups["n"])
        safe_normb = torch.where(normb > zero, normb, one)
        test1 = normr / safe_normb
        denom2 = norma * normr
        test2 = torch.where(denom2 > zero,
                            normar / torch.where(denom2 > zero, denom2, one),
                            const(float("inf")))
        test3 = one / conda
        t1 = test1 / (one + norma * normx / safe_normb)
        rtol = btol + atol * norma * normx / safe_normb

        istop = torch.zeros_like(c.istop)
        istop = torch.where(itn >= itnlim, 7, istop)
        istop = torch.where(one + test3 <= one, 6, istop)
        istop = torch.where(one + test2 <= one, 5, istop)
        istop = torch.where(one + t1 <= one, 4, istop)
        istop = torch.where(test3 <= ctol, 3, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)

        return _LSMRRows(
            itn=itn, u=u, v=v, alpha=alpha, beta=beta, istop=istop,
            itn_d=itn.expand_as(c.itn_d), h=h, hbar=hbar, x=x, alphabar=alphabar,
            rho=rho, rhobar=rhobar, cbar=cbar, sbar=sbar, zeta=zeta, zetabar=zetabar,
            betadd=betadd, betad=betad, rhodold=rhodold, tautildeold=tautildeold,
            thetatilde=thetatilde, d=d, norma2=norma2, maxrbar=maxrbar,
            minrbar=minrbar, normr=normr, normar=normar, norma=norma, conda=conda,
            normx=normx,
        )

    def finalize(final) -> LSMRResult:
        return LSMRResult(
            x=final.x, istop=final.istop, itn=final.itn_d, normr=final.normr,
            normar=final.normar, norma=final.norma, conda=final.conda,
            normx=final.normx, trace=None,
        )

    return carry0, cond_fun, body_fun, finalize, () if batched else SHARED


@tracing.entry("lsmr_multidamp", rows="damps", rows_by_length=True)
def lsmr_multidamp(A, b, damps, *, atol: float = 1e-6, btol: float = 1e-6,
                   conlim: float = 1e8, itnlim: Optional[int] = None,
                   safe_norms: bool = True, loop: Optional[str] = None,
                   loop_segment: int = 64, pair: Optional[bool] = None,
                   m: Optional[int] = None, n: Optional[int] = None) -> LSMRResult:
    """LSMR over a vector of damp values from one shared bidiagonalization.

    The LSMR analogue of :func:`lsqr_multidamp`, with the arguments and
    defaults of :func:`~lsqr_tpu_torch.lsmr` (a zero tolerance means
    machine precision, as there). Each damp's result is bit for bit that of
    ``lsmr(A, b, damp_j)`` on the same product route (``pair``). ``loop``
    is accepted for parity, as in ``lsmr``.

    Returns an :class:`LSMRResult` with a leading (k,) axis on every field
    (``x`` is (k, n)); ``trace`` is None.
    """
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = solve_dtype(b, A)
    b = b.to(dtype)
    damps = _damps(damps, dtype, b.device)
    atol, btol = sibling_tolerances(dtype, atol, btol)
    itnlim = int(itnlim) if itnlim is not None else min(A.m, A.n)
    pair = resolve_pair(A, pair, bool(getattr(A, "prefers_pair", False)))

    def scalar(v):
        return as_tensor(v, dtype=real_dtype(dtype), device=b.device)

    with tracing.span("prepare"):
        pieces = build_lsmr_rows(A, b, damps, scalar(atol), scalar(btol), scalar(conlim),
                                 batched=False, itnlim=itnlim, safe_norms=safe_norms,
                                 pair=pair)
    return solve_rows(pieces, A=A, itnlim=itnlim, seg_len=loop_segment)
