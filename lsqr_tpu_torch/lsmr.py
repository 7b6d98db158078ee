"""LSMR, the MINRES-flavoured sibling of LSQR (Fong & Saunders, SIAM J. Sci.
Comput. 2011).

PyTorch counterpart of :mod:`lsqr_tpu.lsmr`, with the same recurrences in
the same operation order: the same Golub–Kahan bidiagonalization as LSQR
(lsqr.f90:681-699), then a second QR factorization so that ``||A' r||``
decreases monotonically. The istop taxonomy 0-7, the defaults and the result
fields follow the public LSMR interface that ``scipy.sparse.linalg.lsmr``
implements.

The loop is the LSQR core's (:func:`lsqr_tpu_torch.solver._run_segments`):
segments of masked iterations with one host read of istop/itn per segment,
so ``itn`` and ``istop`` are those of JAX's ``while_loop``. Complex problems
as in LSQR: complex vectors, real scalars.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import default_dtype, real_dtype
from .ops.blas import nrm2
from .ops.linop import LinearOperator, as_operator, as_tensor
from .solver import _run_segments

__all__ = ["LSMRResult", "lsmr", "LSMR_ISTOP_MESSAGES", "LSMR_TRACE_COLUMNS"]

LSMR_ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "Ax - b is small enough, given atol, btol",
    2: "The least-squares solution is good enough, given atol",
    3: "The estimate of cond(Abar) has exceeded conlim",
    4: "Ax - b is small enough for this machine",
    5: "The least-squares solution is good enough for this machine",
    6: "Cond(Abar) seems to be too large for this machine",
    7: "The iteration limit has been reached",
}

#: columns of the optional iteration trace buffer
LSMR_TRACE_COLUMNS = ("itn", "x0", "normr", "normar", "test1", "test2",
                      "norma", "conda")


class LSMRResult(NamedTuple):
    """LSMR outputs (the tuple scipy.sparse.linalg.lsmr returns, plus the
    optional trace), 0-d tensors on the solve's device except ``x`` (n,)
    and ``trace`` (itnlim+1, 8)."""

    x: torch.Tensor
    istop: torch.Tensor
    itn: torch.Tensor
    normr: torch.Tensor
    normar: torch.Tensor
    norma: torch.Tensor
    conda: torch.Tensor
    normx: torch.Tensor
    trace: Optional[torch.Tensor]

    @property
    def istop_message(self) -> str:
        return LSMR_ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    h: torch.Tensor
    hbar: torch.Tensor
    x: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
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
    trace: torch.Tensor


def _sym_ortho(a, b, one, zero):
    """Stable Givens rotation (c, s, r) with the sign conventions of the
    published LSMR implementation, branchless (lsqr_tpu/lsmr.py:101-129)."""
    absa = torch.abs(a)
    absb = torch.abs(b)
    sign_a = torch.where(a >= zero, one, -one)
    sign_b = torch.where(b >= zero, one, -one)

    safe_b = torch.where(b != zero, b, one)
    tau_ab = a / safe_b               # |b| > |a| branch
    s_b = sign_b / torch.sqrt(one + tau_ab * tau_ab)
    c_b = s_b * tau_ab
    r_b = safe_b / s_b

    safe_a = torch.where(a != zero, a, one)
    tau_ba = b / safe_a               # |a| >= |b| branch
    c_a = sign_a / torch.sqrt(one + tau_ba * tau_ba)
    s_a = c_a * tau_ba
    r_a = safe_a / c_a

    b_zero = b == zero
    a_zero = a == zero
    b_dom = absb > absa

    c = torch.where(b_zero, sign_a, torch.where(a_zero, zero, torch.where(b_dom, c_b, c_a)))
    s = torch.where(b_zero, zero, torch.where(a_zero, sign_b, torch.where(b_dom, s_b, s_a)))
    r = torch.where(b_zero, absa, torch.where(a_zero, absb, torch.where(b_dom, r_b, r_a)))
    return c, s, r


def _build(
    A: LinearOperator,
    b: torch.Tensor,
    damp: torch.Tensor,
    atol: torch.Tensor,
    btol: torch.Tensor,
    conlim: torch.Tensor,
    *,
    itnlim: int,
    record_trace: bool,
    safe_norms: bool,
    pair: bool = False,
):
    """(carry0, cond_fun, body_fun, finalize), the pieces of
    :func:`lsqr_tpu.lsmr._build`; ``body_fun(c, active)`` writes its trace
    row in place where ``active`` holds."""
    m, n = A.shape
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    dev = b.device
    check_complex_pair(A, dtype, pair)

    def const(v, dt=rdtype):
        return torch.tensor(v, dtype=dt, device=dev)

    zero = const(0.0)
    one = const(1.0)

    def norm(vec):
        return nrm2(vec, safe=safe_norms)

    ctol = torch.where(conlim > zero, one / torch.where(conlim > zero, conlim, one), zero)

    # --- setup: beta u = b, alpha v = A'u ---------------------------------
    normb = norm(b)
    beta0 = normb
    safe_beta0 = torch.where(beta0 > zero, beta0, one)
    u0 = torch.where(beta0 > zero, b / safe_beta0, b)
    v0u = torch.where(beta0 > zero, A.rmatvec(u0), torch.zeros(n, dtype=dtype, device=dev))
    alpha0 = torch.where(beta0 > zero, norm(v0u), zero)
    safe_alpha0 = torch.where(alpha0 > zero, alpha0, one)
    v0 = torch.where(alpha0 > zero, v0u / safe_alpha0, v0u)
    normar0 = alpha0 * beta0

    trace_rows = itnlim + 1 if record_trace else 1
    trace0 = torch.zeros((trace_rows, len(LSMR_TRACE_COLUMNS)), dtype=rdtype, device=dev)
    if record_trace:
        trace0[0] = torch.stack(
            [zero, zero, beta0, normar0, one,
             torch.where(normar0 > zero, alpha0 / safe_beta0, zero), zero, zero])

    izero = const(0, torch.int32)
    carry0 = _Carry(
        itn=izero, istop=izero, u=u0, v=v0, h=v0,
        hbar=torch.zeros(n, dtype=dtype, device=dev),
        x=torch.zeros(n, dtype=dtype, device=dev),
        alpha=alpha0, beta=beta0, alphabar=alpha0, rho=one, rhobar=one,
        cbar=one, sbar=zero, zeta=zero, zetabar=alpha0 * beta0,
        betadd=beta0, betad=zero, rhodold=one, tautildeold=zero,
        thetatilde=zero, d=zero, norma2=alpha0 * alpha0, maxrbar=zero,
        minrbar=const(min(1e100, torch.finfo(rdtype).max / 2)),
        normr=beta0, normar=normar0, norma=torch.sqrt(alpha0 * alpha0),
        conda=one, normx=zero, trace=trace0,
    )

    def cond_fun(c: _Carry):
        return (c.istop == 0) & (normar0 != zero)

    def body_fun(c: _Carry, active: torch.Tensor) -> _Carry:
        itn = c.itn + 1

        # --- bidiagonalization step (identical to LSQR's) -----------------
        if pair:
            # one stripe pass: u_raw = A v - alpha u and z = A'u_raw; the
            # 1/beta normalization commutes with A'
            u, z_adj = A.fused_pair(y=c.u, win=c.v, c1=one, c2=c.alpha)
        else:
            u = A.matvec(c.v) - c.alpha * c.u
        beta = norm(u)
        beta_pos = beta > zero
        safe_beta = torch.where(beta_pos, beta, one)
        u = torch.where(beta_pos, u / safe_beta, u)
        if pair:
            v_cand = torch.where(beta_pos, z_adj / safe_beta, z_adj) - beta * c.v
        else:
            v_cand = A.rmatvec(u) - beta * c.v
        alpha_cand = norm(v_cand)
        alpha_pos = alpha_cand > zero
        safe_alpha = torch.where(alpha_pos, alpha_cand, one)
        v_cand = torch.where(alpha_pos, v_cand / safe_alpha, v_cand)
        v = torch.where(beta_pos, v_cand, c.v)
        alpha = torch.where(beta_pos, alpha_cand, c.alpha)

        # --- plane rotation Phat: eliminate damp -------------------------
        chat, shat, alphahat = _sym_ortho(c.alphabar, damp, one, zero)

        # --- plane rotation P: eliminate beta ----------------------------
        rhoold = c.rho
        cgiv, sgiv, rho = _sym_ortho(alphahat, beta, one, zero)
        thetanew = sgiv * alpha
        alphabar = cgiv * alpha

        # --- plane rotation Pbar: eliminate thetanew ---------------------
        rhobarold = c.rhobar
        zetaold = c.zeta
        thetabar = c.sbar * rho
        rhotemp = c.cbar * rho
        cbar, sbar, rhobar = _sym_ortho(c.cbar * rho, thetanew, one, zero)
        zeta = cbar * c.zetabar
        zetabar = -sbar * c.zetabar

        # --- update h, hbar, x -------------------------------------------
        hbar = c.h - (thetabar * rho / (rhoold * rhobarold)) * c.hbar
        x = c.x + (zeta / (rho * rhobar)) * hbar
        h = v - (thetanew / rho) * c.h

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
        normx = norm(x)
        safe_normb = torch.where(normb > zero, normb, one)
        test1 = normr / safe_normb
        denom2 = norma * normr
        test2 = torch.where(denom2 > zero,
                            normar / torch.where(denom2 > zero, denom2, one),
                            const(float("inf")))
        test3 = one / conda
        t1 = test1 / (one + norma * normx / safe_normb)
        rtol = btol + atol * norma * normx / safe_normb

        # later tests take priority, as in the published implementation
        istop = izero
        istop = torch.where(itn >= itnlim, 7, istop)
        istop = torch.where(one + test3 <= one, 6, istop)
        istop = torch.where(one + test2 <= one, 5, istop)
        istop = torch.where(one + t1 <= one, 4, istop)
        istop = torch.where(test3 <= ctol, 3, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)

        if record_trace:
            row = torch.stack([
                itn.to(rdtype), x[0].real if dtype.is_complex else x[0], normr, normar, test1,
                torch.where(torch.isinf(test2), zero, test2), norma, conda])
            idx = torch.clamp(itn, max=trace_rows - 1).long().view(1)
            old = c.trace.index_select(0, idx)
            c.trace.index_copy_(0, idx, torch.where(active, row.view(1, -1), old))

        return _Carry(
            itn=itn, istop=istop, u=u, v=v, h=h, hbar=hbar, x=x,
            alpha=alpha, beta=beta, alphabar=alphabar, rho=rho,
            rhobar=rhobar, cbar=cbar, sbar=sbar, zeta=zeta, zetabar=zetabar,
            betadd=betadd, betad=betad, rhodold=rhodold,
            tautildeold=tautildeold, thetatilde=thetatilde, d=d,
            norma2=norma2, maxrbar=maxrbar, minrbar=minrbar,
            normr=normr, normar=normar, norma=norma, conda=conda,
            normx=normx, trace=c.trace,
        )

    def finalize(final: _Carry) -> LSMRResult:
        return LSMRResult(
            x=final.x, istop=final.istop, itn=final.itn, normr=final.normr,
            normar=final.normar, norma=final.norma, conda=final.conda,
            normx=final.normx, trace=final.trace if record_trace else None,
        )

    return carry0, cond_fun, body_fun, finalize


def solve_dtype(b: torch.Tensor, A: LinearOperator) -> torch.dtype:
    """The working dtype of a sibling solve: b's, ints -> the default float
    (the JAX siblings' rule)."""
    if b.ndim != 1 or b.shape[0] != A.m:
        raise ValueError(f"b must be a vector of length m = {A.m}; got shape "
                         f"{tuple(b.shape)}")
    return b.dtype if b.dtype.is_floating_point or b.dtype.is_complex else default_dtype()


def check_complex_pair(A: LinearOperator, dtype: torch.dtype, pair: bool) -> None:
    """The siblings' guard: with complex vectors the pair path needs an
    operator whose pair kernel takes them (``supports_complex_pair``)."""
    if dtype.is_complex and pair and not getattr(A, "supports_complex_pair", False):
        raise ValueError("fused pair kernels are real-f32 only; set pair=False for "
                         "complex operators")


def lsmr(
    A,
    b,
    damp: float = 0.0,
    *,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    itnlim: Optional[int] = None,
    x0=None,
    record_trace: bool = False,
    safe_norms: bool = True,
    loop: Optional[str] = None,
    loop_segment: int = 64,
    m: Optional[int] = None,
    n: Optional[int] = None,
    megakernel: Optional[bool] = None,
    pair: Optional[bool] = None,
) -> LSMRResult:
    """Solve ``A x = b``, ``min ||A x - b||`` or its damped form with LSMR.

    The conventions of :func:`lsqr_tpu_torch.lsqr`; the defaults (atol =
    btol = 1e-6, conlim = 1e8, itnlim = min(m, n)) follow the published
    LSMR interface, and a zero tolerance means machine precision.
    ``megakernel=True`` runs K iterations per kernel launch
    (:func:`lsqr_tpu_torch.ops.megakernel_lsmr.lsmr_megakernel`); None means
    False, as in the JAX package. ``loop`` is accepted for parity: both
    forms run the same masked segments of ``loop_segment`` iterations.
    ``x0`` warm-starts with the residual-correction recipe
    (lsqr.f90:303-320), undamped only.
    """
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = solve_dtype(b, A)
    b = b.to(dtype)
    eps = float(torch.finfo(dtype).eps)
    atol = eps if atol == 0 else atol
    btol = eps if btol == 0 else btol

    if megakernel:
        from .ops.megakernel_lsmr import lsmr_megakernel, lsmr_megakernel_supported

        if not (dtype == torch.float32
                and lsmr_megakernel_supported(A, record_trace=record_trace)):
            raise ValueError(
                "megakernel=True requires an f32 DIAOperator (f32 or bf16 stripes) "
                "without record_trace (see ops.megakernel_lsmr."
                "lsmr_megakernel_supported)")
        return lsmr_megakernel(A, b, damp, atol=atol, btol=btol, conlim=conlim,
                               itnlim=itnlim, x0=x0)

    if x0 is not None:
        if float(damp) != 0.0:
            raise NotImplementedError(
                "a damped warm start needs ops/compose.py (ROADMAP Queue 1 "
                "item 9); pass x0 with damp=0")
        x0 = as_tensor(x0, dtype=dtype, device=b.device)
        res = lsmr(A, b - A.matvec(x0), damp, atol=atol, btol=btol, conlim=conlim,
                   itnlim=itnlim, record_trace=record_trace, safe_norms=safe_norms,
                   loop_segment=loop_segment, pair=pair)
        xw = x0 + res.x
        return res._replace(x=xw, normx=nrm2(xw, safe=safe_norms))

    itnlim = int(itnlim) if itnlim is not None else min(A.m, A.n)
    if pair is None:
        pair = bool(getattr(A, "prefers_pair", False))
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(f"{type(A).__name__} does not implement fused_pair; set pair=False")

    def scalar(v):  # damp and the tolerances are real, also for complex problems
        return as_tensor(v, dtype=real_dtype(dtype), device=b.device)

    carry0, cond_fun, body_fun, finalize = _build(
        A, b, scalar(damp), scalar(atol), scalar(btol), scalar(conlim),
        itnlim=itnlim, record_trace=record_trace, safe_norms=safe_norms, pair=pair)
    final = _run_segments(carry0, cond_fun, body_fun, itnlim=itnlim, seg_len=loop_segment)
    return finalize(final)
