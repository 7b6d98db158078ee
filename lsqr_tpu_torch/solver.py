"""LSQR core: Golub–Kahan bidiagonalization with Givens-rotation recurrences.

PyTorch counterpart of :mod:`lsqr_tpu.solver`, with the same recurrences in
the same operation order: the stopping taxonomy (istop 0-5,
lsqr.f90:520-538), the ``1 + t <= 1`` guards (lsqr.f90:798-804), the damp
rotation (lsqr.f90:703-710), the dxmax monitor (lsqr.f90:747-757) and the
standard-error finalization (lsqr.f90:857-865).

The loop is the JAX package's bounded form (``_masked_body`` and
``_lsqr_bounded``): segments of ``loop_segment`` iterations in which every
iteration runs, and an iteration after convergence leaves the carry as it
was (``torch.where(active, new, old)``). The scalar recurrence stays in 0-d
tensors on the device, and the host reads ``istop``/``itn`` once per
segment, never once per iteration. The masking makes ``itn`` and ``istop``
those of JAX's ``while_loop``.

Complex problems, as in the JAX package: the vectors u, v, w and x are
complex, ``rmatvec`` is the conjugate-transpose product, and every scalar
of the recurrence (alpha, beta, the rotations, the norm estimates, damp and
the tolerances) is real, in the matching real dtype; ``se`` and the trace
are real, the trace recording Re x[0].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import LSQROptions, as_dtype, default_dtype, real_dtype
from .ops.blas import abs2, d2norm, nrm2
from .ops.linop import LinearOperator, as_operator, as_tensor

__all__ = ["LSQRResult", "lsqr", "ISTOP_MESSAGES", "TRACE_COLUMNS"]

ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "A solution to Ax = b was found, given atol, btol",
    2: "A least-squares solution was found, given atol",
    3: "A damped least-squares solution was found, given atol",
    4: "Cond(Abar) seems to be too large, given conlim",
    5: "The iteration limit was reached",
}

#: columns of the iteration trace buffer (lsqr.f90:827-829)
TRACE_COLUMNS = (
    "itn", "x0", "rnorm", "test1", "test2", "anorm", "acond",
    "phi", "dknorm", "dxk", "alfopt",
)


class LSQRResult(NamedTuple):
    """Solver outputs (lsqr.f90:520-563), 0-d tensors on the solve's
    device except ``x``, ``se`` (n,) and ``trace`` (itnlim+1, 11)."""

    x: torch.Tensor
    istop: torch.Tensor
    itn: torch.Tensor
    anorm: torch.Tensor
    acond: torch.Tensor
    rnorm: torch.Tensor
    arnorm: torch.Tensor
    xnorm: torch.Tensor
    bnorm: torch.Tensor
    se: Optional[torch.Tensor]
    dxmax: torch.Tensor
    maxdx: torch.Tensor
    trace: Optional[torch.Tensor]

    @property
    def istop_message(self) -> str:
        return ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor
    nstop: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    x: torch.Tensor
    se: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    rhobar: torch.Tensor
    phibar: torch.Tensor
    anorm: torch.Tensor
    dnorm: torch.Tensor
    dxmax: torch.Tensor
    maxdx: torch.Tensor
    res2: torch.Tensor
    psi: torch.Tensor
    xnorm: torch.Tensor
    xnorm1: torch.Tensor
    cs2: torch.Tensor
    sn2: torch.Tensor
    z: torch.Tensor
    acond: torch.Tensor
    rnorm: torch.Tensor
    arnorm: torch.Tensor
    trace: torch.Tensor


def _build(
    A: LinearOperator,
    b: torch.Tensor,
    damp: torch.Tensor,
    atol: torch.Tensor,
    btol: torch.Tensor,
    conlim: torch.Tensor,
    *,
    itnlim: int,
    wantse: bool,
    nconv: int,
    record_trace: bool,
    safe_norms: bool,
    fused: bool = False,
    pair: bool = False,
    scalar_dtype: Optional[torch.dtype] = None,
):
    """Construct the solver pieces (carry0, cond_fun, body_fun, finalize),
    as :func:`lsqr_tpu.solver._build` does.

    ``body_fun(c, active)`` writes its trace row in place, and only where
    ``active`` holds; every other field is a new tensor."""
    m, n = A.shape
    dtype = b.dtype
    rdtype = real_dtype(dtype)
    is_complex = dtype.is_complex
    dev = b.device
    sdtype = scalar_dtype if scalar_dtype is not None else rdtype
    mixed = sdtype != rdtype
    if fused and mixed:
        raise ValueError(
            "fused half-steps compute in f32 and cannot carry a wider "
            "scalar_dtype; set fused=False for the mixed-precision mode"
        )
    if is_complex and (fused or pair) and not (
            pair and getattr(A, "supports_complex_pair", False)):
        # ZDIAOperator's pair kernel takes complex vectors; the real kernels
        # do not
        raise ValueError(
            "fused/pair half-step kernels are real-f32 only; "
            "set fused=False, pair=False for complex operators"
        )

    def sc(s):  # scalar -> recurrence precision
        return s.to(sdtype) if mixed else s

    def vc(s):  # scalar -> vector-op precision; real scalars stay real
        return s.to(rdtype) if mixed else s

    def const(v, dt=sdtype):
        return torch.tensor(v, dtype=dt, device=dev)

    zero = const(0.0)
    one = const(1.0)
    damp, atol, btol, conlim = sc(damp), sc(atol), sc(btol), sc(conlim)

    def norm(vec):
        return sc(nrm2(vec, safe=safe_norms))

    damped = damp > zero
    ctol = torch.where(conlim > zero, one / torch.where(conlim > zero, conlim, one), zero)

    # --- setup: beta*u = b, alpha*v = A'u (lsqr.f90:619-646) -------------
    u0 = b
    beta0 = norm(u0)
    safe_beta0 = torch.where(beta0 > zero, beta0, one)
    u0_norm = torch.where(beta0 > zero, u0 / vc(safe_beta0), u0)
    v0u = torch.where(beta0 > zero, A.rmatvec(u0_norm),
                      torch.zeros(n, dtype=dtype, device=dev))
    alpha0 = torch.where(beta0 > zero, norm(v0u), zero)
    safe_alpha0 = torch.where(alpha0 > zero, alpha0, one)
    v0_norm = torch.where(alpha0 > zero, v0u / vc(safe_alpha0), v0u)
    if fused:
        # unnormalized carry: carry.beta = ||u||, carry.alpha = ||v||
        u0, v0 = u0, v0u
    else:
        u0, v0 = u0_norm, v0_norm
    w0 = v0_norm
    arnorm0 = alpha0 * beta0
    bnorm = beta0

    trace_rows = itnlim + 1 if record_trace else 1
    trace0 = torch.zeros((trace_rows, len(TRACE_COLUMNS)), dtype=rdtype, device=dev)
    if record_trace:
        # itn-0 header line (lsqr.f90:663-669): test1 = 1, test2 = alpha/beta
        trace0[0] = torch.stack(
            [zero, zero, beta0, one,
             torch.where(beta0 > zero, alpha0 / safe_beta0, zero),
             zero, zero, zero, zero, zero, zero]
        ).to(rdtype)

    izero = const(0, torch.int32)
    carry0 = _Carry(
        itn=izero, istop=izero, nstop=izero,
        u=u0, v=v0, w=w0,
        x=torch.zeros(n, dtype=dtype, device=dev),
        se=torch.zeros(n if wantse else 1, dtype=rdtype, device=dev),
        alpha=alpha0, beta=beta0, rhobar=alpha0, phibar=beta0,
        anorm=zero, dnorm=zero, dxmax=zero, maxdx=izero,
        res2=zero, psi=zero, xnorm=zero, xnorm1=zero,
        cs2=-one, sn2=zero, z=zero, acond=zero,
        rnorm=beta0, arnorm=arnorm0, trace=trace0,
    )

    def cond_fun(c: _Carry):
        return (c.istop == 0) & (arnorm0 != zero)

    def body_fun(c: _Carry, active: torch.Tensor) -> _Carry:
        itn = c.itn + 1

        # --- bidiagonalization step (lsqr.f90:681-699) -----------------
        if fused:
            # unnormalized carry: u_true = c.u/c.beta, v_true = c.v/c.alpha
            inv_alpha_prev = torch.where(
                c.alpha > zero, one / torch.where(c.alpha > zero, c.alpha, one), zero)
            inv_beta_prev = torch.where(
                c.beta > zero, one / torch.where(c.beta > zero, c.beta, one), zero)
            if pair:
                # one stripe pass: u_new = A v_true - alpha u_true and the
                # raw adjoint z = A' u_new (1/beta is applied below)
                u, z_adj = A.fused_pair(
                    y=c.u, win=c.v, c1=inv_alpha_prev, c2=c.alpha * inv_beta_prev)
                ssq_u = torch.sum(abs2(u))
            else:
                u, ssq_u = A.fused_halfstep(
                    forward=True, y=c.u, win=c.v,
                    c1=inv_alpha_prev, c2=c.alpha * inv_beta_prev)
            beta = torch.sqrt(ssq_u).to(rdtype)
            temp = d2norm(c.alpha, beta)
            temp = d2norm(temp, damp)
            anorm = d2norm(c.anorm, temp)
            beta_pos = beta > zero
            inv_beta = torch.where(beta_pos, one / torch.where(beta_pos, beta, one), zero)
            if pair:
                v_cand = z_adj * vc(inv_beta) - vc(beta * inv_alpha_prev) * c.v
                ssq_v = torch.sum(abs2(v_cand))
            else:
                v_cand, ssq_v = A.fused_halfstep(
                    forward=False, y=c.v, win=u,
                    c1=inv_beta, c2=beta * inv_alpha_prev)
            alpha_cand = torch.sqrt(ssq_v).to(rdtype)
            v = torch.where(beta_pos, v_cand, c.v)
            alpha = torch.where(beta_pos, alpha_cand, c.alpha)
            inv_alpha_new = torch.where(
                alpha > zero, one / torch.where(alpha > zero, alpha, one), one)
            v_for_w = v * inv_alpha_new
        else:
            # u := A v - alpha u ; beta = ||u||
            u = A.matvec(c.v) - vc(c.alpha) * c.u
            beta = norm(u)
            temp = d2norm(c.alpha, beta)
            temp = d2norm(temp, damp)
            anorm = d2norm(c.anorm, temp)
            beta_pos = beta > zero
            safe_beta = torch.where(beta_pos, beta, one)
            u = torch.where(beta_pos, u / vc(safe_beta), u)
            v_cand = A.rmatvec(u) - vc(beta) * c.v
            alpha_cand = norm(v_cand)
            alpha_pos = alpha_cand > zero
            safe_alpha = torch.where(alpha_pos, alpha_cand, one)
            v_cand = torch.where(alpha_pos, v_cand / vc(safe_alpha), v_cand)
            v = torch.where(beta_pos, v_cand, c.v)
            alpha = torch.where(beta_pos, alpha_cand, c.alpha)
            v_for_w = v

        # --- rotation eliminating damp (lsqr.f90:703-710) ---------------
        rhbar1_d = d2norm(c.rhobar, damp)
        safe_rhbar1 = torch.where(rhbar1_d > zero, rhbar1_d, one)
        cs1 = c.rhobar / safe_rhbar1
        sn1 = damp / safe_rhbar1
        psi = torch.where(damped, sn1 * c.phibar, c.psi)
        phibar = torch.where(damped, cs1 * c.phibar, c.phibar)
        rhbar1 = torch.where(damped, rhbar1_d, c.rhobar)

        # --- rotation eliminating beta (lsqr.f90:714-721) ----------------
        rho = d2norm(rhbar1, beta)
        safe_rho = torch.where(rho > zero, rho, one)
        cs = rhbar1 / safe_rho
        sn = beta / safe_rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # --- x/w/se update (lsqr.f90:724-745) ----------------------------
        t1 = phi / safe_rho
        t2 = -theta / safe_rho
        t3 = one / safe_rho
        t = c.w
        x = vc(t1) * t + c.x
        w = vc(t2) * t + v_for_w
        dk2 = abs2(vc(t3) * t)
        dknorm = torch.sqrt(sc(torch.sum(dk2)))
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

        denom_ax = dnorm * xnorm
        alfopt = torch.sqrt(torch.where(
            denom_ax > zero, rnorm / torch.where(denom_ax > zero, denom_ax, one), zero))
        safe_bnorm = torch.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        test2 = torch.where(
            rnorm > zero, arnorm / torch.where(rnorm > zero, anorm * rnorm, one), zero)
        safe_acond = torch.where(acond > zero, acond, one)
        test3 = one / safe_acond
        t1_rel = test1 / (one + anorm * xnorm / safe_bnorm)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        # --- stopping tests (lsqr.f90:798-810): later tests take priority
        istop = izero
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

        # --- iteration log (lsqr.f90:813-837), written in place ----------
        if record_trace:
            x0_val = x[0].real if is_complex else x[0]
            row = torch.stack([
                s.to(sdtype) for s in
                (itn, x0_val, rnorm, test1, test2, anorm, acond, phi, dknorm, dxk, alfopt)
            ]).to(rdtype)
            idx = torch.clamp(itn, max=trace_rows - 1).long().view(1)
            old = c.trace.index_select(0, idx)
            c.trace.index_copy_(0, idx, torch.where(active, row.view(1, -1), old))

        return _Carry(
            itn=itn, istop=istop, nstop=nstop,
            u=u, v=v, w=w, x=x, se=se,
            alpha=alpha, beta=beta, rhobar=rhobar, phibar=phibar,
            anorm=anorm, dnorm=dnorm, dxmax=dxmax, maxdx=maxdx,
            res2=res2, psi=psi,
            xnorm=xnorm, xnorm1=xnorm1, cs2=cs2, sn2=sn2, z=z,
            acond=acond, rnorm=rnorm, arnorm=arnorm, trace=c.trace,
        )

    def finalize(final: _Carry) -> LSQRResult:
        # --- standard errors (lsqr.f90:857-865) --------------------------
        se_out = None
        if wantse:
            t_static = float(m - n) if m > n else 1.0
            t = torch.where(damped, const(float(m)), const(t_static))
            t = final.rnorm / torch.sqrt(t)
            se_out = vc(t) * torch.sqrt(final.se)
        # damped istop 2 -> 3 (lsqr.f90:871)
        istop = torch.where(damped & (final.istop == 2), 3, final.istop)
        return LSQRResult(
            x=final.x, istop=istop, itn=final.itn, anorm=final.anorm,
            acond=final.acond, rnorm=final.rnorm, arnorm=final.arnorm,
            xnorm=final.xnorm, bnorm=bnorm, se=se_out, dxmax=final.dxmax,
            maxdx=final.maxdx, trace=final.trace if record_trace else None,
        )

    return carry0, cond_fun, body_fun, finalize


def _masked_step(c, cond_fun, body_fun):
    """One iteration that leaves the carry (a NamedTuple of tensors) as it
    was once the solver has stopped (``_masked_body`` of the JAX package)."""
    active = cond_fun(c)
    new = body_fun(c, active)
    return type(c)(*[a if a is b else torch.where(active, a, b) for a, b in zip(new, c)])


def _run_segments(carry, cond_fun, body_fun, *, itnlim: int, seg_len: int):
    """Host-stepped solve in segments of masked iterations: one host read of
    (istop, itn) per segment; at most ``seg_len - 1`` masked iterations."""
    seg = min(seg_len, itnlim) if itnlim > 0 else seg_len
    prev_itn = 0
    while True:
        for _ in range(seg):
            carry = _masked_step(carry, cond_fun, body_fun)
        istop, itn = torch.stack([carry.istop, carry.itn]).tolist()
        if istop != 0 or itn >= itnlim or itn == prev_itn:
            return carry
        prev_itn = itn


def lsqr(
    A,
    b,
    damp: float = 0.0,
    *,
    x0=None,
    options: Optional[LSQROptions] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    **option_overrides,
) -> LSQRResult:
    """Solve ``A x = b``, ``min ||A x - b||`` or the damped problem
    ``min ||[A; damp I] x - [b; 0]||`` (lsqr.f90:264-273).

    Args:
      A: a LinearOperator, a dense 2-D array or tensor, or a
        (matvec, rmatvec) tuple with ``m``/``n``.
      b: right-hand side (m,); moved to the operator's device.
      damp: damping parameter, a number or 0-d tensor.
      x0: optional warm start, undamped only (lsqr.f90:303-320): solve
        ``A dx = b - A x0`` and return ``x = x0 + dx``.
      options / option_overrides: see :class:`LSQROptions`.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    if opts.debug_log:
        raise NotImplementedError(
            "debug_log=True is not ported yet (ROADMAP Queue 1 item 8, "
            "utils/printing.py); use record_trace=True"
        )

    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = as_dtype(opts.dtype) or torch.promote_types(b.dtype, A.dtype or b.dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = default_dtype()
    b = b.to(dtype)
    if b.ndim != 1 or b.shape[0] != A.m:
        raise ValueError(
            f"b must be a vector of length m = {A.m} (the number of rows of "
            f"A); got shape {tuple(b.shape)}"
        )

    if opts.megakernel:
        # None means False, as in the JAX package (LSQROptions.megakernel)
        from .ops.megakernel import lsqr_megakernel, megakernel_supported

        if not (dtype == torch.float32 and opts.scalar_dtype is None
                and megakernel_supported(A, wantse=opts.wantse,
                                         record_trace=opts.record_trace)):
            raise ValueError(
                "megakernel=True requires an f32 DIAOperator (f32 or bf16 "
                "stripes) without wantse, record_trace or scalar_dtype (see "
                "ops.megakernel.megakernel_supported)"
            )
        return lsqr_megakernel(A, b, damp, atol=opts.atol, btol=opts.btol,
                               conlim=opts.conlim, itnlim=opts.itnlim,
                               nconv=opts.nconv, x0=x0)

    if x0 is not None:
        if float(damp) != 0.0:
            raise NotImplementedError(
                "a damped warm start needs ops/compose.py (ROADMAP Queue 1 "
                "item 9); pass x0 with damp=0"
            )
        x0 = as_tensor(x0, dtype=dtype, device=b.device)
        res = lsqr(A, b - A.matvec(x0), damp, options=opts)
        xw = x0 + res.x
        return res._replace(x=xw, xnorm=nrm2(xw, safe=opts.safe_norms))

    itnlim = opts.resolve_itnlim(A.n)
    fused = opts.fused
    if fused is None:
        fused = bool(getattr(A, "prefers_fused", False))
    if fused and not hasattr(A, "fused_halfstep"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_halfstep; set fused=False")
    pair = opts.pair
    if pair is None:
        pair = opts.fused is not False and bool(getattr(A, "prefers_pair", False))
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_pair; set pair=False")
    if pair:
        fused = True  # the pair needs the unnormalized carry

    def scalar(v):  # damp and the tolerances are real, also for complex problems
        return as_tensor(v, dtype=real_dtype(dtype), device=b.device)

    carry0, cond_fun, body_fun, finalize = _build(
        A, b, scalar(damp), scalar(opts.atol), scalar(opts.btol), scalar(opts.conlim),
        itnlim=itnlim, wantse=opts.wantse, nconv=opts.nconv,
        record_trace=opts.record_trace, safe_norms=opts.safe_norms,
        fused=fused, pair=pair, scalar_dtype=as_dtype(opts.scalar_dtype),
    )
    final = _run_segments(carry0, cond_fun, body_fun, itnlim=itnlim,
                          seg_len=opts.loop_segment)
    return finalize(final)
