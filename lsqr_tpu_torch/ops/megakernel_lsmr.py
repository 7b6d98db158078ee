"""K LSMR iterations per kernel launch: the LSMR iteration megakernel.

PyTorch counterpart of :mod:`lsqr_tpu.ops.megakernel_lsmr`, the LSMR
sibling of :mod:`.megakernel`: the same phases 0 and 1 (the unnormalized
bidiagonalization), then phase 2 updates h, hbar and x, and the scalar
recurrence is Fong & Saunders' (the rotations Phat, P and Pbar, the
monotone ||r|| and ||A'r|| estimators, istop 0-7 as in
:func:`lsqr_tpu_torch.lsmr`). ``normx`` is reduced as ``ssq_x`` in phase 2
and consumed at the next iteration's p0 boundary, where iteration k's
stopping tests run (and on the host for the last one). The CUDA kernel is
``lsmr_megakernel`` in ``csrc/megakernel.cu``; :func:`lsmr_megakernel_plain`
is its twin.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..lsmr import _sym_ortho
from . import spmv
from .megakernel import (
    _State, adjoint_plain, check_call, f32_b, fill_state, forward_plain,
    host_loop, launch_call, setup, supported_operator, tensor, warm_start,
)

__all__ = ["lsmr_megakernel", "lsmr_megakernel_supported", "lsmr_megakernel_call",
           "lsmr_megakernel_plain", "lsmr_megakernel_prepare"]

# scalar-state indices (lsqr_tpu/ops/megakernel_lsmr.py:41-49)
(ALPHA, BETA, ALPHABAR, RHO, RHOBAR, CBAR, SBAR, ZETA) = range(8)
(ZETABAR, BETADD, BETAD, RHODOLD, TAUTILDEOLD, THETATILDE, DACC,
 NORMA2) = range(8, 16)
(MAXRBAR, MINRBAR, NORMR, NORMAR, NORMA, CONDA, NORMX, ITN) = range(16, 24)
(ISTOP, SSQ_U, SSQ_V, SSQ_X, C1F, C2F, C1A, C2A) = range(24, 32)
(BPOS, CHB, CX, CH, INVA, APREV, ACT0, NORMB) = range(32, 40)
(ATOL, BTOL, CTOL, ITNLIM, DAMP) = range(40, 45)


def lsmr_megakernel_plain(data, tdata, u, v, x, h, hbar, state, *, offsets, m, n, K):
    """Plain twin of one :func:`lsmr_megakernel_call`: K LSMR iterations in
    the kernel's phase order, updating u, v, x, h, hbar and the state in
    place."""
    s = _State(state)
    zero, one = s.zero, s.one
    act0 = s[ACT0] > 0.5
    inf = torch.full((), float("inf"), dtype=torch.float32, device=zero.device)
    for _ in range(int(K)):
        # --- p0: the previous iteration's tests (they need ssq_x) ---------
        upd = act0 & (s[ITN] > 0.5) & (s[ISTOP] == 0)
        normx = torch.sqrt(s[SSQ_X])
        safe_b = torch.where(s[NORMB] > 0, s[NORMB], one)
        normr, norma, conda, normar = s[NORMR], s[NORMA], s[CONDA], s[NORMAR]
        test1 = normr / safe_b
        denom2 = norma * normr
        test2 = torch.where(denom2 > 0, normar / torch.where(denom2 > 0, denom2, one), inf)
        test3 = one / torch.where(conda > 0, conda, one)
        t1 = test1 / (one + norma * normx / safe_b)
        rtol = s[BTOL] + s[ATOL] * norma * normx / safe_b
        istop = zero
        istop = torch.where(s[ITN] >= s[ITNLIM], 7.0, istop)
        istop = torch.where(one + test3 <= one, 6.0, istop)
        istop = torch.where(one + test2 <= one, 5.0, istop)
        istop = torch.where(one + t1 <= one, 4.0, istop)
        istop = torch.where(test3 <= s[CTOL], 3.0, istop)
        istop = torch.where(test2 <= s[ATOL], 2.0, istop)
        istop = torch.where(test1 <= rtol, 1.0, istop)
        s.put(NORMX, normx, upd)
        s.put(ISTOP, istop, upd)
        alpha, beta = s[ALPHA], s[BETA]
        s.put(C1F, s.safe_div(one, alpha), act0)
        s.put(C2F, alpha * s.safe_div(one, beta), act0)
        s.put(APREV, alpha, act0)
        s.put(SSQ_U, zero, act0)
        act = act0 & (s[ISTOP] == 0)
        u_new = forward_plain(data, u, v, s[C1F], s[C2F], offsets, m)
        u.copy_(torch.where(act, u_new, u))
        s.put(SSQ_U, s[SSQ_U] + torch.sum(u_new * u_new), act)

        # --- p1 ----------------------------------------------------------
        active = s[ISTOP] == 0
        beta = torch.sqrt(s[SSQ_U])
        aprev = s[APREV]
        s.put(BETA, torch.where(active, beta, s[BETA]), act0)
        s.put(BPOS, torch.where(active & (beta > 0), one, zero), act0)
        s.put(C1A, s.safe_div(one, beta), act0)
        s.put(C2A, beta * s.safe_div(one, aprev), act0)
        s.put(SSQ_V, zero, act0)
        v_new = adjoint_plain(tdata, v, u, s[C1A], s[C2A], offsets, n)
        v_new = torch.where(s[BPOS] > 0.5, v_new, v)
        v.copy_(torch.where(act, v_new, v))
        s.put(SSQ_V, s[SSQ_V] + torch.sum(v_new * v_new), act)

        # --- p2: the three rotations and the h/hbar/x coefficients -------
        upd = act0 & (s[ISTOP] == 0)
        alpha = torch.where(s[BPOS] > 0.5, torch.sqrt(s[SSQ_V]), s[APREV])
        beta = s[BETA]
        itn = s[ITN] + 1.0
        chat, shat, alphahat = _sym_ortho(s[ALPHABAR], s[DAMP], one, zero)
        rhoold = s[RHO]
        cgiv, sgiv, rho = _sym_ortho(alphahat, beta, one, zero)
        thetanew = sgiv * alpha
        alphabar = cgiv * alpha
        rhobarold = s[RHOBAR]
        zetaold = s[ZETA]
        thetabar = s[SBAR] * rho
        rhotemp = s[CBAR] * rho
        cbar, sbar, rhobar = _sym_ortho(s[CBAR] * rho, thetanew, one, zero)
        zeta = cbar * s[ZETABAR]
        zetabar = -sbar * s[ZETABAR]
        c_hb = s.safe_div(thetabar * rho, rhoold * rhobarold)
        c_x = s.safe_div(zeta, rho * rhobar)
        c_h = s.safe_div(thetanew, rho)
        betaacute = chat * s[BETADD]
        betacheck = -shat * s[BETADD]
        betahat = cgiv * betaacute
        betadd = -sgiv * betaacute
        thetatildeold = s[THETATILDE]
        ctold, stold, rhotildeold = _sym_ortho(s[RHODOLD], thetabar, one, zero)
        thetatilde = stold * rhobar
        rhodold = ctold * rhobar
        betad = -stold * s[BETAD] + ctold * betahat
        tautildeold = s.safe_div(zetaold - thetatildeold * s[TAUTILDEOLD], rhotildeold)
        taud = s.safe_div(zeta - thetatilde * tautildeold, rhodold)
        dacc = s[DACC] + betacheck * betacheck
        bd_taud = betad - taud
        normr = torch.sqrt(dacc + bd_taud * bd_taud + betadd * betadd)
        na2 = s[NORMA2] + beta * beta
        norma = torch.sqrt(na2)
        na2 = na2 + alpha * alpha
        maxrbar = torch.maximum(s[MAXRBAR], rhobarold)
        minrbar = torch.where(itn > 1.5, torch.minimum(s[MINRBAR], rhobarold), s[MINRBAR])
        num = torch.maximum(maxrbar, rhotemp)
        den = torch.minimum(minrbar, rhotemp)
        conda = num / torch.where(den > 0, den, one)
        for i, val in ((ALPHA, alpha), (ITN, itn), (ALPHABAR, alphabar), (RHO, rho),
                       (RHOBAR, rhobar), (CBAR, cbar), (SBAR, sbar), (ZETA, zeta),
                       (ZETABAR, zetabar), (BETADD, betadd), (BETAD, betad),
                       (RHODOLD, rhodold), (TAUTILDEOLD, tautildeold),
                       (THETATILDE, thetatilde), (DACC, dacc), (NORMA2, na2),
                       (MAXRBAR, maxrbar), (MINRBAR, minrbar), (NORMR, normr),
                       (NORMAR, torch.abs(zetabar)), (NORMA, norma), (CONDA, conda),
                       (SSQ_X, zero)):
            s.put(i, val, upd)
        for i, val in ((CHB, c_hb), (CX, c_x), (CH, c_h), (INVA, s.inv(alpha, one))):
            s.put(i, val, act0)
        h_old = h.clone()
        hbar_new = h_old - s[CHB] * hbar
        x_new = x + s[CX] * hbar_new
        hbar.copy_(torch.where(act, hbar_new, hbar))
        x.copy_(torch.where(act, x_new, x))
        h.copy_(torch.where(act, v * s[INVA] - s[CH] * h_old, h))
        s.put(SSQ_X, s[SSQ_X] + torch.sum(x_new * x_new), act)
    state.copy_(s.tensor())


def lsmr_megakernel_call(data, tdata, u, v, x, h, hbar, state, *, offsets, m, n, K,
                         offsets_t: Optional[torch.Tensor] = None,
                         toffsets_t: Optional[torch.Tensor] = None, _route=None):
    """One launch of the LSMR megakernel (K iterations, in place); CPU
    tensors run :func:`lsmr_megakernel_plain`. ``_route`` (tile, blocks)
    forces a route (:func:`.megakernel.launch_call`)."""
    offsets = tuple(int(k) for k in offsets)
    check_call(data, tdata, dict(u=(u, m), v=(v, n), x=(x, n), h=(h, n), hbar=(hbar, n)),
               state, offsets, m, n, K)
    if not data.is_cuda:
        return lsmr_megakernel_plain(data, tdata, u, v, x, h, hbar, state,
                                     offsets=offsets, m=m, n=n, K=K)
    launch_call(lsmr_megakernel_call, "lsmr", data, tdata, u, v, x, h, hbar, state,
                offsets, m, n, K, offsets_t, toffsets_t, _route)


spmv.register(lsmr_megakernel_call, ("f32", "bf16"), name="lsmr_megakernel",
              work="iterations")


def lsmr_megakernel_supported(A, *, record_trace=False) -> bool:
    """Whether :func:`lsmr_megakernel` runs this operator: a DIAOperator
    with f32 or bf16 stripes, no trace, and a launchable cooperative grid."""
    return not record_trace and supported_operator(A)


def lsmr_megakernel_prepare(A, b, damp=0.0, *, atol=1e-6, btol=1e-6, conlim=1e8,
                            itnlim: int):
    """The setup outside the kernel (lsqr_tpu/ops/megakernel_lsmr.py:
    469-513). Returns ((u, v, x, h, hbar), state) for
    :func:`lsmr_megakernel_call`."""
    b = f32_b(A, b)
    n, dev = A.n, A.device
    eps = np.float32(np.finfo(np.float32).eps)
    ctolf = float(np.float32(1.0) / max(np.float32(conlim), eps)) \
        if np.float32(conlim) > 0 else 0.0
    v0u, beta0, alpha0 = setup(A, b)
    h = torch.where(alpha0 > 0, v0u / torch.where(alpha0 > 0, alpha0, 1.0), v0u)
    state = fill_state(dev, {
        ALPHA: alpha0, BETA: beta0, ALPHABAR: alpha0, RHO: 1.0, RHOBAR: 1.0, CBAR: 1.0,
        ZETABAR: alpha0 * beta0, BETADD: beta0, RHODOLD: 1.0,
        NORMA2: alpha0 * alpha0, MINRBAR: 1e30, NORMR: beta0, NORMAR: alpha0 * beta0,
        NORMA: alpha0, CONDA: 1.0, NORMB: beta0, ATOL: float(np.float32(atol)),
        BTOL: float(np.float32(btol)), CTOL: ctolf, ITNLIM: float(itnlim),
        DAMP: float(np.float32(damp)),
        ACT0: ((beta0 > 0) & (alpha0 * beta0 != 0)).float(),
    })
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    return (b.clone(), v0u.contiguous(), zeros, h, zeros.clone()), state


@tracing.entry("lsmr_megakernel")
def lsmr_megakernel(A, b, damp: float = 0.0, *, atol: float = 1e-6, btol: float = 1e-6,
                    conlim: float = 1e8, itnlim=None, iters_per_call: int = 32, x0=None):
    """Solve min ||Ax - b|| (optionally damped) with LSMR, K iterations per
    kernel launch. Semantics of :func:`lsqr_tpu_torch.lsmr` in f32, no
    trace; returns an LSMRResult."""
    from ..lsmr import LSMRResult

    b = f32_b(A, b)
    if x0 is not None:
        return warm_start(lsmr_megakernel, A, b, damp, x0, "normx", atol=atol, btol=btol,
                          conlim=conlim, itnlim=itnlim, iters_per_call=iters_per_call)
    if not supported_operator(A):
        raise ValueError("lsmr_megakernel needs a DIAOperator with f32 or bf16 stripes "
                         "(see lsmr_megakernel_supported)")
    m, n = A.m, A.n
    dev = A.device
    itnlim_r = int(itnlim) if itnlim is not None else min(m, n)
    K = min(iters_per_call, max(1, itnlim_r))
    (u, v, x, h, hbar), state = lsmr_megakernel_prepare(
        A, b, damp, atol=atol, btol=btol, conlim=conlim, itnlim=itnlim_r)

    def call():
        lsmr_megakernel_call(A.data, A.tdata, u, v, x, h, hbar, state, offsets=A.offsets,
                             m=m, n=n, K=K, offsets_t=A.offsets_t, toffsets_t=A.toffsets_t)

    st = host_loop(call, state, itnlim_r, K, ISTOP, ITN)

    # the last iteration's pending tests, replicated on the host as in
    # lsqr_tpu/ops/megakernel_lsmr.py:531-559
    istop = st[ISTOP]
    normx = st[NORMX]
    if st[ACT0] > 0.5 and istop == 0.0 and st[ITN] > 0:
        normx = float(np.sqrt(st[SSQ_X]))
        safe_b = st[NORMB] if st[NORMB] > 0 else 1.0
        test1 = st[NORMR] / safe_b
        denom2 = st[NORMA] * st[NORMR]
        test2 = st[NORMAR] / denom2 if denom2 > 0 else np.inf
        test3 = 1.0 / st[CONDA] if st[CONDA] > 0 else 1.0
        t1 = test1 / (1.0 + st[NORMA] * normx / safe_b)
        rtol = st[BTOL] + st[ATOL] * st[NORMA] * normx / safe_b
        f32 = np.float32
        if st[ITN] >= st[ITNLIM]:
            istop = 7.0
        if f32(1.0) + f32(test3) <= f32(1.0):
            istop = 6.0
        if f32(1.0) + f32(test2) <= f32(1.0):
            istop = 5.0
        if f32(1.0) + f32(t1) <= f32(1.0):
            istop = 4.0
        if test3 <= st[CTOL]:
            istop = 3.0
        if test2 <= st[ATOL]:
            istop = 2.0
        if test1 <= rtol:
            istop = 1.0

    f, i32 = torch.float32, torch.int32
    return LSMRResult(
        x=x, istop=tensor(istop, i32, dev), itn=tensor(st[ITN], i32, dev),
        normr=tensor(st[NORMR], f, dev), normar=tensor(st[NORMAR], f, dev),
        norma=tensor(st[NORMA], f, dev), conda=tensor(st[CONDA], f, dev),
        normx=tensor(normx, f, dev), trace=None,
    )
