"""K CRAIG iterations per kernel launch: the CRAIG iteration megakernel.

PyTorch counterpart of :mod:`lsqr_tpu.ops.megakernel_craig`: Craig's
method (:func:`lsqr_tpu_torch.craig`) on the megakernel substrate of
:mod:`.megakernel`, with its own phase order: phase 0 the x update
(``x += (y/alpha) v`` with v before its update), phase 1 the forward
half-step, phase 2 the adjoint half-step. ``||x||`` comes from the y² chain,
so only the two half-steps reduce. The stopping tests need alpha_{k+1}
(from phase 2) and run at the next iteration's p0 boundary, and on the host
for the last one. The CUDA kernel is ``craig_megakernel`` in
``csrc/megakernel.cu``; :func:`craig_megakernel_plain` is its twin.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from . import spmv
from .linop import as_tensor
from .megakernel import (
    _State, adjoint_plain, check_call, f32_b, fill_state, forward_plain,
    host_loop, launch_call, setup, supported_operator, tensor,
)

__all__ = ["craig_megakernel", "craig_megakernel_supported", "craig_megakernel_call",
           "craig_megakernel_plain", "craig_megakernel_prepare"]

# scalar-state indices (lsqr_tpu/ops/megakernel_craig.py:36-39)
(ALPHA, BETA, Y, CY, ANORM2, XNORM2, RNORM, ITN) = range(8)
(ISTOP, SSQ_U, SSQ_V, C1F, C2F, C1A, C2A, BPOS) = range(8, 16)
(APREV, ACT0, BNORM, ATOL, BTOL, ITNLIM) = range(16, 22)


def craig_megakernel_plain(data, tdata, u, v, x, state, *, offsets, m, n, K):
    """Plain twin of one :func:`craig_megakernel_call`: K CRAIG iterations
    in the kernel's phase order, updating u, v, x and the state in place."""
    s = _State(state)
    zero, one = s.zero, s.one
    act0 = s[ACT0] > 0.5
    for _ in range(int(K)):
        # --- p0: finish the previous iteration (alpha, tests), then y ------
        upd = act0 & (s[ITN] > 0.5) & (s[ISTOP] == 0)
        bpos = s[BPOS] > 0.5
        alpha_cand = torch.sqrt(s[SSQ_V])
        apos = alpha_cand > 0
        alpha = torch.where(bpos & apos, alpha_cand, s[ALPHA])
        anorm2 = s[ANORM2] + torch.where(
            bpos, s[BETA] * s[BETA] + torch.where(apos, alpha_cand * alpha_cand, zero), zero)
        anorm = torch.sqrt(anorm2)
        xnorm = torch.sqrt(s[XNORM2])
        safe_b = torch.where(s[BNORM] > 0, s[BNORM], one)
        test1 = s[RNORM] / safe_b
        rtol = s[BTOL] + s[ATOL] * anorm * xnorm / safe_b
        istop = zero
        istop = torch.where(s[ITN] >= s[ITNLIM], 5.0, istop)
        istop = torch.where(bpos & ~apos, 4.0, istop)
        istop = torch.where(one + test1 <= one, 2.0, istop)
        istop = torch.where(test1 <= rtol, 1.0, istop)
        istop = torch.where(~bpos, 1.0, istop)
        s.put(ALPHA, alpha, upd)
        s.put(ANORM2, anorm2, upd)
        s.put(ISTOP, istop, upd)

        active = s[ISTOP] == 0
        upd = act0 & active
        alpha, beta = s[ALPHA], s[BETA]
        itn = s[ITN] + 1.0
        ratio = s.safe_div(beta, alpha)
        y = torch.where(itn < 1.5, ratio, -ratio * s[Y])
        inv_a = s.safe_div(one, alpha)
        s.put(CY, torch.where(active, y * inv_a, zero), act0)
        s.put(XNORM2, s[XNORM2] + y * y, upd)
        s.put(Y, y, upd)
        s.put(ITN, itn, upd)
        s.put(C1F, inv_a, act0)
        s.put(C2F, alpha * s.safe_div(one, beta), act0)
        s.put(APREV, alpha, act0)
        s.put(SSQ_U, zero, act0)
        act = upd
        x.copy_(torch.where(act, x + s[CY] * v, x))

        # --- p1: the forward half-step -------------------------------------
        u_new = forward_plain(data, u, v, s[C1F], s[C2F], offsets, m)
        u.copy_(torch.where(act, u_new, u))
        s.put(SSQ_U, s[SSQ_U] + torch.sum(u_new * u_new), act)

        # --- p2: beta, rnorm, then the adjoint half-step -------------------
        upd = act0 & (s[ISTOP] == 0)
        beta = torch.sqrt(s[SSQ_U])
        aprev = s[APREV]
        s.put(BETA, beta, upd)
        s.put(BPOS, torch.where(beta > 0, one, zero), upd)
        s.put(RNORM, beta * torch.abs(s[Y]), upd)
        s.put(C1A, s.safe_div(one, beta), act0)
        s.put(C2A, beta * s.safe_div(one, aprev), act0)
        s.put(SSQ_V, zero, act0)
        v_new = adjoint_plain(tdata, v, u, s[C1A], s[C2A], offsets, n)
        v_new = torch.where(s[BPOS] > 0.5, v_new, v)
        v.copy_(torch.where(act, v_new, v))
        s.put(SSQ_V, s[SSQ_V] + torch.sum(v_new * v_new), act)
    state.copy_(s.tensor())


def craig_megakernel_call(data, tdata, u, v, x, state, *, offsets, m, n, K,
                          offsets_t: Optional[torch.Tensor] = None,
                          toffsets_t: Optional[torch.Tensor] = None, _route=None):
    """One launch of the CRAIG megakernel (K iterations, in place); CPU
    tensors run :func:`craig_megakernel_plain`. ``_route`` (tile, blocks)
    forces a route (:func:`.megakernel.launch_call`)."""
    offsets = tuple(int(k) for k in offsets)
    check_call(data, tdata, dict(u=(u, m), v=(v, n), x=(x, n)), state, offsets, m, n, K)
    if not data.is_cuda:
        return craig_megakernel_plain(data, tdata, u, v, x, state, offsets=offsets,
                                      m=m, n=n, K=K)
    launch_call(craig_megakernel_call, "craig", data, tdata, u, v, x, None, None, state,
                offsets, m, n, K, offsets_t, toffsets_t, _route)


spmv.register(craig_megakernel_call, ("f32", "bf16"), name="craig_megakernel",
              work="iterations")


def craig_megakernel_supported(A) -> bool:
    """Whether :func:`craig_megakernel` runs this operator: a DIAOperator
    with f32 or bf16 stripes and a launchable cooperative grid."""
    return supported_operator(A)


def craig_megakernel_prepare(A, b, *, atol=1e-6, btol=1e-6, itnlim: int):
    """The setup outside the kernel (lsqr_tpu/ops/megakernel_craig.py:
    317-344). Returns ((u, v, x), state) for :func:`craig_megakernel_call`."""
    b = f32_b(A, b)
    v0u, beta0, alpha0 = setup(A, b)
    state = fill_state(A.device, {
        ALPHA: alpha0, BETA: beta0, ANORM2: alpha0 * alpha0 + beta0 * beta0,
        RNORM: beta0, BPOS: 1.0, BNORM: beta0, ATOL: float(np.float32(atol)),
        BTOL: float(np.float32(btol)), ITNLIM: float(itnlim),
        ACT0: ((beta0 > 0) & (alpha0 > 0)).float(),
    })
    return (b.clone(), v0u.contiguous(),
            torch.zeros(A.n, dtype=torch.float32, device=A.device)), state


@tracing.entry("craig_megakernel")
def craig_megakernel(A, b, *, atol: float = 1e-6, btol: float = 1e-6, itnlim=None,
                     iters_per_call: int = 32, x0=None):
    """Minimum-norm solve of a consistent system with Craig's method, K
    iterations per kernel launch. Semantics of :func:`lsqr_tpu_torch.craig`
    in f32; returns a CRAIGResult."""
    from ..craig import CRAIGResult
    from .blas import nrm2

    b = f32_b(A, b)
    if x0 is not None:
        x0 = as_tensor(x0, dtype=torch.float32, device=b.device)
        res = craig_megakernel(A, b - A.matvec(x0), atol=atol, btol=btol, itnlim=itnlim,
                               iters_per_call=iters_per_call)
        xw = x0 + res.x
        return res._replace(x=xw, xnorm=nrm2(xw, safe=True))
    if not supported_operator(A):
        raise ValueError("craig_megakernel needs a DIAOperator with f32 or bf16 stripes "
                         "(see craig_megakernel_supported)")
    m, n = A.m, A.n
    dev = A.device
    itnlim_r = int(itnlim) if itnlim is not None else min(m, n)
    K = min(iters_per_call, max(1, itnlim_r))

    (u, v, x), state = craig_megakernel_prepare(A, b, atol=atol, btol=btol,
                                                itnlim=itnlim_r)

    def call():
        craig_megakernel_call(A.data, A.tdata, u, v, x, state, offsets=A.offsets, m=m,
                              n=n, K=K, offsets_t=A.offsets_t, toffsets_t=A.toffsets_t)

    st = host_loop(call, state, itnlim_r, K, ISTOP, ITN)

    # lsqr_tpu/ops/megakernel_craig.py:361-389, on the host
    istop = st[ISTOP]
    anorm2 = st[ANORM2]
    if st[ACT0] < 0.5:  # istop-4 breakdown at setup: b has no part in range(A)
        istop = 4.0 if st[BNORM] > 0 else 0.0
    elif istop == 0.0 and st[ITN] > 0:
        bpos = st[BPOS] > 0.5
        alpha_cand = float(np.sqrt(st[SSQ_V]))
        apos = alpha_cand > 0.0
        if bpos:
            anorm2 = anorm2 + st[BETA] ** 2 + (alpha_cand ** 2 if apos else 0.0)
        anorm = float(np.sqrt(anorm2))
        xnorm = float(np.sqrt(st[XNORM2]))
        safe_b = st[BNORM] if st[BNORM] > 0 else 1.0
        test1 = st[RNORM] / safe_b
        rtol = st[BTOL] + st[ATOL] * anorm * xnorm / safe_b
        f32 = np.float32
        if st[ITN] >= st[ITNLIM]:
            istop = 5.0
        if bpos and not apos:
            istop = 4.0
        if f32(1.0) + f32(test1) <= f32(1.0):
            istop = 2.0
        if test1 <= rtol:
            istop = 1.0
        if not bpos:
            istop = 1.0

    f, i32 = torch.float32, torch.int32
    return CRAIGResult(
        x=x, istop=tensor(istop, i32, dev), itn=tensor(st[ITN], i32, dev),
        rnorm=tensor(st[RNORM], f, dev), anorm=tensor(np.sqrt(anorm2), f, dev),
        xnorm=tensor(np.sqrt(st[XNORM2]), f, dev),
    )
