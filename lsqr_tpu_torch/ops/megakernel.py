"""K LSQR iterations per kernel launch: the iteration megakernel.

PyTorch counterpart of :mod:`lsqr_tpu.ops.megakernel`. One launch of
``lsqr_megakernel`` in ``csrc/megakernel.cu`` runs K complete LSQR
iterations (both bidiagonalization half-steps, the damp and Givens
rotations, the x/w update, the xnorm estimator and the stopping logic,
lsqr.f90:681-810) on the packed DIA stripes of a :class:`DIAOperator`, as
the Pallas kernel does over its grid ``(K, 3, nt)``: phase 0 the forward
half-step, phase 1 the adjoint half-step, phase 2 the x/w update, the
scalar recurrence at each phase boundary, iterations after convergence
masked, and iteration k's stopping tests deferred to iteration k+1's first
boundary. u and v are carried unnormalized. The scalar state is a flat f32
tensor of ``NSTATE`` entries with the JAX package's named indices.

The TPU mechanism is not carried over: no VMEM residency, no padded
vectors or tiles. The CUDA kernel is a persistent cooperative grid with a
grid-wide barrier between phases (see the source's header). What bounds it
on the H100 is bytes: both stripe arrays and 10 (LSQR), 12 (LSMR) or 8
(CRAIG) f32 vector passes an iteration. Its two product phases are staged:
each block walks tiles of 512 outputs, two outputs a thread, two tiles in
shared memory, the next one's 16-byte ``cp.async`` copies (each diagonal's
stripe elements, the vector window, y) in flight while it sums this one,
so each stripe byte crosses once and the vector is read once a tile. The
tile comes from :func:`spmv.mk_tile` (512 where the two stages fit one
block's shared memory and the vector window is at most ``spmv.MK_SPREAD``
times the vector reads it saves, else 0); at T = 0 (many diagonals, a
sparse band spread wide, or offsets of +-m/2) both phases take the direct
route, a kernel of its own: one thread an output in a grid-stride loop,
reading the stripes and, once a diagonal, the vector from device memory.
The routes give a
thread other outputs, so their sums of squares round differently: they
agree to 1e-4 relative, not bit for bit. The wrapper records the route it
launched (``tile``, ``blocks``, ``stage_bytes``). :func:`lsqr_megakernel_plain`
is its PyTorch twin, one launch's K iterations in the same phase order on
the same state. On CPU tensors the wrapper runs the twin (where JAX runs
the Pallas kernel interpreted); on CUDA tensors it launches the kernel or
raises.

The size gate differs from JAX's: JAX bounds the problem by the VMEM the
resident vectors need (``_fit_tm``); on the card the vectors stay in device
memory, so the gate is a launchable cooperative grid and the kernels'
bound of 1 to 1024 diagonals (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import tracing
from . import spmv
from .blas import d2norm, nrm2
from .linop import as_tensor

__all__ = ["lsqr_megakernel", "megakernel_supported", "lsqr_megakernel_call",
           "lsqr_megakernel_plain", "lsqr_megakernel_prepare", "route", "NSTATE"]

# scalar-state indices (lsqr_tpu/ops/megakernel.py:47-54)
ALPHA, BETA, RHOBAR, PHIBAR, ANORM, DNORM, RES2, PSI = range(8)
XNORM, XNORM1, CS2, SN2, ZROW, DXMAX, MAXDX, ITN = range(8, 16)
ISTOP, NSTOP, SSQ_U, SSQ_V, SSQ_DK, RNORM, ARNORM, ACOND = range(16, 24)
BNORM, DAMP, ATOL, BTOL, CTOL, ITNLIM, NCONV, DAMPED = range(24, 32)
C1F, C2F, C1A, C2A, BPOS, T1, T2, T3 = range(32, 40)
INVA, PHI, THETA, RHO, TAU, APREV, ACT0 = range(40, 47)
NSTATE = 64

#: solver ids of the library's lsqr_mk_grid
_SOLVERS = {"lsqr": 0, "lsmr": 1, "craig": 2}


# ---------------------------------------------------------------------------
# Shared by the three megakernels
# ---------------------------------------------------------------------------


def supported_operator(A) -> bool:
    """The gate the three megakernels share: a DIAOperator with f32 or bf16
    stripes, 1 to 1024 diagonals and non-empty dimensions, and on CUDA a
    device that launches a cooperative grid of the route the launch takes."""
    from .structured import DIAOperator

    if not isinstance(A, DIAOperator):
        return False
    if A.data.dtype not in (torch.float32, torch.bfloat16):
        return False
    if not (1 <= len(A.offsets) <= 1024 and A.m >= 1 and A.n >= 1):
        return False
    return not A.data.is_cuda or route("lsqr", A.data, A.offsets, A.m, A.n)[1] > 0


@functools.lru_cache(maxsize=None)
def _grid_cached(solver, bf16, dim, nd, halo, tile, device_index):
    from . import _cuda

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().lsqr_mk_grid(_SOLVERS[solver], int(bf16), dim, nd, halo,
                                                 tile, ctypes.byref(blocks)), "lsqr_mk_grid")
    return blocks.value


def route(solver, stripes, offsets, m, n):
    """(tile, blocks) of a launch on the card: the staged phases' tile
    (:func:`spmv.mk_tile`, 0 for the direct route) and the cooperative grid
    with that route's shared memory (0: the device cannot launch one)."""
    lo, hi = spmv._halos(offsets)
    tile = spmv.mk_tile(len(offsets), lo, hi, stripes.element_size(),
                        spmv._smem_limits(stripes.device)[1])
    return tile, _grid_cached(solver, stripes.dtype == torch.bfloat16, int(max(m, n)),
                              len(offsets), lo + hi, tile, stripes.device.index or 0)


class _State:
    """The twins' scalar state: a list of f32 0-d tensors on the device,
    read with ``s[i]`` and written, optionally where ``mask`` holds, with
    ``s.put(i, value, mask)``; no value ever goes to the host."""

    def __init__(self, state: torch.Tensor):
        self.v = list(state.clone().unbind())
        self.zero = torch.zeros((), dtype=torch.float32, device=state.device)
        self.one = torch.ones((), dtype=torch.float32, device=state.device)

    def __getitem__(self, i):
        return self.v[i]

    def put(self, i, value, mask=None):
        value = torch.as_tensor(value, dtype=torch.float32, device=self.zero.device)
        self.v[i] = value if mask is None else torch.where(mask, value, self.v[i])

    def tensor(self):
        return torch.stack(self.v)

    def inv(self, a, default):
        """1/a where a > 0, else ``default`` (the kernels' guarded inverse)."""
        return torch.where(a > 0, self.one / torch.where(a > 0, a, self.one), default)

    def safe_div(self, num, den):
        return torch.where(den != 0, num / torch.where(den != 0, den, self.one), self.zero)


def forward_plain(data, u, v, c1, c2, offsets, m):
    """Phase body: A (v*c1) - c2*u in f32 (bf16 stripes widened)."""
    return spmv._axpy_acc(data, u, v, c1, c2, offsets, m)


def adjoint_plain(tdata, v, u, c1, c2, offsets, n):
    """Phase body: A' (u*c1) - c2*v on the transpose stripes (offsets of
    A), in f32."""
    return spmv._axpy_acc(tdata, v, u, c1, c2, tuple(-k for k in offsets), n)


def check_call(data, tdata, vectors, state, offsets, m, n, K):
    """Validate the arguments of a megakernel call (either device)."""
    nd = len(offsets)
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stripes of dtype {data.dtype}: the megakernels take f32 or bf16")
    spmv._check("data", data, data.dtype, data.device, (nd, m))
    spmv._check("tdata", tdata, data.dtype, data.device, (nd, n))
    spmv._check("state", state, torch.float32, data.device, NSTATE)
    for name, (vec, dim) in vectors.items():
        spmv._check(name, vec, torch.float32, data.device, dim)
    if int(K) < 1:
        raise ValueError(f"K must be at least 1, got {K}")


def launch_call(wrapper, solver, data, tdata, u, v, x, w, hbar, state, offsets, m, n,
                K, offsets_t, toffsets_t, forced=None):
    """Launch one megakernel call on the card (raises on a refused launch)
    on the route of :func:`route`, or on ``forced`` = (tile, blocks): tests
    and tools compare the two routes at one grid with it."""
    offsets_t = spmv._offsets_on(data, offsets, offsets_t)
    toffsets_t = spmv._offsets_on(data, tuple(-k for k in offsets), toffsets_t)
    fn = spmv._kernel(f"mk_{solver}", data, (torch.float32, torch.bfloat16), offsets)
    tile, blocks = forced or route(solver, data, offsets, m, n)
    if blocks < 1:
        raise RuntimeError(f"{wrapper.kernel_name}: the device cannot launch a "
                           "cooperative grid")
    partial = torch.empty(3 * blocks, dtype=torch.float32, device=data.device)
    lo, hi = spmv._halos(offsets)

    def ptr(t):
        return None if t is None else t.data_ptr()

    wrapper.tile, wrapper.blocks = tile, blocks
    wrapper.stage_bytes = spmv.mk_stage_bytes(len(offsets), lo, hi, tile,
                                              data.element_size()) if tile else 0
    spmv._launch(wrapper, fn, data, data.data_ptr(), tdata.data_ptr(),
                 offsets_t.data_ptr(), toffsets_t.data_ptr(), len(offsets), m, n,
                 ptr(u), ptr(v), ptr(x), ptr(w), ptr(hbar), state.data_ptr(),
                 partial.data_ptr(), blocks, int(K), lo, hi, tile, iterations=int(K))


def host_loop(call, state, itnlim, K, istop_i, itn_i):
    """The speculative host loop (lsqr_tpu/ops/megakernel.py:601-615): call
    i+1 is issued before call i's state is read, so the read overlaps the
    next launch; iterations past convergence are masked, so the one extra
    call changes nothing. Each call's state is copied to pinned host memory
    behind an event, so the read waits for that copy and not for the stream
    to drain. Returns the final state as a numpy f32 array."""
    cuda = state.is_cuda

    def snapshot():
        if not cuda:
            return state.clone(), None
        host = torch.empty(NSTATE, dtype=torch.float32, pin_memory=True)
        host.copy_(state, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    prev = None
    for _ in range(-(-itnlim // K) + 1):
        with tracing.span("mk.launch", K=K):
            call()
            snap = snapshot()
        tracing.count("iterations_launched", K)
        if prev is not None:
            host, event = prev
            with tracing.span("mk.wait"):
                if event is not None:
                    event.synchronize()
            if host[istop_i] != 0 or host[itn_i] >= itnlim:
                break
        prev = snap
    with tracing.span("mk.wait"):
        st = state.cpu().numpy()
    tracing.count("iterations_needed", int(st[itn_i]))
    return st


def setup(A, b):
    """beta u = b, alpha v = A'u on the device (lsqr_tpu/ops/megakernel.py:
    560-567): returns v0u = A'(b/beta) and the 0-d tensors beta0, alpha0."""
    n = A.n
    beta0 = nrm2(b, safe=True)
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    safe_b0 = torch.where(beta0 > 0, beta0, torch.ones_like(beta0))
    u0n = torch.where(beta0 > 0, b / safe_b0, b)
    v0u = torch.where(beta0 > 0, A.rmatvec(u0n),
                      torch.zeros(n, dtype=torch.float32, device=b.device))
    alpha0 = torch.where(beta0 > 0, nrm2(v0u, safe=True), zero)
    return v0u, beta0, alpha0


def fill_state(device, values):
    """A flat f32 state with ``values`` ({index: number or 0-d tensor})
    written in place on the device."""
    state = torch.zeros(NSTATE, dtype=torch.float32, device=device)
    for i, val in values.items():
        state[i] = val
    return state


def warm_start(solve, A, b, damp, x0, norm_field, **kw):
    """The reference's warm-start recipe (lsqr.f90:303-320): solve
    A dx = b - A x0 and return x0 + dx; damp must be 0."""
    if float(damp) != 0.0:
        raise ValueError("x0 warm start implements the residual-correction recipe "
                         "(lsqr.f90:303-320), which requires damp == 0")
    x0 = as_tensor(x0, dtype=torch.float32, device=b.device)
    res = solve(A, b - A.matvec(x0), damp, **kw)
    xw = x0 + res.x
    return res._replace(**{"x": xw, norm_field: nrm2(xw, safe=True)})


def f32_b(A, b):
    """b as an f32 tensor on the operator's device."""
    return as_tensor(b, dtype=torch.float32, device=A.device)


def tensor(value, dtype, device):
    return torch.tensor(float(value) if dtype.is_floating_point else int(value),
                        dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# The LSQR megakernel
# ---------------------------------------------------------------------------


def lsqr_megakernel_plain(data, tdata, u, v, x, w, state, *, offsets, m, n, K):
    """Plain twin of one :func:`lsqr_megakernel_call`: K LSQR iterations in
    the kernel's phase order, updating u (m,), v, x, w (n,) and the state
    in place. Stripes f32 or bf16 (widened); everything else f32."""
    s = _State(state)
    zero, one = s.zero, s.one
    act0 = s[ACT0] > 0.5
    for _ in range(int(K)):
        # --- p0: the previous iteration's tests, then the coefficients ----
        tested = act0 & (s[ITN] > 0.5)
        upd = tested & (s[ISTOP] == 0)
        dknorm = torch.sqrt(s[SSQ_DK])
        dnorm = d2norm(s[DNORM], dknorm)
        dxk = torch.abs(s[PHI] * dknorm)
        new_max = s[DXMAX] < dxk
        dxmax = torch.where(new_max, dxk, s[DXMAX])
        maxdx = torch.where(new_max, s[ITN], s[MAXDX])
        anorm = s[ANORM]
        acond = anorm * dnorm
        rnorm = s[RNORM]
        arnorm = s[ALPHA] * torch.abs(s[TAU])
        safe_b = torch.where(s[BNORM] > 0, s[BNORM], one)
        test1 = rnorm / safe_b
        test2 = torch.where(rnorm > 0, arnorm / torch.where(rnorm > 0, anorm * rnorm, one),
                            zero)
        test3 = one / torch.where(acond > 0, acond, one)
        xnorm = s[XNORM]
        t1rel = test1 / (one + anorm * xnorm / safe_b)
        rtol = s[BTOL] + s[ATOL] * anorm * xnorm / safe_b
        istop = zero
        istop = torch.where(s[ITN] >= s[ITNLIM], 5.0, istop)
        istop = torch.where(one + test3 <= one, 4.0, istop)
        istop = torch.where(one + test2 <= one, 2.0, istop)
        istop = torch.where(one + t1rel <= one, 1.0, istop)
        istop = torch.where(test3 <= s[CTOL], 4.0, istop)
        istop = torch.where(test2 <= s[ATOL], 2.0, istop)
        istop = torch.where(test1 <= rtol, 1.0, istop)
        nstop = torch.where(istop == 0, zero, s[NSTOP] + 1.0)
        istop = torch.where((istop != 0) & (nstop < s[NCONV]) & (s[ITN] < s[ITNLIM]),
                            zero, istop)
        for i, val in ((DNORM, dnorm), (DXMAX, dxmax), (MAXDX, maxdx), (ACOND, acond),
                       (ARNORM, arnorm), (ISTOP, istop), (NSTOP, nstop)):
            s.put(i, val, upd)
        alpha, beta = s[ALPHA], s[BETA]
        s.put(C1F, s.inv(alpha, zero), act0)
        s.put(C2F, alpha * s.inv(beta, zero), act0)
        s.put(APREV, alpha, act0)
        s.put(SSQ_U, zero, act0)
        act = act0 & (s[ISTOP] == 0)
        u_new = forward_plain(data, u, v, s[C1F], s[C2F], offsets, m)
        u.copy_(torch.where(act, u_new, u))
        s.put(SSQ_U, s[SSQ_U] + torch.sum(u_new * u_new), act)

        # --- p1: beta, anorm, the adjoint coefficients --------------------
        active = s[ISTOP] == 0
        beta = torch.sqrt(s[SSQ_U])
        aprev = s[APREV]
        anorm = d2norm(s[ANORM], d2norm(d2norm(aprev, beta), s[DAMP]))
        s.put(BETA, torch.where(active, beta, s[BETA]), act0)
        s.put(ANORM, torch.where(active, anorm, s[ANORM]), act0)
        s.put(BPOS, torch.where(active & (beta > 0), one, zero), act0)
        s.put(C1A, s.inv(beta, zero), act0)
        s.put(C2A, beta * s.inv(aprev, zero), act0)
        s.put(SSQ_V, zero, act0)
        v_new = adjoint_plain(tdata, v, u, s[C1A], s[C2A], offsets, n)
        v_new = torch.where(s[BPOS] > 0.5, v_new, v)
        v.copy_(torch.where(act, v_new, v))
        s.put(SSQ_V, s[SSQ_V] + torch.sum(v_new * v_new), act)

        # --- p2: alpha, both rotations, the x/w coefficients --------------
        active = s[ISTOP] == 0
        upd = act0 & active
        alpha = torch.where(s[BPOS] > 0.5, torch.sqrt(s[SSQ_V]), s[APREV])
        itn = s[ITN] + 1.0
        damped = s[DAMPED] > 0.5
        rhbar1_d = d2norm(s[RHOBAR], s[DAMP])
        safe_r1 = torch.where(rhbar1_d > 0, rhbar1_d, one)
        cs1 = s[RHOBAR] / safe_r1
        sn1 = s[DAMP] / safe_r1
        psi = torch.where(damped, sn1 * s[PHIBAR], s[PSI])
        phibar0 = torch.where(damped, cs1 * s[PHIBAR], s[PHIBAR])
        rhbar1 = torch.where(damped, rhbar1_d, s[RHOBAR])
        beta = s[BETA]
        rho = d2norm(rhbar1, beta)
        safe_rho = torch.where(rho > 0, rho, one)
        cs = rhbar1 / safe_rho
        sn = beta / safe_rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar0
        phibar = sn * phibar0
        tau = sn * phi
        t1 = phi / safe_rho
        t2 = -theta / safe_rho
        t3 = one / safe_rho
        delta = s[SN2] * rho
        gambar = -s[CS2] * rho
        rhs = phi - delta * s[ZROW]
        zbar = rhs / torch.where(gambar != 0, gambar, one)
        xnorm = d2norm(s[XNORM1], zbar)
        gamma = d2norm(gambar, theta)
        safe_g = torch.where(gamma > 0, gamma, one)
        xnorm1 = d2norm(s[XNORM1], rhs / safe_g)
        res2 = d2norm(s[RES2], psi)
        for i, val in ((ALPHA, alpha), (ITN, itn), (RHOBAR, rhobar), (PHIBAR, phibar),
                       (PSI, psi), (XNORM, xnorm), (XNORM1, xnorm1), (CS2, gambar / safe_g),
                       (SN2, theta / safe_g), (ZROW, rhs / safe_g), (RES2, res2),
                       (RNORM, d2norm(res2, phibar)), (PHI, phi), (THETA, theta), (RHO, rho),
                       (TAU, tau), (SSQ_DK, zero)):
            s.put(i, val, upd)
        for i, val in ((T1, t1), (T2, t2), (T3, t3), (INVA, s.inv(alpha, one))):
            s.put(i, val, act0)
        wold = w.clone()
        x.copy_(torch.where(act, x + s[T1] * wold, x))
        w.copy_(torch.where(act, s[T2] * wold + v * s[INVA], w))
        dk = s[T3] * wold
        s.put(SSQ_DK, s[SSQ_DK] + torch.sum(dk * dk), act)
    state.copy_(s.tensor())


def lsqr_megakernel_call(data, tdata, u, v, x, w, state, *, offsets, m, n, K,
                         offsets_t: Optional[torch.Tensor] = None,
                         toffsets_t: Optional[torch.Tensor] = None, _route=None):
    """One launch of the LSQR megakernel: K iterations on the packed stripes
    ``data`` (nd, m) and ``tdata`` (nd, n), updating u (m,), v, x, w (n,)
    and the f32 state (NSTATE,) in place. f32 or bf16 stripes; vectors f32.
    CPU tensors run :func:`lsqr_megakernel_plain`. ``_route`` (tile,
    blocks) forces a route (:func:`launch_call`)."""
    offsets = tuple(int(k) for k in offsets)
    check_call(data, tdata, dict(u=(u, m), v=(v, n), x=(x, n), w=(w, n)), state,
               offsets, m, n, K)
    if not data.is_cuda:
        return lsqr_megakernel_plain(data, tdata, u, v, x, w, state, offsets=offsets,
                                     m=m, n=n, K=K)
    launch_call(lsqr_megakernel_call, "lsqr", data, tdata, u, v, x, w, None, state,
                offsets, m, n, K, offsets_t, toffsets_t, _route)


spmv.register(lsqr_megakernel_call, ("f32", "bf16"), name="lsqr_megakernel",
              work="iterations")


def megakernel_supported(A, *, wantse=False, record_trace=False) -> bool:
    """Whether :func:`lsqr_megakernel` runs this operator: a DIAOperator with
    f32 or bf16 stripes, no se or trace, and (in place of JAX's VMEM bound)
    a launchable cooperative grid."""
    if wantse or record_trace:
        return False
    return supported_operator(A)


def lsqr_megakernel_prepare(A, b, damp=0.0, *, atol=0.0, btol=0.0, conlim=0.0,
                            itnlim: int, nconv=1):
    """The setup outside the kernel (lsqr_tpu/ops/megakernel.py:552-599):
    beta u = b, alpha v = A'u on the device, and the initial state.
    Returns ((u, v, x, w), state) for :func:`lsqr_megakernel_call`."""
    b = f32_b(A, b)
    n, dev = A.n, A.device
    eps = float(np.finfo(np.float32).eps)
    atolf = float(np.float32(atol)) if np.float32(atol) > 0 else eps
    btolf = float(np.float32(btol)) if np.float32(btol) > 0 else eps
    ctolf = float(np.float32(1.0) / max(np.float32(conlim), np.float32(eps))) \
        if np.float32(conlim) > 0 else 0.0
    v0u, beta0, alpha0 = setup(A, b)
    w = torch.where(alpha0 > 0, v0u / torch.where(alpha0 > 0, alpha0, 1.0), v0u)
    state = fill_state(dev, {
        ALPHA: alpha0, BETA: beta0, RHOBAR: alpha0, PHIBAR: beta0, RNORM: beta0,
        ARNORM: alpha0 * beta0, BNORM: beta0, CS2: -1.0, DAMP: float(np.float32(damp)),
        ATOL: atolf, BTOL: btolf, CTOL: ctolf, ITNLIM: float(itnlim),
        NCONV: float(nconv), DAMPED: 1.0 if np.float32(damp) > 0 else 0.0,
        ACT0: ((beta0 > 0) & (alpha0 * beta0 != 0)).float(),
    })
    return (b.clone(), v0u.contiguous(), torch.zeros(n, dtype=torch.float32, device=dev),
            w), state


@tracing.entry("lsqr_megakernel")
def lsqr_megakernel(A, b, damp: float = 0.0, *, atol: float = 0.0, btol: float = 0.0,
                    conlim: float = 0.0, itnlim=None, nconv: int = 1,
                    iters_per_call: int = 32, x0=None):
    """Solve min ||Ax - b|| (optionally damped) with K iterations per kernel
    launch. Semantics of :func:`lsqr_tpu_torch.lsqr` in f32, without se or
    trace; returns an LSQRResult."""
    b = f32_b(A, b)
    if x0 is not None:
        return warm_start(lsqr_megakernel, A, b, damp, x0, "xnorm", atol=atol, btol=btol,
                          conlim=conlim, itnlim=itnlim, nconv=nconv,
                          iters_per_call=iters_per_call)
    if not megakernel_supported(A):
        raise ValueError("lsqr_megakernel needs a DIAOperator with f32 or bf16 stripes "
                         "(see megakernel_supported)")
    m, n = A.m, A.n
    dev = A.device
    itnlim_r = int(itnlim) if itnlim is not None else 4 * n
    K = min(iters_per_call, max(1, itnlim_r))
    with tracing.span("prepare"):
        (u, v, x, w), state = lsqr_megakernel_prepare(
            A, b, damp, atol=atol, btol=btol, conlim=conlim, itnlim=itnlim_r, nconv=nconv)

    def call():
        lsqr_megakernel_call(A.data, A.tdata, u, v, x, w, state, offsets=A.offsets,
                             m=m, n=n, K=K, offsets_t=A.offsets_t,
                             toffsets_t=A.toffsets_t)

    st = host_loop(call, state, itnlim_r, K, ISTOP, ITN)
    with tracing.span("finalize"):
        return _result(st, x, damp, dev)


def _result(st, x, damp, dev):
    """The LSQRResult of a finished solve from its final state ``st`` (a
    numpy array) and its x on the device."""
    from ..solver import LSQRResult

    # the last iteration's tests may still be pending (they run at the next
    # p0 boundary): replicate them on the host, exactly as the JAX package
    # does (lsqr_tpu/ops/megakernel.py:618-656)
    istop = st[ISTOP]
    dnorm, dxmax, maxdx, acond, arnorm = (
        st[DNORM], st[DXMAX], st[MAXDX], st[ACOND], st[ARNORM])
    if istop == 0.0 and st[ITN] > 0:
        dknorm = np.sqrt(st[SSQ_DK])
        dnorm = float(np.hypot(st[DNORM], dknorm))
        dxk = abs(st[PHI] * dknorm)
        if st[DXMAX] < dxk:
            dxmax, maxdx = dxk, st[ITN]
        acond = st[ANORM] * dnorm
        arnorm = st[ALPHA] * abs(st[TAU])
        safe_b = st[BNORM] if st[BNORM] > 0 else 1.0
        test1 = st[RNORM] / safe_b
        test2 = (arnorm / (st[ANORM] * st[RNORM])
                 if st[RNORM] > 0 else 0.0)
        test3 = 1.0 / acond if acond > 0 else 1.0
        t1rel = test1 / (1.0 + st[ANORM] * st[XNORM] / safe_b)
        rtol = st[BTOL] + st[ATOL] * st[ANORM] * st[XNORM] / safe_b
        f32 = np.float32
        if st[ITN] >= st[ITNLIM]:
            istop = 5.0
        if f32(1.0) + f32(test3) <= f32(1.0):
            istop = 4.0
        if f32(1.0) + f32(test2) <= f32(1.0):
            istop = 2.0
        if f32(1.0) + f32(t1rel) <= f32(1.0):
            istop = 1.0
        if test3 <= st[CTOL]:
            istop = 4.0
        if test2 <= st[ATOL]:
            istop = 2.0
        if test1 <= rtol:
            istop = 1.0
        nstop = 0.0 if istop == 0.0 else st[NSTOP] + 1.0
        if istop != 0.0 and nstop < st[NCONV] and st[ITN] < st[ITNLIM]:
            istop = 0.0

    istop_i = int(istop)
    if float(damp) > 0.0 and istop_i == 2:
        istop_i = 3
    f, i32 = torch.float32, torch.int32
    return LSQRResult(
        x=x, istop=tensor(istop_i, i32, dev), itn=tensor(st[ITN], i32, dev),
        anorm=tensor(st[ANORM], f, dev), acond=tensor(acond, f, dev),
        rnorm=tensor(st[RNORM], f, dev), arnorm=tensor(arnorm, f, dev),
        xnorm=tensor(st[XNORM], f, dev), bnorm=tensor(st[BNORM], f, dev), se=None,
        dxmax=tensor(dxmax, f, dev), maxdx=tensor(maxdx, i32, dev), trace=None,
    )
