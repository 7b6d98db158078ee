"""The plain reference: LSQR (Paige & Saunders, ACM TOMS 8(1) 1982,
Algorithm 583) over the rows of B, in float64, from two product callables.

Written from the paper's recurrence with lsqr.f90's stopping tests and
istop codes (1: test1 <= rtol, 2: test2 <= atol, 3: 2 on a damped
problem, 4: the condition limit, 5: itnlim), conlim 0 and one hit to
stop. Each row stops on its own tests; a row whose iterate at step
``snap_at[j]`` is wanted runs on to that step, and its answer stays the
one it stopped with. It imports nothing of the program and takes only the
products of the benchmark's own inputs and the right-hand sides.
"""

from __future__ import annotations

import torch


def lsqr_rows(forward, adjoint, B, damp, *, atol, btol, itnlim, snap_at=None):
    """Solve min ||[A; damp I] x_j - [b_j; 0]|| for every row b_j of B
    (k, m) in float64. ``forward(X)`` = X A^T on (k, n) and ``adjoint(U)``
    = U A on (k, m). Returns a dict of (k,) tensors (istop, itn, rnorm,
    xnorm, anorm, arnorm) and x (k, n); with ``snap_at`` ((k,) ints) also
    ``x_at``, each row's iterate after ``snap_at[j]`` steps."""
    f64 = torch.float64
    B = B.to(f64)
    k = B.shape[0]
    dev = B.device

    def norm(a):
        return torch.linalg.vector_norm(a, dim=1)

    def col(s):
        return s[:, None]

    def safe(s):
        return torch.where(s > 0, s, torch.ones_like(s))

    damp = torch.full((k,), float(damp), dtype=f64, device=dev)
    beta = norm(B)
    u = B / col(safe(beta))
    v = adjoint(u) * col((beta > 0).to(f64))
    alpha = norm(v)
    v = v / col(safe(alpha))
    w = v.clone()
    x = torch.zeros_like(v)
    zeros = torch.zeros(k, dtype=f64, device=dev)
    phibar, rhobar, bnorm = beta.clone(), alpha.clone(), beta.clone()
    anorm, dnorm2, res2, xnorm1, z, sn2 = (zeros.clone() for _ in range(6))
    cs2 = -torch.ones(k, dtype=f64, device=dev)
    rnorm, xnorm, arnorm = beta.clone(), zeros.clone(), alpha * beta
    itn = torch.zeros(k, dtype=torch.int64, device=dev)
    istop = torch.zeros(k, dtype=torch.int64, device=dev)
    # a row with b = 0 or A'b = 0 has x = 0 as its answer (istop 0)
    running = arnorm != 0
    out = {"x": x.clone(), "istop": istop.clone(), "itn": itn.clone(), "rnorm": rnorm.clone(),
           "xnorm": xnorm.clone(), "anorm": anorm.clone(), "arnorm": arnorm.clone()}
    want = None
    if snap_at is not None:
        want = torch.as_tensor(snap_at, dtype=torch.int64, device=dev)
        out["x_at"] = torch.zeros_like(x)

    for _ in range(int(itnlim)):
        go = running | ((want > itn) if want is not None else torch.zeros_like(running))
        if not bool(go.any()):
            break
        # bidiagonalization: beta u = A v - alpha u, alpha v = A'u - beta v
        u = forward(v) - col(alpha) * u
        beta_new = norm(u)
        anorm_new = torch.sqrt(anorm ** 2 + alpha ** 2 + beta_new ** 2 + damp ** 2)
        u = u / col(safe(beta_new))
        v_new = adjoint(u) - col(beta_new) * v
        alpha_new = norm(v_new)
        v_new = v_new / col(safe(alpha_new))
        v = torch.where(col(beta_new > 0), v_new, v)
        alpha = torch.where(beta_new > 0, alpha_new, alpha)
        beta, anorm = beta_new, anorm_new
        # the rotation that eliminates damp, then the one that eliminates beta
        rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)
        cs1, sn1 = rhobar / safe(rhobar1), damp / safe(rhobar1)
        psi = sn1 * phibar
        phibar = cs1 * phibar
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        cs, sn = rhobar1 / safe(rho), beta / safe(rho)
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi
        # x and w
        dk = w / col(safe(rho))
        x = x + col(phi / safe(rho)) * w
        w = v + col(-theta / safe(rho)) * w
        dnorm2 = dnorm2 + norm(dk) ** 2
        # the xnorm estimate (the right rotation)
        delta = sn2 * rho
        gambar = -cs2 * rho
        rhs = phi - delta * z
        zbar = rhs / torch.where(gambar != 0, gambar, torch.ones_like(gambar))
        xnorm = torch.sqrt(xnorm1 ** 2 + zbar ** 2)
        gamma = torch.sqrt(gambar ** 2 + theta ** 2)
        cs2, sn2 = gambar / safe(gamma), theta / safe(gamma)
        z = rhs / safe(gamma)
        xnorm1 = torch.sqrt(xnorm1 ** 2 + z ** 2)
        # norms and the stopping tests
        acond = anorm * torch.sqrt(dnorm2)
        res2 = res2 + psi ** 2
        rnorm = torch.sqrt(res2 + phibar ** 2)
        arnorm = alpha * tau.abs()
        test1 = rnorm / safe(bnorm)
        test2 = torch.where(rnorm > 0, arnorm / safe(anorm * rnorm), zeros)
        test3 = 1.0 / safe(acond)
        t1 = test1 / (1.0 + anorm * xnorm / safe(bnorm))
        rtol = btol + atol * anorm * xnorm / safe(bnorm)
        itn = itn + go.to(torch.int64)
        stop = torch.zeros_like(istop)
        stop = torch.where(itn >= itnlim, 5, stop)
        stop = torch.where(1.0 + test3 <= 1.0, 4, stop)
        stop = torch.where(1.0 + test2 <= 1.0, 2, stop)
        stop = torch.where(1.0 + t1 <= 1.0, 1, stop)
        stop = torch.where(test2 <= atol, 2, stop)
        stop = torch.where(test1 <= rtol, 1, stop)
        done = running & (stop != 0)
        for name, value in (("x", x), ("istop", stop), ("itn", itn), ("rnorm", rnorm),
                            ("xnorm", xnorm), ("anorm", anorm), ("arnorm", arnorm)):
            mask = col(done) if value.dim() == 2 else done
            out[name] = torch.where(mask, value, out[name])
        if want is not None:
            out["x_at"] = torch.where(col(go & (itn == want)), x, out["x_at"])
        running = running & (stop == 0)
    out["istop"] = torch.where((damp > 0) & (out["istop"] == 2), 3, out["istop"])
    return out
