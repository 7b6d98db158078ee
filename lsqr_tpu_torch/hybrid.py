"""Hybrid LSQR: Golub–Kahan projection plus Tikhonov on the projected problem.

PyTorch counterpart of :mod:`lsqr_tpu.hybrid` (Chung, Nagy & O'Leary 2008
"HyBR"; O'Leary & Simmons 1981). Plain LSQR semiconverges on a noisy
ill-posed problem; the hybrid method regularizes the PROJECTED problem:

1. run the Golub–Kahan bidiagonalization of (A, b), LSQR's recurrence
   (lsqr.f90:681-699), keeping the right Lanczos basis V_k and the
   bidiagonal coefficients (alpha, beta);
2. at each k solve the (k+1) x k Tikhonov problem
       min || B_k y - beta_1 e_1 ||^2 + lam^2 ||y||^2
   with ``lam`` chosen by GCV on the projected problem (numpy on the host:
   B_k is tiny);
3. x_k = V_k y_k; stop when the GCV minimum stops improving.

The products and the (k, n) basis live on the operator's device: each step
is the two products of an LSQR iteration (the operator's own kernels) and,
with ``reorth``, two (k, n) matrix-vector products against the basis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import default_dtype
from .ops.blas import nrm2
from .ops.linop import as_operator, as_tensor, to_numpy

__all__ = ["GKBasis", "golub_kahan", "HybridResult", "hybrid_lsqr",
           "projected_tikhonov", "gcv_lambda"]


class GKBasis(NamedTuple):
    """A k-step Golub–Kahan bidiagonalization of (A, b):
    ``A V_k' = U_{k+1} B_k`` with ``B_k`` lower-bidiagonal (diagonal
    ``alpha``, subdiagonal ``beta[1:]``), ``beta[0] = ||b||``.

    V is stored row-major: V[i] is the i-th right Lanczos vector (n,)."""

    V: torch.Tensor       #: (k, n) right Lanczos basis
    alpha: torch.Tensor   #: (k,) B_k diagonal (real)
    beta: torch.Tensor    #: (k+1,) beta[0] = ||b||, beta[1:] = subdiagonal
    k: int                #: steps taken

    def bidiagonal(self) -> np.ndarray:
        """B_k as a dense (k+1, k) numpy array."""
        k = self.k
        B = np.zeros((k + 1, k))
        B[np.arange(k), np.arange(k)] = to_numpy(self.alpha)
        B[np.arange(1, k + 1), np.arange(k)] = to_numpy(self.beta[1:])
        return B


def _gk(A, b, k: int, reorth: bool, safe_norms: bool):
    """The bidiagonalization on A's device, as the JAX package's loop:
    (V, alphas, betas) with complex Lanczos vectors for a complex problem
    and real coefficients (rmatvec is the conjugate-transpose product)."""
    n = A.n
    dtype, dev = b.dtype, b.device
    rdtype = torch.empty((), dtype=dtype).real.dtype if dtype.is_complex else dtype
    zero = torch.zeros((), dtype=rdtype, device=dev)
    one = torch.ones((), dtype=rdtype, device=dev)

    def norm(vec):
        return nrm2(vec, safe=safe_norms)

    beta0 = norm(b)
    u = torch.where(beta0 > zero, b / torch.where(beta0 > zero, beta0, one), b)
    v0u = A.rmatvec(u)
    alpha0 = norm(v0u)
    v = torch.where(alpha0 > zero, v0u / torch.where(alpha0 > zero, alpha0, one), v0u)

    V = torch.zeros((k, n), dtype=dtype, device=dev)
    V[0] = v
    alphas, betas = [alpha0], [beta0]
    for i in range(1, k):
        u_new = A.matvec(v) - alphas[i - 1] * u
        beta_new = norm(u_new)
        bpos = beta_new > zero
        u_new = torch.where(bpos, u_new / torch.where(bpos, beta_new, one), u_new)
        v_cand = A.rmatvec(u_new) - beta_new * v
        if reorth:
            # full one-sided reorthogonalization against the stored basis
            # (rows past i - 1 are still zero): coefficients <v_i, v_cand>
            # = conj(V) @ v_cand
            coeff = (V.conj() if V.is_complex() else V) @ v_cand
            v_cand = v_cand - V.T @ coeff
        alpha_new = norm(v_cand)
        apos = alpha_new > zero
        v = torch.where(apos, v_cand / torch.where(apos, alpha_new, one), v_cand)
        u = u_new
        V[i] = v
        alphas.append(alpha_new)
        betas.append(beta_new)
    # the trailing beta_{k+1} closes B_k's last column
    betas.append(norm(A.matvec(v) - alphas[k - 1] * u))
    return V, torch.stack(alphas), torch.stack(betas)


def golub_kahan(A, b, k: int, *, reorth: bool = True, safe_norms: bool = True) -> GKBasis:
    """k steps of Golub–Kahan bidiagonalization of (A, b) with the right
    Lanczos basis kept (fully reorthogonalized with ``reorth``).

    Memory: the (k, n) basis. Cost per step: an LSQR iteration's two
    products, plus two (k, n) matrix-vector products with ``reorth``."""
    A = as_operator(A)
    b = as_tensor(b, device=A.device)
    if not (b.dtype.is_floating_point or b.dtype.is_complex):
        b = b.to(default_dtype())
    if k < 1:
        raise ValueError("k must be >= 1")
    kmax = int(min(A.m, A.n))
    if k > kmax:
        raise ValueError(f"k = {k} exceeds min(m, n) = {kmax}")
    V, alphas, betas = _gk(A, b, k, reorth, safe_norms)
    return GKBasis(V=V, alpha=alphas, beta=betas, k=k)


# ---------------------------------------------------------------------------
# The projected problem (numpy on the host: B_k is (k+1, k), tiny)
# ---------------------------------------------------------------------------


def projected_tikhonov(B: np.ndarray, beta0: float, lam: float) -> np.ndarray:
    """Solve ``min ||B y - beta0 e1||^2 + lam^2 ||y||^2`` for the tiny
    projected bidiagonal system (dense SVD; exact)."""
    P, s, Qt = np.linalg.svd(B, full_matrices=False)
    rhs = P.T[:, 0] * beta0          # P' (beta0 e1)
    f = s / (s**2 + lam**2)          # Tikhonov filter factors
    return Qt.T @ (f * rhs)


def gcv_lambda(B: np.ndarray, beta0: float, *,
               grid: Optional[np.ndarray] = None,
               weight: float = 1.0) -> tuple[float, float]:
    """GCV-minimizing lambda for the projected problem (Golub-Heath-Wahba;
    the weighted variant of Chung-Nagy-O'Leary 2008 via ``weight`` = omega).

    GCV(lam) = k * ||B y - beta0 e1||^2_aug / (m_p - weight * sum(f_i))^2
    evaluated exactly through the SVD of B. Returns (lam, gcv_min).
    """
    P, s, _ = np.linalg.svd(B, full_matrices=False)
    m_p = B.shape[0]
    bt = P[0, :] * beta0                         # P' (beta0 e1), length k
    # residual component outside span(P)
    r_perp2 = beta0**2 - float(bt @ bt)
    if grid is None:
        smax, smin = float(s.max()), float(max(s.min(), 1e-300))
        grid = np.logspace(np.log10(smin) - 2, np.log10(smax) + 1, 200)
    best = (float(grid[0]), np.inf)
    for lam in grid:
        f = s**2 / (s**2 + lam**2)               # hat-matrix eigenvalues
        resid2 = float(np.sum(((1 - f) * bt) ** 2)) + max(r_perp2, 0.0)
        denom = m_p - weight * float(np.sum(f))
        g = m_p * resid2 / denom**2
        if g < best[1]:
            best = (float(lam), g)
    return best


class HybridResult(NamedTuple):
    """Hybrid-LSQR outputs."""

    x: torch.Tensor       #: (n,) regularized solution V_k' y
    lam: float            #: lambda chosen at the selected iteration
    k: int                #: selected iteration (projected-GCV stopping)
    k_run: int            #: bidiagonalization steps actually taken
    gcv: np.ndarray       #: (k_run,) per-iteration GCV minima
    lambdas: np.ndarray   #: (k_run,) per-iteration GCV-chosen lambdas
    basis: GKBasis        #: the factorization (reusable for other rhs/lams)


def hybrid_lsqr(
    A,
    b,
    k: int = 50,
    *,
    lam: Optional[float] = None,
    weight: float = 1.0,
    reorth: bool = True,
    stop_window: int = 4,
    stop_tol: float = 1e-4,
    safe_norms: bool = True,
) -> HybridResult:
    """Hybrid regularization: LSQR's bidiagonalization + per-iteration
    Tikhonov on the projected problem with GCV-chosen lambda.

    Args:
      k: maximum bidiagonalization steps (the (k, n) basis is stored).
      lam: fix lambda instead of choosing it by GCV per iteration.
      weight: GCV weight omega (1.0 = plain GCV; < 1 is the W-GCV of
        Chung-Nagy-O'Leary, smoother for severely ill-posed problems).
      reorth: full reorthogonalization of the v-basis (keeps the projected
        problem faithful; strongly recommended — it is what makes this
        reliable in f32).
      stop_window: stop early once the per-iteration GCV minimum has not
        improved *significantly* for this many consecutive steps
        (semiconvergence detection); the basis is still returned up to the
        stop point.
      stop_tol: an improvement counts as significant only if it exceeds
        ``stop_tol * GCV(1)`` — the flat-GCV criterion of HyBR, measured
        against the initial GCV scale (the per-step decrement decays toward
        zero but rarely reaches exactly zero, so a relative-to-current-best
        test would never fire).

    Returns a :class:`HybridResult`; ``result.basis`` can be reused (e.g.
    re-solve with a different lambda via :func:`projected_tikhonov`
    without touching A again).
    """
    A = as_operator(A)
    basis = golub_kahan(A, b, k, reorth=reorth, safe_norms=safe_norms)
    alphas = to_numpy(basis.alpha).astype(np.float64)
    betas = to_numpy(basis.beta).astype(np.float64)
    beta0 = float(betas[0])

    gcv_hist = np.full((k,), np.inf)
    lam_hist = np.zeros((k,))
    best_k, best_gcv, best_lam = 1, np.inf, 0.0
    since_improve = 0
    for kk in range(1, k + 1):
        B = np.zeros((kk + 1, kk))
        B[np.arange(kk), np.arange(kk)] = alphas[:kk]
        B[np.arange(1, kk + 1), np.arange(kk)] = betas[1:kk + 1]
        if lam is None:
            lam_k, g = gcv_lambda(B, beta0, weight=weight)
        else:
            lam_k = float(lam)
            y = projected_tikhonov(B, beta0, lam_k)
            r = B @ y
            r[0] -= beta0
            # the same GCV objective, evaluated at the fixed lambda
            P, s, _ = np.linalg.svd(B, full_matrices=False)
            f = s**2 / (s**2 + lam_k**2)
            g = (kk + 1) * float(r @ r) / (
                (kk + 1) - weight * float(np.sum(f))) ** 2
        gcv_hist[kk - 1] = g
        lam_hist[kk - 1] = lam_k
        significant = g < best_gcv - stop_tol * gcv_hist[0]
        if g < best_gcv:
            best_k, best_gcv, best_lam = kk, g, lam_k
        if significant:
            since_improve = 0
        else:
            since_improve += 1
            if since_improve >= stop_window:
                break
    k_run = kk

    Bb = np.zeros((best_k + 1, best_k))
    Bb[np.arange(best_k), np.arange(best_k)] = alphas[:best_k]
    Bb[np.arange(1, best_k + 1), np.arange(best_k)] = betas[1:best_k + 1]
    y = projected_tikhonov(Bb, beta0, best_lam)
    x = as_tensor(y, dtype=basis.V.dtype, device=basis.V.device) @ basis.V[:best_k]
    return HybridResult(
        x=x, lam=best_lam, k=best_k, k_run=k_run,
        gcv=gcv_hist[:k_run], lambdas=lam_hist[:k_run], basis=basis,
    )
