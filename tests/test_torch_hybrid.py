"""The port's hybrid LSQR (lsqr_tpu_torch.hybrid) against the JAX package
(tests/test_hybrid.py).

The same numpy problems go to both packages (JAX on the CPU in x64, the
port on the CPU in f64). Bounds: the Golub–Kahan bidiagonal (alpha, beta)
within 1e-10 of JAX's and the basis within 1e-10 of JAX's (relative);
``projected_tikhonov`` and ``gcv_lambda`` equal to JAX's on the same
bidiagonal (the same numpy code); hybrid_lsqr's selected k, k_run and
lambda equal to JAX's and x within 1e-8 of JAX's; the oracles of
tests/test_hybrid.py at its tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu import hybrid as hybrid_j

from _torch_parity import rel_err, to_np


def _ill_posed(rng, m=100, n=60, noise=1e-2, decay=-5):
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = U @ np.diag(10.0 ** np.linspace(0, decay, n)) @ V.T
    x_true = V @ (rng.standard_normal(n) / (1 + np.arange(n)))
    e = rng.standard_normal(m)
    b = A @ x_true + e * noise / np.linalg.norm(e)
    return A, b, x_true


def _ops(A):
    return lt.as_operator(torch.tensor(A)), lj.DenseOperator(jnp.asarray(A))


@pytest.mark.parametrize("reorth", [True, False])
def test_golub_kahan_matches_jax(rng, reorth):
    """The bidiagonal and basis of JAX's factorization, with and without
    reorthogonalization; A V' = U B through its column norms."""
    A, b, _ = _ill_posed(rng, decay=-2)
    At, Aj = _ops(A)
    k = 12
    basis = lt.golub_kahan(At, b, k, reorth=reorth)
    basis_j = lj.golub_kahan(Aj, b, k, reorth=reorth)
    assert isinstance(basis, lt.GKBasis) and basis.k == k and basis.V.shape == (k, A.shape[1])
    np.testing.assert_allclose(to_np(basis.alpha), np.asarray(basis_j.alpha), rtol=1e-10)
    np.testing.assert_allclose(to_np(basis.beta), np.asarray(basis_j.beta), rtol=1e-10)
    np.testing.assert_allclose(basis.bidiagonal(), basis_j.bidiagonal(), rtol=1e-10,
                               atol=1e-14)
    assert rel_err(basis.V, np.asarray(basis_j.V)) < 1e-10
    V, a, beta = to_np(basis.V), to_np(basis.alpha), to_np(basis.beta)
    if reorth:
        np.testing.assert_allclose(V @ V.T, np.eye(k), atol=1e-12)
    for i in range(k):
        np.testing.assert_allclose(np.linalg.norm(A @ V[i]), np.hypot(a[i], beta[i + 1]),
                                   rtol=1e-10)


def test_reorth_keeps_orthogonality(rng):
    A, b, _ = _ill_posed(rng, decay=-6)
    At, _ = _ops(A)
    k = 40
    V_plain = to_np(lt.golub_kahan(At, b, k, reorth=False).V)
    V_ortho = to_np(lt.golub_kahan(At, b, k, reorth=True).V)
    g_plain = np.abs(V_plain @ V_plain.T - np.eye(k)).max()
    g_ortho = np.abs(V_ortho @ V_ortho.T - np.eye(k)).max()
    assert g_ortho < 1e-10 and g_plain > 1e3 * g_ortho


def test_projected_equals_lsqr_at_lam0(rng):
    """lam = 0: the projected solution at step k is the LSQR iterate."""
    A, b, _ = _ill_posed(rng, decay=-2)
    At, _ = _ops(A)
    k = 10
    basis = lt.golub_kahan(At, b, k)
    y = lt.projected_tikhonov(basis.bidiagonal(), float(basis.beta[0]), 0.0)
    ref = lt.lsqr(At, b, atol=0.0, btol=0.0, conlim=0.0, itnlim=k)
    np.testing.assert_allclose(y @ to_np(basis.V), to_np(ref.x), rtol=1e-9, atol=1e-11)


def test_projected_tikhonov_and_gcv_equal_jax(rng):
    """At k = n the projected damped solution is the damped normal-equations
    solution; projected_tikhonov and gcv_lambda give JAX's numbers."""
    A, b, _ = _ill_posed(rng, m=40, n=20, decay=-2)
    At, _ = _ops(A)
    lam = 0.1
    basis = lt.golub_kahan(At, b, 20)
    B, beta0 = basis.bidiagonal(), float(basis.beta[0])
    y = lt.projected_tikhonov(B, beta0, lam)
    np.testing.assert_array_equal(y, hybrid_j.projected_tikhonov(B, beta0, lam))
    x_exact = np.linalg.solve(A.T @ A + lam ** 2 * np.eye(20), A.T @ b)
    np.testing.assert_allclose(y @ to_np(basis.V), x_exact, rtol=1e-8, atol=1e-10)
    assert lt.gcv_lambda(B, beta0) == hybrid_j.gcv_lambda(B, beta0)
    assert lt.gcv_lambda(B, beta0, weight=0.7) == hybrid_j.gcv_lambda(B, beta0, weight=0.7)


def test_hybrid_beats_semiconvergence_and_matches_jax(rng):
    A, b, x_true = _ill_posed(rng, noise=1e-2)
    At, Aj = _ops(A)
    res = lt.hybrid_lsqr(At, b, k=40)
    res_j = lj.hybrid_lsqr(Aj, b, k=40)
    assert isinstance(res, lt.HybridResult)
    assert (res.k, res.k_run) == (res_j.k, res_j.k_run)
    assert res.lam == pytest.approx(res_j.lam, rel=1e-10)
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-8

    def err(x):
        return np.linalg.norm(to_np(x) - x_true)

    over = lt.lsqr(At, b, atol=0.0, btol=0.0, conlim=0.0, itnlim=40)
    best_plain = min(err(lt.lsqr(At, b, atol=0.0, btol=0.0, conlim=0.0, itnlim=kk).x)
                     for kk in range(1, 41, 3))
    assert err(res.x) < 0.5 * err(over.x) and err(res.x) < 1.5 * best_plain
    assert res.k <= res.k_run <= 40 and res.lam > 0


def test_hybrid_early_stop(rng):
    A, b, _ = _ill_posed(rng, noise=1e-1, decay=-8)
    At, Aj = _ops(A)
    res = lt.hybrid_lsqr(At, b, k=50, stop_window=3)
    assert res.k_run < 50 and res.gcv.shape == (res.k_run,)
    assert res.k_run == lj.hybrid_lsqr(Aj, b, k=50, stop_window=3).k_run
    assert lt.hybrid_lsqr(At, b, k=50, stop_window=3, stop_tol=1e-6).k_run >= res.k_run


def test_hybrid_fixed_lambda(rng):
    """A fixed lambda at full k reproduces lsqr with damp = lambda."""
    A, b, _ = _ill_posed(rng, m=50, n=25, decay=-2)
    At, Aj = _ops(A)
    lam = 0.05
    res = lt.hybrid_lsqr(At, b, k=25, lam=lam, stop_window=100)
    ref = lt.lsqr(At, b, damp=lam, atol=1e-13, btol=1e-13)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-6, atol=1e-9)
    res_j = lj.hybrid_lsqr(Aj, b, k=25, lam=lam, stop_window=100)
    assert res.k == res_j.k and rel_err(res.x, np.asarray(res_j.x)) < 1e-8


def test_gcv_lambda_tracks_noise(rng):
    lams = []
    for noise in (1e-4, 1e-1):
        A, b, _ = _ill_posed(rng, noise=noise)
        basis = lt.golub_kahan(_ops(A)[0], b, 30)
        lams.append(lt.gcv_lambda(basis.bidiagonal(), float(basis.beta[0]))[0])
    assert lams[1] > 10 * lams[0]


def test_basis_validation(rng):
    A, b, _ = _ill_posed(rng, m=30, n=20)
    At, _ = _ops(A)
    with pytest.raises(ValueError, match="k must be"):
        lt.golub_kahan(At, b, 0)
    with pytest.raises(ValueError, match="exceeds"):
        lt.golub_kahan(At, b, 21)
