"""Complex problems across the port's solver family, against the JAX package
and the oracles of its ``tests/test_complex.py`` (scipy's lsqr and lsmr,
which take complex the same way, and closed forms).

Over C the Paige–Saunders bidiagonalization holds with A' read as the
conjugate transpose: alpha, beta and every rotation scalar and norm estimate
are real, the vectors complex. Both packages run in complex128 on the CPU
(x64 for JAX), complex64 where a case says so. The sharded solvers' cases
wait for the port's distribution layer.
"""

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg as sla
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

from _torch_parity import DEV, to_np


def _cproblem(rng, m=60, n=35, damp=0.1):
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    return A, b, damp


def _ccoo(rng, m=70, n=40, nnz=400):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    dense = np.zeros((m, n), complex)
    np.add.at(dense, (rows, cols), vals)
    return rows, cols, vals, dense


def _damped_solution(A, b, damp):
    n = A.shape[1]
    return np.linalg.solve(A.conj().T @ A + damp ** 2 * np.eye(n), A.conj().T @ b)


def _dense(A):
    return lt.as_operator(A, device=DEV)


def test_complex_operator_products(rng):
    """tests/test_complex.py:38-52: COO, dense and .T products."""
    rows, cols, vals, dense = _ccoo(rng)
    m, n = dense.shape
    A = lt.coo_operator(m, n, vals, rows, cols, device=DEV)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(to_np(A.matvec(xt)), dense @ x, rtol=1e-12)
    np.testing.assert_allclose(to_np(A.rmatvec(yt)), dense.conj().T @ y, rtol=1e-12)
    D = _dense(dense)
    np.testing.assert_allclose(to_np(D.rmatvec(yt)), dense.conj().T @ y, rtol=1e-12)
    np.testing.assert_allclose(to_np(A.T.matvec(yt)), dense.conj().T @ y, rtol=1e-12)
    np.testing.assert_allclose(to_np(D.T.rmatvec(xt)), dense @ x, rtol=1e-12)
    # a real dense matrix takes complex vectors, as in JAX
    R = rng.standard_normal((m, n))
    np.testing.assert_allclose(to_np(_dense(R).rmatvec(yt)), R.T @ y, rtol=1e-12)
    # a (matvec, rmatvec) pair through as_operator
    Dt = torch.from_numpy(dense)
    C = lt.as_operator((lambda v: Dt @ v, lambda w: Dt.mH @ w), m, n)
    np.testing.assert_allclose(to_np(C.rmatvec(yt)), dense.conj().T @ y, rtol=1e-12)


def test_acheck_complex_and_catches_missing_conj(rng):
    """tests/test_complex.py:55-62 in both packages."""
    A, _, _ = _cproblem(rng)
    At = torch.from_numpy(A)
    assert int(lt.acheck(_dense(A)).inform) == int(lj.acheck(lj.as_operator(A)).inform) == 0
    bad = lt.CallbackOperator(m=A.shape[0], n=A.shape[1],
                              _matvec=lambda x: At @ x.to(At.dtype),
                              _rmatvec=lambda y: At.T @ y.to(At.dtype), dtype=torch.complex128)
    bad_j = lj.CallbackOperator(m=A.shape[0], n=A.shape[1], _matvec=lambda x: A @ x,
                                _rmatvec=lambda y: A.T @ y)
    res, res_j = lt.acheck(bad), lj.acheck(bad_j)
    assert int(res.inform) == int(res_j.inform) == 1
    # the same unit vectors: the same error
    assert float(res.error) == pytest.approx(float(res_j.error), rel=1e-6)


def test_lsqr_complex_matches_scipy_and_jax(rng):
    """tests/test_complex.py:69-80."""
    A, b, damp = _cproblem(rng)
    res = lt.lsqr(_dense(A), b, damp, atol=1e-12, btol=1e-12)
    ref = sla.lsqr(scipy.sparse.csr_matrix(A), b, damp=damp, atol=1e-12, btol=1e-12)
    res_j = lj.lsqr(A, b, damp, atol=1e-12, btol=1e-12)
    assert int(res.itn) == ref[2] == int(res_j.itn)
    assert int(res.istop) == int(res_j.istop) == 3
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-10)
    np.testing.assert_allclose(to_np(res.x), _damped_solution(A, b, damp), atol=1e-10)
    for f in ("rnorm", "xnorm", "bnorm"):
        assert getattr(res, f).dtype == torch.float64
        np.testing.assert_allclose(float(getattr(res, f)), float(getattr(res_j, f)), rtol=1e-8)
    # anorm and acond add alpha, beta and ||d_k|| past the Krylov space's end
    # (itn > n), where each package follows its own rounding; ||A'r|| at
    # convergence is rounding noise, held to its scale
    for f in ("anorm", "acond"):
        np.testing.assert_allclose(float(getattr(res, f)), float(getattr(res_j, f)), rtol=1e-3)
    assert abs(float(res.arnorm) - float(res_j.arnorm)) <= 1e-9 * float(res.anorm * res.rnorm)


def test_lsqr_complex_coo_and_xcheck(rng):
    """tests/test_complex.py:83-94."""
    rows, cols, vals, dense = _ccoo(rng)
    m, n = dense.shape
    A = lt.coo_operator(m, n, vals, rows, cols, device=DEV)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    res = lt.lsqr(A, b, 0.05, atol=1e-12, btol=1e-12)
    ref = sla.lsqr(scipy.sparse.csr_matrix(dense), b, damp=0.05, atol=1e-12, btol=1e-12)
    assert abs(int(res.itn) - ref[2]) <= 1
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-9)
    xc = lt.xcheck(A, b=b, x=res.x, damp=0.05, anorm=res.anorm)
    xj = lj.xcheck(lj.coo_operator(m, n, vals, rows, cols), b=b, x=to_np(res.x), damp=0.05,
                   anorm=float(res.anorm))
    assert int(xc.inform) == int(xj.inform) == 3
    for f in ("test1", "test2", "test3", "rnorm"):
        assert getattr(xc, f).dtype == torch.float64
    np.testing.assert_allclose(float(xc.test1), float(xj.test1), rtol=1e-6)
    np.testing.assert_allclose(float(xc.rnorm), float(xj.rnorm), rtol=1e-12)
    # test2 and test3 of a converged x are rounding noise (~1e-13)
    for f in ("test2", "test3"):
        assert abs(float(getattr(xc, f)) - float(getattr(xj, f))) <= 1e-11


def test_lsqr_complex_wantse_trace_warmstart(rng):
    """tests/test_complex.py:97-111: se, the trace, and the warm start,
    undamped and damped (the stacked form; JAX's istop, itn and x)."""
    A, b, damp = _cproblem(rng, m=50, n=20)
    res = lt.lsqr(_dense(A), b, damp, wantse=True, record_trace=True, itnlim=40)
    assert res.se.shape == (20,) and not res.se.is_complex()
    assert not res.trace.is_complex() and res.trace.dtype == torch.float64
    # against JAX before the Krylov space is exhausted (n = 20 iterations;
    # past it both follow their rounding)
    res = lt.lsqr(_dense(A), b, damp, wantse=True, record_trace=True, itnlim=15)
    res_j = lj.lsqr(A, b, damp, wantse=True, record_trace=True, itnlim=15)
    assert int(res.itn) == int(res_j.itn) == 15
    np.testing.assert_allclose(to_np(res.se), np.asarray(res_j.se), rtol=1e-10)
    np.testing.assert_allclose(to_np(res.trace), np.asarray(res_j.trace), rtol=1e-10,
                               atol=1e-13)
    # the trace's x0 column is Re x[0]
    itn = int(res.itn)
    assert float(res.trace[itn, 1]) == pytest.approx(float(res.x[0].real), rel=1e-12)
    ref = lt.lsqr(_dense(A), b, 0.0, atol=1e-12, btol=1e-12)
    x0 = to_np(ref.x) + 1e-6 * (rng.standard_normal(20) + 1j * rng.standard_normal(20))
    res2 = lt.lsqr(_dense(A), b, 0.0, x0=x0, atol=1e-12, btol=1e-12)
    assert int(res2.itn) < int(ref.itn)
    np.testing.assert_allclose(to_np(res2.x), to_np(ref.x), atol=1e-9)
    res3 = lt.lsqr(_dense(A), b, damp, x0=x0, atol=1e-12, btol=1e-12)
    res3_j = lj.lsqr(A, b, damp, x0=x0, atol=1e-12, btol=1e-12)
    assert int(res3.istop) == int(res3_j.istop) and int(res3.itn) == int(res3_j.itn)
    np.testing.assert_allclose(to_np(res3.x), np.asarray(res3_j.x), atol=1e-10)
    np.testing.assert_allclose(to_np(res3.x), _damped_solution(A, b, damp), atol=1e-9)


def test_lsmr_complex_matches_scipy_and_jax(rng):
    """tests/test_complex.py:114-121."""
    A, b, damp = _cproblem(rng, m=70, n=40)
    res = lt.lsmr(_dense(A), b, damp, atol=1e-10, btol=1e-10, record_trace=True)
    ref = sla.lsmr(scipy.sparse.csr_matrix(A), b, damp=damp, atol=1e-10, btol=1e-10)
    res_j = lj.lsmr(A, b, damp, atol=1e-10, btol=1e-10)
    assert int(res.itn) == ref[2] == int(res_j.itn)
    assert int(res.istop) == int(res_j.istop)
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-8)
    np.testing.assert_allclose(to_np(res.x), np.asarray(res_j.x), atol=1e-10)
    assert not res.trace.is_complex() and not res.normr.is_complex()


def test_cgls_complex_closed_form(rng):
    """tests/test_complex.py:124-129."""
    A, b, damp = _cproblem(rng)
    res = lt.cgls(_dense(A), b, damp, atol=1e-12, btol=1e-12)
    res_j = lj.cgls(A, b, damp, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(res.x), _damped_solution(A, b, damp), atol=1e-10)
    assert int(res.istop) == int(res_j.istop) and abs(int(res.itn) - int(res_j.itn)) <= 1


def test_craig_complex_minimum_norm(rng):
    """tests/test_complex.py:132-139."""
    m, n = 30, 50
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = A @ (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    res = lt.craig(_dense(A), b, atol=1e-13, btol=1e-13, itnlim=200)
    res_j = lj.craig(A, b, atol=1e-13, btol=1e-13, itnlim=200)
    assert int(res.istop) in (1, 2) and int(res.istop) == int(res_j.istop)
    np.testing.assert_allclose(to_np(res.x), np.linalg.pinv(A) @ b, atol=1e-9)


def test_lsqr_complex_underdetermined_min_norm(rng):
    """tests/test_complex.py:142-149."""
    m, n = 25, 45
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    res = lt.lsqr(_dense(A), b, 0.0, atol=1e-13, btol=1e-13)
    assert int(res.istop) == 1
    np.testing.assert_allclose(to_np(res.x), np.linalg.pinv(A) @ b, atol=1e-9)


def test_complex64_single_precision(rng):
    """tests/test_complex.py:152-160."""
    A, b, damp = _cproblem(rng, m=40, n=20)
    res = lt.lsqr(_dense(A.astype(np.complex64)), b.astype(np.complex64), damp,
                  atol=1e-5, btol=1e-5)
    assert res.x.dtype == torch.complex64 and res.rnorm.dtype == torch.float32
    np.testing.assert_allclose(to_np(res.x), _damped_solution(A, b, damp), atol=1e-3)


def test_complex_interop_routing(rng):
    """tests/test_complex.py:183-204, and csr_operator."""
    rows, cols, vals, dense = _ccoo(rng, m=40, n=30, nnz=200)
    sp = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(40, 30))
    A = lt.from_scipy(sp, device=DEV)
    assert type(A).__name__ == type(lj.from_scipy(sp)).__name__ == "ZJDIAOperator"
    for pkg, kw in ((lt, dict(device=DEV)), (lj, {})):
        with pytest.raises(ValueError, match="real-only"):
            pkg.from_scipy(sp, format="ell", **kw)
    Ad = lt.from_scipy(sp, format="dia", device=DEV)
    assert isinstance(Ad, lt.ZDIAOperator)
    x = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(to_np(Ad.matvec(xt)), dense @ x, rtol=1e-11)
    np.testing.assert_allclose(to_np(A.matvec(xt)), dense @ x, rtol=1e-11)
    csr = sp.tocsr()
    C = lt.csr_operator(40, 30, csr.indptr, csr.indices, csr.data, format="coo", device=DEV)
    np.testing.assert_allclose(to_np(C.matvec(xt)), dense @ x, rtol=1e-11)
    with pytest.raises(ValueError, match="real-only"):
        lt.csr_operator(40, 30, csr.indptr, csr.indices, csr.data, format="ell", device=DEV)


def test_ez_api_complex(rng):
    """tests/test_complex.py:383-397: LSQRSolver takes a complex COO triple."""
    m, n, nnz = 40, 25, 200
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    solver = lt.LSQRSolver(m, n, v, r, c, atol=1e-12, btol=1e-12, itnlim=200, device=DEV)
    res = solver.solve(b, damp=0.1)
    dense = np.zeros((m, n), complex)
    np.add.at(dense, (r, c), v)
    np.testing.assert_allclose(to_np(res.x), _damped_solution(dense, b, 0.1), atol=1e-9)
    assert lt.result_to_numpy(res)["x"].dtype == np.complex128
    assert int(solver.acheck().inform) == 0


def test_complex_routes_that_raise(rng):
    """The megakernels and the fused half-steps are real-f32 only; a damped
    x0 (item 9) now solves in lsqr, lsmr and cgls as JAX's does."""
    A, b, _ = _cproblem(rng, m=30, n=20)
    D = _dense(A)
    for fn in (lt.lsqr, lt.lsmr, lt.craig):
        with pytest.raises(ValueError, match="megakernel=True requires"):
            fn(D, b, megakernel=True)
    Z = lt.dia_operator(30, 30, (0, 1), np.ones((2, 30), np.complex128), device=DEV)
    with pytest.raises(ValueError, match="fused_halfstep"):
        lt.lsqr(Z, b, fused=True, pair=False)
    for name in ("lsqr", "lsmr", "cgls"):
        rt = getattr(lt, name)(D, b, 0.1, x0=np.zeros(20, complex))
        rj = getattr(lj, name)(A, b, 0.1, x0=np.zeros(20, complex))
        assert int(rt.istop) == int(rj.istop) and int(rt.itn) == int(rj.itn)
        np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), atol=1e-10)


# ---------------------------------------------------------------------------
# composites, checkpoints, refinement, hybrid regularization and LSRN over C
# ---------------------------------------------------------------------------


def test_complex_composites_adjoint(rng):
    """tests/test_complex.py:162-177: a stack of A over alpha * diag(d)
    conjugates alpha and d in its adjoint, as JAX's does."""
    A, _, _ = _cproblem(rng, m=30, n=20)
    d = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    alpha = 0.7 - 0.3j
    op = lt.vstack_operators([_dense(A), lt.scale_operator(lt.diagonal_operator(d, device=DEV),
                                                           alpha)])
    op_j = lj.vstack_operators([lj.as_operator(A),
                                lj.scale_operator(lj.diagonal_operator(d), alpha)])
    assert int(lt.acheck(op).inform) == 0
    dense = np.vstack([A, alpha * np.diag(d)])
    y = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    got = to_np(op.rmatvec(torch.from_numpy(y)))
    np.testing.assert_allclose(got, dense.conj().T @ y, rtol=1e-11)
    np.testing.assert_allclose(got, np.asarray(op_j.rmatvec(y)), rtol=1e-12)


def test_checkpoint_resume_complex(rng, tmp_path):
    """tests/test_complex.py:282: segments and a resume from the written
    carry give the one-shot solve's complex x bit for bit."""
    A, b, damp = _cproblem(rng)
    ref = lt.lsqr(_dense(A), b, damp, atol=1e-12, btol=1e-12)
    path = str(tmp_path / "carry.npz")
    res = lt.lsqr_checkpointed(_dense(A), b, damp, segment_iters=7, checkpoint_path=path,
                               atol=1e-12, btol=1e-12)
    assert int(res.itn) == int(ref.itn) and torch.equal(res.x, ref.x)
    again = lt.lsqr_checkpointed(_dense(A), b, damp, segment_iters=7, resume_from=path,
                                 atol=1e-12, btol=1e-12)
    assert torch.equal(again.x, ref.x) and again.x.is_complex()
    ref_j = lj.lsqr(A, b, damp, atol=1e-12, btol=1e-12)
    assert int(res.itn) == int(ref_j.itn)
    np.testing.assert_allclose(to_np(res.x), np.asarray(ref_j.x), atol=1e-10)


def _ill_conditioned_complex(rng, m, n, cond):
    U, _ = np.linalg.qr(rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return (U * np.logspace(0, -np.log10(cond), n)) @ V.conj().T


@pytest.mark.parametrize("cond", [1e2, 1e4], ids=["plain", "preconditioned"])
def test_refine_complex_matches_jax(rng, cond):
    """tests/test_complex.py:335-362: complex64 solves and complex128 host
    residuals reach the c128 LS solution of the stored matrix; at cond 1e4
    the auto-LSRN path takes over (complex Gaussian sketch). JAX's switch
    and x (1e-9), its cycle count within 1 (the complex64 inner solves sum
    in other orders, and ||dx|| can cross tol * ||x|| a cycle apart)."""
    m, n = 120, 60
    A32 = _ill_conditioned_complex(rng, m, n, cond).astype(np.complex64)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    xtrue = np.linalg.lstsq(A32.astype(np.complex128), b, rcond=None)[0]
    res = lt.lsqr_refined(_dense(A32), b)
    res_j = lj.lsqr_refined(lj.as_operator(A32), b)
    assert res.x.dtype == np.complex128 and res.results[0].x.dtype == torch.complex64
    assert res.preconditioned == (cond > 1e3) == res_j.preconditioned
    assert abs(res.cycles - res_j.cycles) <= 1
    rel = np.abs(res.x - xtrue).max() / np.abs(xtrue).max()
    assert rel < (1e-12 if cond < 1e3 else 1e-9)
    assert np.abs(res.x - res_j.x).max() / np.abs(xtrue).max() < 1e-9


def test_refine_complex_damped_and_min_norm(rng):
    """tests/test_complex.py:365-380."""
    mu, nu = 40, 80
    Au = (rng.standard_normal((mu, nu)) + 1j * rng.standard_normal((mu, nu))).astype(
        np.complex64)
    bu = rng.standard_normal(mu) + 1j * rng.standard_normal(mu)
    Ad = Au.astype(np.complex128)
    resd = lt.lsqr_refined(_dense(Au), bu, 0.1)
    xd = Ad.conj().T @ np.linalg.solve(Ad @ Ad.conj().T + 0.01 * np.eye(mu), bu)
    np.testing.assert_allclose(resd.x, xd, atol=1e-12)
    resm = lt.lsqr_refined(_dense(Au), bu, 0.0)
    np.testing.assert_allclose(resm.x, np.linalg.pinv(Ad) @ bu, atol=1e-12)
    assert abs(resm.cycles - lj.lsqr_refined(lj.as_operator(Au), bu, 0.0).cycles) <= 1


def test_golub_kahan_complex_factorization(rng):
    """tests/test_complex.py:422-448: conj-orthonormal V, a real bidiagonal
    (JAX's within 1e-10), the projected-norm identity, and the full-k
    projected Tikhonov equal to the damped closed form."""
    m, n = 40, 20
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    basis = lt.golub_kahan(_dense(A), b, n)
    basis_j = lj.golub_kahan(A, b, n)
    V = to_np(basis.V)
    assert not basis.alpha.is_complex()
    np.testing.assert_allclose(V.conj() @ V.T, np.eye(n), atol=1e-12)
    B, beta0 = basis.bidiagonal(), float(basis.beta[0])
    np.testing.assert_allclose(B, basis_j.bidiagonal(), rtol=1e-10, atol=1e-14)
    y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    e1 = np.zeros(n + 1)
    e1[0] = beta0
    np.testing.assert_allclose(np.linalg.norm(A @ (y @ V) - b), np.linalg.norm(B @ y - e1),
                               rtol=1e-12)
    x = lt.projected_tikhonov(B, beta0, 0.3) @ V
    np.testing.assert_allclose(x, _damped_solution(A, b, 0.3), atol=1e-12)


def test_hybrid_lsqr_complex_runs_gcv(rng):
    """tests/test_complex.py:435: complex x, finite, JAX's selected k."""
    m, n = 60, 30
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    res = lt.hybrid_lsqr(_dense(A), b, k=20)
    res_j = lj.hybrid_lsqr(A, b, k=20)
    assert res.x.is_complex() and bool(torch.isfinite(res.x.real).all())
    assert 1 <= res.k <= 20 and (res.k, res.k_run) == (res_j.k, res_j.k_run)
    np.testing.assert_allclose(to_np(res.x), np.asarray(res_j.x), atol=1e-8)


def test_lsrn_complex_conditioning_independent(rng):
    """tests/test_complex.py:449-462: a complex Gaussian sketch keeps the
    iterations at the cond(AN) <~ 3 level for a cond-1e6 matrix."""
    m, n = 150, 60
    A = _ill_conditioned_complex(rng, m, n, 1e6)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    res = lt.lsrn(_dense(A), b, atol=1e-12, btol=1e-12)
    xt = np.linalg.lstsq(A, b, rcond=None)[0]
    assert np.abs(to_np(res.x) - xt).max() / np.abs(xt).max() < 1e-8
    assert int(res.result.itn) < 60
    res_j = lj.lsrn(A, b, atol=1e-12, btol=1e-12)
    assert np.abs(to_np(res.x) - np.asarray(res_j.x)).max() / np.abs(xt).max() < 1e-7


def test_lsrn_complex_underdetermined_and_damped(rng):
    """tests/test_complex.py:465-476."""
    mu, nu = 50, 120
    Au = rng.standard_normal((mu, nu)) + 1j * rng.standard_normal((mu, nu))
    bu = rng.standard_normal(mu) + 1j * rng.standard_normal(mu)
    resu = lt.lsrn(_dense(Au), bu, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(resu.x), np.linalg.pinv(Au) @ bu, atol=1e-10)
    m, n = 80, 40
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    resd = lt.lsrn(_dense(A), b, damp=0.1, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(resd.x), _damped_solution(A, b, 0.1), atol=1e-9)


def _crel(got, ref):
    """max |got - ref| / max |ref| over complex values."""
    got, ref = to_np(got).astype(np.complex128), np.asarray(ref, np.complex128)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_multidamp_complex_bitwise_matches_standalone(rng):
    """tests/test_complex.py:227-241: each damp's x bit for bit the port's
    standalone solve; against JAX's sweep istop equal, itn within 1 and x
    within 1e-9 (the standalone solves' band, ROADMAP Queue 3)."""
    A, b, _ = _cproblem(rng)
    damps = [0.0, 0.05, 0.5]
    At = _dense(A)
    for solver in ("lsqr", "lsmr"):
        res = getattr(lt, solver + "_multidamp")(At, b, damps, atol=1e-12, btol=1e-12)
        res_j = getattr(lj, solver + "_multidamp")(A, b, damps, atol=1e-12, btol=1e-12)
        np.testing.assert_array_equal(to_np(res.istop), np.asarray(res_j.istop))
        assert np.abs(to_np(res.itn) - np.asarray(res_j.itn)).max() <= 1
        for i, d in enumerate(damps):
            ref = getattr(lt, solver)(At, b, d, atol=1e-12, btol=1e-12)
            assert int(res.itn[i]) == int(ref.itn) and int(res.istop[i]) == int(ref.istop)
            assert torch.equal(res.x[i], ref.x)
            assert _crel(res.x[i], res_j.x[i]) <= 1e-9


def test_batch_complex_matches_sequential(rng):
    """tests/test_complex.py:244-268: every column bit for bit the port's
    standalone solve (where JAX's test allows 1e-12 to 1e-8); against JAX's
    batches istop equal, itn within 1 and x within 1e-9 (LSMR 1e-5: it stops
    at its limit of n iterations, at Krylov exhaustion, where x parts by
    4e-6 in the standalone solves)."""
    from lsqr_tpu.batch import cgls_batch, lsmr_batch, lsqr_batch

    m, n, nnz, k = 50, 30, 300, 3
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    A = lt.coo_operator(m, n, v, r, c, device=DEV)
    A_j = lj.coo_operator(m, n, v, r, c)
    B = rng.standard_normal((k, m)) + 1j * rng.standard_normal((k, m))
    for solver, fn_j, tol, x_rel in (("lsqr", lsqr_batch, 1e-12, 1e-9),
                                     ("lsmr", lsmr_batch, 1e-10, 1e-5),
                                     ("cgls", cgls_batch, 1e-10, 1e-9)):
        res = getattr(lt, solver + "_batch")(A, B, 0.05, atol=tol, btol=tol)
        res_j = fn_j(A_j, B, 0.05, atol=tol, btol=tol)
        np.testing.assert_array_equal(to_np(res.istop), np.asarray(res_j.istop))
        assert np.abs(to_np(res.itn) - np.asarray(res_j.itn)).max() <= 1
        for i in range(k):
            ref = getattr(lt, solver)(A, B[i], 0.05, atol=tol, btol=tol)
            assert int(res.itn[i]) == int(ref.itn) and torch.equal(res.x[i], ref.x)
            assert _crel(res.x[i], res_j.x[i]) <= x_rel


def test_real_only_modules_raise_clear_errors(rng):
    """tests/test_complex.py:271-279: lsqr_grad refuses complex input."""
    A, b, _ = _cproblem(rng, m=30, n=20)
    with pytest.raises(TypeError, match="real-only"):
        lt.lsqr_grad(_dense(A), b)
    with pytest.raises(TypeError, match="real-only"):
        lt.lsqr_grad(_dense(A), b.real)


def test_regpath_complex(rng):
    """tests/test_complex.py:478-502: real residual and solution norms over
    C (the exit-estimate identity and the computed residual), Morozov and
    the L-curve; the discrepancy choice is JAX's."""
    m, n = 60, 30
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    xt = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = A @ xt + 0.01 * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    At = _dense(A)
    for exact in (False, True):
        path = lt.reg_sweep(At, b, num=8, exact_residual=exact)
        assert not path.residual_norm.is_complex() and not path.solution_norm.is_complex()
        for j in (0, 4, 7):
            rn = np.linalg.norm(b - A @ to_np(path.x[j]))
            np.testing.assert_allclose(float(path.residual_norm[j]), rn, rtol=1e-8)
    noise = 0.01 * np.sqrt(2 * m)
    d, xd, path = lt.discrepancy_damp(At, b, noise_norm=noise)
    d_j, _, _ = lj.discrepancy_damp(A, b, noise_norm=noise)
    np.testing.assert_allclose(float(d), float(d_j), rtol=1e-12)
    j = int(np.argmin(np.abs(to_np(path.damps) - float(d))))
    assert float(path.residual_norm[j]) <= 0.011 * np.sqrt(2 * m) * 1.5
    lam, xl, curv = lt.lcurve_corner(path)
    assert np.isfinite(float(lam))
