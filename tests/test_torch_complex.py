"""Complex problems across the port's solver family, against the JAX package
and the oracles of its ``tests/test_complex.py`` (scipy's lsqr and lsmr,
which take complex the same way, and closed forms).

Over C the Paige–Saunders bidiagonalization holds with A' read as the
conjugate transpose: alpha, beta and every rotation scalar and norm estimate
are real, the vectors complex. Both packages run in complex128 on the CPU
(x64 for JAX), complex64 where a case says so. Cases that need modules the
port does not have yet (multidamp, lsqr_grad, refine, hybrid, lsrn,
regpath, the sharded solvers, composite operators) wait for those modules.
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
    """tests/test_complex.py:97-111, with the undamped warm start (a damped
    one needs the operator algebra, ROADMAP item 9)."""
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
    with pytest.raises(NotImplementedError, match="item 9"):
        lt.lsqr(_dense(A), b, damp, x0=x0)


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
    """The megakernels and the fused half-steps are real-f32 only; damped
    x0 waits for item 9 in every solver."""
    A, b, _ = _cproblem(rng, m=30, n=20)
    D = _dense(A)
    for fn in (lt.lsqr, lt.lsmr, lt.craig):
        with pytest.raises(ValueError, match="megakernel=True requires"):
            fn(D, b, megakernel=True)
    Z = lt.dia_operator(30, 30, (0, 1), np.ones((2, 30), np.complex128), device=DEV)
    with pytest.raises(ValueError, match="fused_halfstep"):
        lt.lsqr(Z, b, fused=True, pair=False)
    for fn in (lt.lsqr, lt.lsmr, lt.cgls):
        with pytest.raises(NotImplementedError, match="item 9"):
            fn(D, b, 0.1, x0=np.zeros(20, complex))
