"""The port's mixed-precision refinement (lsqr_tpu_torch.refine) against the
JAX package (tests/test_refine.py).

The same f32-stored matrices and f64 right-hand sides go to both packages
(JAX on the CPU in x64 with f32 operators, the port on the CPU with f32
tensors). Bounds: the f64 oracles of tests/test_refine.py at its
tolerances (lstsq, pinv or the damped normal equations of the STORED
matrix); the cycle count and the preconditioning switch equal to JAX's
(both run f32 inner solves to machine precision; the LSRN sketch of the
refinement is numpy's ``default_rng(seed)`` in both); x within 1e-9 of
JAX's (relative to ||x||, both at near-f64 accuracy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

from _torch_parity import DEV, to_np


def _ill_conditioned(m, n, cond, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    return ((U * s) @ V.T).astype(dtype)


def _both(a32, b, *args, **kw):
    """(port result, JAX result) of lsqr_refined on the dense f32 matrix."""
    res = lt.lsqr_refined(lt.as_operator(torch.tensor(a32)), b, *args, **kw)
    res_j = lj.lsqr_refined(lj.DenseOperator(jnp.asarray(a32)), b, *args, **kw)
    assert isinstance(res, lt.RefineResult) and res.x.dtype == res_j.x.dtype
    assert res.cycles == res_j.cycles and res.preconditioned == res_j.preconditioned
    assert res.converged == res_j.converged
    return res, res_j


def _rel(x, ref):
    return np.linalg.norm(to_np(x) - ref) / np.linalg.norm(ref)


def test_refined_reaches_f64_accuracy_where_f32_stalls():
    """An incompatible system: near f64 where the plain f32 solve stops."""
    m, n = 300, 80
    a32 = _ill_conditioned(m, n, 1e2)
    b = np.random.default_rng(8).standard_normal(m)
    x_star = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0]
    plain = lt.lsqr(lt.as_operator(torch.tensor(a32)), b.astype(np.float32))
    res, res_j = _both(a32, b, cycles=10)
    assert _rel(res.x, x_star) < 1e-12
    assert np.linalg.norm(res.x - x_star) < 1e-6 * np.linalg.norm(to_np(plain.x) - x_star)
    assert res.converged and not res.preconditioned
    assert _rel(res.x, res_j.x) < 1e-9
    assert len(res.results) == len(res_j.results)
    assert res.results[0].x.dtype == torch.float32


def test_refined_auto_lsrn_extends_cond_range():
    m, n = 300, 80
    a32 = _ill_conditioned(m, n, 1e6, seed=20)
    b = np.random.default_rng(21).standard_normal(m)
    x_star = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0]
    res, res_j = _both(a32, b, cycles=14)
    assert res.preconditioned and _rel(res.x, x_star) < 1e-9
    off = lt.lsqr_refined(lt.as_operator(torch.tensor(a32)), b, cycles=14, precondition=None)
    assert _rel(res.x, x_star) < 1e-3 * _rel(off.x, x_star)
    assert _rel(res.x, res_j.x) < 1e-9


def test_refined_damped_matches_closed_form():
    m, n, damp = 200, 60, 0.03
    a32 = _ill_conditioned(m, n, 1e6, seed=9)
    b = np.random.default_rng(10).standard_normal(m)
    a64 = a32.astype(np.float64)
    x_star = np.linalg.solve(a64.T @ a64 + damp ** 2 * np.eye(n), a64.T @ b)
    res, res_j = _both(a32, b, damp, cycles=8)
    assert _rel(res.x, x_star) < 1e-10 and _rel(res.x, res_j.x) < 1e-9


def test_refined_minnorm_underdetermined():
    m, n = 40, 90
    rng = np.random.default_rng(11)
    a32 = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m)
    x_star = np.linalg.pinv(a32.astype(np.float64)) @ b
    res, res_j = _both(a32, b, cycles=8)
    assert _rel(res.x, x_star) < 1e-12 and _rel(res.x, res_j.x) < 1e-9


@pytest.mark.parametrize("solver,rtol", [("lsmr", 1e-9), ("cgls", 1e-6)])
def test_refined_inner_solver_siblings(solver, rtol):
    m, n = 150, 50
    a32 = _ill_conditioned(m, n, 1e3, seed=12)
    b = np.random.default_rng(13).standard_normal(m)
    x_star = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0]
    res = lt.lsqr_refined(lt.as_operator(torch.tensor(a32)), b, cycles=12, solver=solver)
    res_j = lj.lsqr_refined(lj.DenseOperator(jnp.asarray(a32)), b, cycles=12, solver=solver)
    assert _rel(res.x, x_star) < rtol and _rel(res_j.x, x_star) < rtol
    assert abs(res.cycles - res_j.cycles) <= 1


def test_refined_sparse_operator_host_residual():
    """A shared-stripe DIA operator: the f64 defects come from the host CSR
    of its stripes, the residual estimate tracks the true residual."""
    m = n = 120
    offsets = (-2, 0, 1, 4)
    rng = np.random.default_rng(14)
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    data[1] += 4.0
    A = lt.dia_shared_operator(m, n, offsets, data, device=DEV)
    Aj = lj.dia_shared_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    a64 = lt.to_scipy(A).toarray()
    x_star = np.linalg.solve(a64, b)
    res, res_j = lt.lsqr_refined(A, b, cycles=8), lj.lsqr_refined(Aj, b, cycles=8)
    assert _rel(res.x, x_star) < 1e-12 and res.converged
    assert res.cycles == res_j.cycles and _rel(res.x, res_j.x) < 1e-9
    np.testing.assert_allclose(res.r, b - a64 @ res.x, atol=1e-10)


def test_refined_warm_start_and_validation():
    m, n = 60, 20
    a32 = _ill_conditioned(m, n, 10.0, seed=15)
    b = np.random.default_rng(16).standard_normal(m)
    x_star = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0]
    A = lt.as_operator(torch.tensor(a32))
    ref0 = lt.lsqr_refined(A, b, cycles=6)
    res, res_j = _both(a32, b, cycles=6, x0=ref0.x)
    assert res.cycles <= 3 and _rel(res.x, x_star) < 1e-12
    with pytest.raises(ValueError):
        lt.lsqr_refined(A, b[:-1])
    with pytest.raises(ValueError, match="unknown inner solver"):
        lt.lsqr_refined(A, b, solver="qr")
    with pytest.raises(ValueError, match="m >= n"):
        lt.lsqr_refined(lt.as_operator(torch.tensor(a32).T.contiguous()), b[:n],
                        precondition="lsrn")


def test_refined_graceful_beyond_f32_range():
    """cond 1e10: not converged, and the best-residual iterate returned."""
    m, n = 200, 50
    a32 = _ill_conditioned(m, n, 1e10, seed=17)
    b = np.random.default_rng(18).standard_normal(m)
    res = lt.lsqr_refined(lt.as_operator(torch.tensor(a32)), b, cycles=6)
    res_j = lj.lsqr_refined(lj.DenseOperator(jnp.asarray(a32)), b, cycles=6)
    assert not res.converged and not res_j.converged
    assert res.rnorms[-1] <= np.linalg.norm(b) * (1 + 1e-12)
    np.testing.assert_allclose(np.linalg.norm(b - a32.astype(np.float64) @ res.x),
                               res.rnorms[-1], rtol=1e-10)


def test_refined_callable_inner_solver():
    calls = []

    def my_solver(A, b, damp, **kw):
        calls.append(A.shape)
        return lt.lsqr(A, b, damp, **kw)

    m, n = 80, 30
    a32 = _ill_conditioned(m, n, 50.0, seed=19)
    b = np.random.default_rng(20).standard_normal(m)
    x_star = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0]
    res = lt.lsqr_refined(lt.as_operator(torch.tensor(a32)), b, cycles=6, solver=my_solver)
    assert calls and _rel(res.x, x_star) < 1e-12


def test_refined_guard_keeps_last_iterate_on_rounding_ties():
    """An incompatible problem whose cycles' true residual norms tie to
    rounding (7.70383245 from cycle 2 on): a strict best-residual guard
    would hand back cycle 3's iterate, 1e-11 from the oracle, by rounding
    alone; the port's guard (GUARD_RTOL) keeps the last one. Divergence is
    still caught (test_refined_graceful_beyond_f32_range)."""
    from lsqr_tpu_torch import refine

    m, n = 80, 30
    a32 = _ill_conditioned(m, n, 50.0, seed=19)
    b = np.random.default_rng(20).standard_normal(m)
    x_star = np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0]
    A = lt.as_operator(torch.tensor(a32))
    res = lt.lsqr_refined(A, b, cycles=6)
    assert res.converged and _rel(res.x, x_star) < 1e-12
    tied = res.rnorms[2:]
    assert 0 < (max(tied) - min(tied)) / min(tied) < refine.GUARD_RTOL
    assert res.rnorms[-1] > min(tied)  # a strict guard would have reverted


def test_refined_damped_underdetermined_with_lsrn():
    m, n, damp = 40, 90, 0.5
    rng = np.random.default_rng(23)
    a32 = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m)
    a64 = a32.astype(np.float64)
    x_star = np.linalg.solve(a64.T @ a64 + damp ** 2 * np.eye(n), a64.T @ b)
    res, res_j = _both(a32, b, damp, cycles=8, precondition="lsrn")
    assert res.preconditioned and _rel(res.x, x_star) < 1e-11
    assert _rel(res.x, res_j.x) < 1e-9


def test_refined_callback_operator_stays_f32():
    """A callback operator has no dtype: the solves stay f32, on the
    device given."""
    m, n = 50, 20
    a32 = _ill_conditioned(m, n, 10.0, seed=24)
    at = torch.tensor(a32)
    a64 = a32.astype(np.float64)
    b = np.random.default_rng(25).standard_normal(m)
    x_star = np.linalg.lstsq(a64, b, rcond=None)[0]
    res = lt.lsqr_refined((lambda x: at @ x, lambda y: at.T @ y), b, m=m, n=n,
                          host_matvec=lambda x: a64 @ x, host_rmatvec=lambda y: a64.T @ y,
                          cycles=6, device=DEV)
    assert res.results[0].x.dtype == torch.float32
    assert _rel(res.x, x_star) < 1e-12


def test_refined_f64_truth_beyond_f32_representation():
    m, n = 300, 80
    a64 = _ill_conditioned(m, n, 1e6, seed=26, dtype=np.float64)
    a32 = a64.astype(np.float32)
    b = np.random.default_rng(27).standard_normal(m)
    x64 = np.linalg.lstsq(a64, b, rcond=None)[0]
    gap = _rel(np.linalg.lstsq(a32.astype(np.float64), b, rcond=None)[0], x64)
    assert gap > 1e-4
    res, res_j = _both(a32, b, cycles=14, host_matvec=lambda x: a64 @ x,
                       host_rmatvec=lambda y: a64.T @ y)
    assert _rel(res.x, x64) < 1e-9 and _rel(res.x, x64) < 1e-4 * gap


@pytest.mark.parametrize("logc, bound", [(9, 5e-7), (10, 5e-6)])
def test_refine_no_wall_at_high_cond(logc, bound):
    """With f64 host closures the error follows eps64 * cond out to 1e10."""
    rng = np.random.default_rng(0)
    m, n = 300, 150
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A64 = (U * np.logspace(0, -logc, n)) @ V.T
    x_true = rng.standard_normal(n)
    res = lt.lsqr_refined(lt.as_operator(torch.tensor(A64.astype(np.float32))), A64 @ x_true,
                          host_matvec=lambda x: A64 @ x, host_rmatvec=lambda y: A64.T @ y,
                          cycles=12)
    assert _rel(res.x, x_true) < bound
    assert res.stagnated or res.converged
