"""The port's operator algebra (ops/compose.py) and the damped warm start
against the JAX package (tests/test_compose.py).

The same numpy matrices go to both packages: JAX on the CPU in x64, the
port on the CPU. Bounds: the composites' products within 1e-12 of the
dense products and of JAX's (relative to the max); f64 solves with equal
istop and itn and x within 1e-10 of JAX's (relative to max |x|); the
closed-form oracles of tests/test_compose.py at its tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

from _torch_parity import DEV, banded, to_np

SOLVERS = ("lsqr", "lsmr", "cgls")


def rel_err(got, ref):
    """max |got - ref| / max |ref|, complex values included."""
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _dense(rng, m, n, cplx=False):
    M = rng.standard_normal((m, n))
    if cplx:
        M = M + 1j * rng.standard_normal((m, n))
    return M, lt.as_operator(torch.tensor(M)), lj.as_operator(jnp.asarray(M))


def _hold_products(St, Sj, dense, rng):
    m, n = dense.shape
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    for got, jax_out, ref in ((St.matvec(torch.tensor(x)), Sj.matvec(jnp.asarray(x)), dense @ x),
                              (St.rmatvec(torch.tensor(y)), Sj.rmatvec(jnp.asarray(y)),
                               dense.conj().T @ y)):
        assert rel_err(got, ref) < 1e-12
        assert rel_err(got, np.asarray(jax_out)) < 1e-12
    assert int(lt.acheck(St).inform) == 0


def test_vstack_matches_dense_and_jax(rng):
    Ad, At, Aj = _dense(rng, 30, 20)
    Bd, Bt, Bj = _dense(rng, 10, 20)
    St = lt.vstack_operators([At, Bt])
    assert St.shape == (40, 20) and isinstance(St, lt.VStackOperator)
    _hold_products(St, lj.vstack_operators([Aj, Bj]), np.vstack([Ad, Bd]), rng)


def test_hstack_matches_dense_and_jax(rng):
    Ad, At, Aj = _dense(rng, 25, 15)
    Bd, Bt, Bj = _dense(rng, 25, 7)
    St = lt.hstack_operators([At, Bt])
    assert St.shape == (25, 22) and isinstance(St, lt.HStackOperator)
    _hold_products(St, lj.hstack_operators([Aj, Bj]), np.hstack([Ad, Bd]), rng)


def test_stack_validation(rng):
    _, A, _ = _dense(rng, 5, 4)
    _, B, _ = _dense(rng, 5, 3)
    with pytest.raises(ValueError, match="share n"):
        lt.vstack_operators([A, B])
    _, C, _ = _dense(rng, 4, 4)
    with pytest.raises(ValueError, match="share m"):
        lt.hstack_operators([A, C])
    with pytest.raises(ValueError, match="at least one"):
        lt.vstack_operators([])
    with pytest.raises(ValueError, match="vector"):
        lt.diagonal_operator(np.ones((2, 2)), device=DEV)


def test_scaled_and_diagonal_complex(rng):
    """Scaled and diagonal operators, complex: the adjoints conjugate alpha
    and d (tests/test_complex.py:162-177)."""
    Ad, At, Aj = _dense(rng, 30, 20, cplx=True)
    d = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    alpha = 0.7 - 0.3j
    St = lt.vstack_operators([At, lt.scale_operator(lt.diagonal_operator(d, device=DEV),
                                                    alpha)])
    Sj = lj.vstack_operators([Aj, lj.scale_operator(lj.diagonal_operator(d), alpha)])
    dense = np.vstack([Ad, alpha * np.diag(d)])
    x = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    y = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    assert rel_err(St.matvec(torch.tensor(x)), dense @ x) < 1e-12
    assert rel_err(St.rmatvec(torch.tensor(y)), dense.conj().T @ y) < 1e-12
    assert rel_err(St.rmatvec(torch.tensor(y)), np.asarray(Sj.rmatvec(jnp.asarray(y)))) < 1e-12
    assert int(lt.acheck(St).inform) == 0


def test_composites_todense(rng):
    """todense of every composite equals the dense matrix it applies."""
    Ad, At, _ = _dense(rng, 12, 9)
    Bd, Bt, _ = _dense(rng, 12, 5)
    d = rng.standard_normal(9)
    cases = {
        "vstack": (lt.vstack_operators([At, At]), np.vstack([Ad, Ad])),
        "hstack": (lt.hstack_operators([At, Bt]), np.hstack([Ad, Bd])),
        "scaled": (lt.scale_operator(At, 2.5), 2.5 * Ad),
        "diagonal": (lt.diagonal_operator(d, device=DEV), np.diag(d)),
        "sum": (lt.add_operators([At, At]), 2 * Ad),
    }
    for name, (op, ref) in cases.items():
        np.testing.assert_allclose(to_np(op.todense()), ref, rtol=1e-12, err_msg=name)


def test_tikhonov_identity_matches_damp(rng):
    """L = I: tikhonov(lam) is the damp=lam solve (the reference's special
    case), in both packages."""
    m, n, lam = 40, 25, 0.3
    _, At, Aj = _dense(rng, m, n)
    b = rng.standard_normal(m)
    ref = lt.lsqr(At, b, lam, atol=1e-12, btol=1e-12)
    res = lt.tikhonov(At, b, lt.diagonal_operator(np.ones(n), device=DEV), lam,
                      atol=1e-12, btol=1e-12)
    res_j = lj.tikhonov(Aj, b, lj.diagonal_operator(jnp.ones(n)), lam, atol=1e-12,
                        btol=1e-12)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-8, atol=1e-10)
    assert int(res.itn) == int(res_j.itn) and int(res.istop) == int(res_j.istop)
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-10


@pytest.mark.parametrize("solver", SOLVERS)
def test_tikhonov_general_form_matches_oracle_and_jax(rng, solver):
    """L = first differences: the normal-equations oracle
    (A'A + lam^2 L'L) x = A'b, and JAX's solve of the same stack (x within
    1e-10 of JAX's; LSMR's within 1e-6: it stops at its limit of n
    iterations before it converges, and there both follow their rounding)."""
    m, n, lam = 50, 30, 0.7
    Ad, At, Aj = _dense(rng, m, n)
    b = rng.standard_normal(m)
    Ld = np.zeros((n - 1, n))
    Ld[np.arange(n - 1), np.arange(n - 1)] = -1.0
    Ld[np.arange(n - 1), np.arange(1, n)] = 1.0
    x_oracle = np.linalg.solve(Ad.T @ Ad + lam * lam * (Ld.T @ Ld), Ad.T @ b)
    res = lt.tikhonov(At, b, torch.tensor(Ld), lam, solver=solver, atol=1e-12, btol=1e-12)
    res_j = lj.tikhonov(Aj, b, jnp.asarray(Ld), lam, solver=solver, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(res.x), x_oracle, rtol=1e-6, atol=1e-7)
    assert int(res.istop) == int(res_j.istop) and int(res.itn) == int(res_j.itn)
    assert rel_err(res.x, np.asarray(res_j.x)) < (1e-6 if solver == "lsmr" else 1e-10)
    with pytest.raises(ValueError, match="unknown solver"):
        lt.tikhonov(At, b, torch.tensor(Ld), lam, solver="gmres")


def test_stacked_structured_blocks(rng):
    """A shared-stripe DIA block over a diagonal regularizer solves like the
    dense equivalent and like JAX's stack of the same stripes."""
    m = n = 200
    data, dense = banded(rng, m, n, (-1, 0, 1), np.float64, boost=4.0)
    At = lt.dia_shared_operator(m, n, (-1, 0, 1), data, device=DEV)
    Aj = lj.dia_shared_operator(m, n, (-1, 0, 1), data)
    St = lt.vstack_operators([At, lt.diagonal_operator(np.full(n, 0.5), device=DEV)])
    Sj = lj.vstack_operators([Aj, lj.diagonal_operator(jnp.full((n,), 0.5))])
    b = rng.standard_normal(m + n)
    ref = np.linalg.lstsq(np.vstack([dense, 0.5 * np.eye(n)]), b, rcond=None)[0]
    res = lt.lsqr(St, b, atol=1e-12, btol=1e-12)
    res_j = lj.lsqr(Sj, b, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(res.x), ref, rtol=1e-6, atol=1e-8)
    assert int(res.itn) == int(res_j.itn) and int(res.istop) == int(res_j.istop)
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-10


def _warm_problem(rng, cplx):
    Ad, At, Aj = _dense(rng, 60, 30, cplx)
    b = rng.standard_normal(60) + (1j * rng.standard_normal(60) if cplx else 0)
    x0 = 0.05 * rng.standard_normal(30) + (0.05j * rng.standard_normal(30) if cplx else 0)
    return At, Aj, b, x0


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_damped_warm_start_matches_jax(rng, solver, cplx):
    """x0 with damp > 0 (the stacked undamped form of lsqr_tpu.solver,
    lsmr and cgls; for lsqr also through LSQRSolver): the same istop, itn
    and x as JAX's, and the x of the cold damped solve
    (tests/test_complex.py:96-108)."""
    At, Aj, b, x0 = _warm_problem(rng, cplx)
    damp = 0.2
    kw = dict(atol=1e-12, btol=1e-12)
    rt = getattr(lt, solver)(At, b, damp, x0=x0, **kw)
    rj = getattr(lj, solver)(Aj, b, damp, x0=x0, **kw)
    assert int(rt.istop) == int(rj.istop) and int(rt.itn) == int(rj.itn)
    assert rel_err(rt.x, np.asarray(rj.x)) < 1e-10
    assert rt.x.is_complex() == cplx
    cold = getattr(lt, solver)(At, b, damp, **kw)
    np.testing.assert_allclose(to_np(rt.x), to_np(cold.x), atol=1e-8)
    if solver == "lsqr":  # the damped least-squares stop maps 2 to 3
        assert int(rt.istop) in (1, 3)
        # and through LSQRSolver (the COO triple of the same matrix; the
        # COO sums run in other orders, so itn within 1, as for COO in
        # tests/test_torch_siblings.py)
        M = to_np(At.todense())
        r, c = np.nonzero(np.ones(M.shape))
        kwt = dict(atol=1e-12, btol=1e-12)
        ez = lt.LSQRSolver(*M.shape, M[r, c], r, c, device=DEV, **kwt).solve(b, damp, x0=x0)
        ez_j = lj.LSQRSolver(*M.shape, M[r, c], r, c, **kwt).solve(b, damp, x0=x0)
        assert int(ez.istop) == int(ez_j.istop) and abs(int(ez.itn) - int(ez_j.itn)) <= 1
        assert rel_err(ez.x, np.asarray(ez_j.x)) < 1e-9
