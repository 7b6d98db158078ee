"""The port's LSRN (lsqr_tpu_torch.randomized) against the JAX package
(tests/test_randomized.py).

The Gaussian sketch comes from a torch.Generator, so its draws are not
jax.random's: the tests hold what the sketch is for. The preconditioned
operator's singular values lie within the w.h.p. bound JAX's test uses;
the solves reach the f64 oracle (lstsq, pinv or the damped normal
equations) at tests/test_randomized.py's tolerances, and JAX's lsrn x on
the same problem within 1e-7 (relative to max |x|; both solve to 1e-12
through different sketches). The rank equals JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

from _torch_parity import DEV, rel_err, to_np


def _ill_conditioned(rng, m, n, cond=1e8):
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 10.0 ** np.linspace(0, -np.log10(cond), n)
    return U @ np.diag(s) @ V.T, rng.standard_normal(m)


def _ops(A):
    return lt.as_operator(torch.tensor(A)), lj.DenseOperator(jnp.asarray(A))


def test_sketch_left_dense_equals_rowwise(rng):
    """The product sketch of a dense operator and the adjoint-product sketch
    of the same matrix in COO are one G A (same seed, same draws)."""
    m, n = 60, 25
    Ad = rng.standard_normal((m, n))
    r, c = np.nonzero(np.ones((m, n)))
    A_coo = lt.coo_operator(m, n, Ad[r, c], r, c, device=DEV)
    S_dense = lt.sketch_left(lt.as_operator(torch.tensor(Ad)), 50, seed=3, chunk=16)
    S_coo = lt.sketch_left(A_coo, 50, seed=3, chunk=16)
    assert S_dense.shape == (50, n)
    np.testing.assert_allclose(to_np(S_coo), to_np(S_dense), rtol=1e-12, atol=1e-13)


def test_sketch_right_shape_and_value(rng):
    m, n = 20, 45
    Ad = rng.standard_normal((m, n))
    r, c = np.nonzero(np.ones((m, n)))
    S = lt.sketch_right(lt.as_operator(torch.tensor(Ad)), 30, seed=1)
    assert S.shape == (m, 30)
    S_coo = lt.sketch_right(lt.coo_operator(m, n, Ad[r, c], r, c, device=DEV), 30, seed=1)
    np.testing.assert_allclose(to_np(S_coo), to_np(S), rtol=1e-12, atol=1e-13)


def test_preconditioner_flattens_spectrum(rng):
    """cond(A N) under the w.h.p. bound (< 4 at gamma 4) whatever cond(A)."""
    A, _ = _ill_conditioned(rng, 300, 40)
    N, r, bound = lt.lsrn_preconditioner(lt.as_operator(torch.tensor(A)), gamma=4.0)
    _, r_j, bound_j = lj.lsrn_preconditioner(lj.DenseOperator(jnp.asarray(A)), gamma=4.0)
    assert r == r_j == 40 and bound == pytest.approx(bound_j)
    sv = np.linalg.svd(A @ to_np(N), compute_uv=False)
    assert sv[0] / sv[-1] < bound < 4.0


def test_lsrn_overdetermined_beats_plain(rng):
    A, b = _ill_conditioned(rng, 400, 60)
    x_star = np.linalg.lstsq(A, b, rcond=None)[0]
    At, Aj = _ops(A)
    kw = dict(atol=1e-12, btol=1e-12, itnlim=100)
    res = lt.lsrn(At, b, **kw)
    err = np.linalg.norm(to_np(res.x) - x_star) / np.linalg.norm(x_star)
    assert err < 1e-8 and int(res.result.itn) < 60
    assert float(res.result.acond) < res.cond_bound * np.sqrt(60) * 2
    plain = lt.lsqr(At, b, atol=1e-12, btol=1e-12, conlim=0.0, itnlim=int(res.result.itn))
    assert np.linalg.norm(to_np(plain.x) - x_star) / np.linalg.norm(x_star) > 100 * err
    res_j = lj.lsrn(Aj, b, **kw)
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-7


def test_lsrn_damped_matches_closed_form(rng):
    A, b = _ill_conditioned(rng, 120, 30, cond=1e4)
    damp = 0.05
    x_star = np.linalg.solve(A.T @ A + damp ** 2 * np.eye(30), A.T @ b)
    At, Aj = _ops(A)
    res = lt.lsrn(At, b, damp, atol=1e-13, btol=1e-13)
    np.testing.assert_allclose(to_np(res.x), x_star, rtol=1e-8, atol=1e-10)
    assert rel_err(res.x, np.asarray(lj.lsrn(Aj, b, damp, atol=1e-13, btol=1e-13).x)) < 1e-7


def test_lsrn_underdetermined_min_norm(rng):
    m, n = 30, 90
    A = rng.standard_normal((m, n)) * 10.0 ** np.linspace(0, -6, m)[:, None]
    b = rng.standard_normal(m)
    At, Aj = _ops(A)
    res = lt.lsrn(At, b, atol=1e-13, btol=1e-13, itnlim=200)
    assert res.P is not None and res.N is None and res.P.shape == (m, m)
    np.testing.assert_allclose(to_np(res.x), np.linalg.pinv(A) @ b, rtol=1e-7, atol=1e-9)
    res_j = lj.lsrn(Aj, b, atol=1e-13, btol=1e-13, itnlim=200)
    assert res.rank == res_j.rank
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-7


def test_lsrn_rank_deficient(rng):
    m, n, r_true = 100, 40, 25
    A = rng.standard_normal((m, r_true)) @ rng.standard_normal((r_true, n))
    b = rng.standard_normal(m)
    At, Aj = _ops(A)
    res = lt.lsrn(At, b, rcond=1e-10, atol=1e-13, btol=1e-13)
    assert res.rank == r_true == lj.lsrn(Aj, b, rcond=1e-10, atol=1e-13, btol=1e-13).rank
    np.testing.assert_allclose(to_np(res.x), np.linalg.pinv(A) @ b, rtol=1e-7, atol=1e-9)


def test_lsrn_sparse_operator(rng):
    """The adjoint-product sketch end to end on a COO operator."""
    m, n, nnz = 150, 40, 1200
    r, c = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    Ad = np.zeros((m, n))
    np.add.at(Ad, (r, c), v)
    b = rng.standard_normal(m)
    res = lt.lsrn(lt.coo_operator(m, n, v, r, c, device=DEV), b, atol=1e-12, btol=1e-12,
                  chunk=32)
    x_star = np.linalg.lstsq(Ad, b, rcond=None)[0]
    np.testing.assert_allclose(to_np(res.x), x_star, rtol=1e-7, atol=1e-9)
    res_j = lj.lsrn(lj.coo_operator(m, n, v, r, c), b, atol=1e-12, btol=1e-12, chunk=32)
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-7


@pytest.mark.parametrize("solver", ["lsmr", "cgls"])
def test_lsrn_solver_variants(rng, solver):
    A, b = _ill_conditioned(rng, 100, 20, cond=1e5)
    x_star = np.linalg.lstsq(A, b, rcond=None)[0]
    At, _ = _ops(A)
    res = lt.lsrn(At, b, solver=solver, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(res.x), x_star, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="unknown solver"):
        lt.lsrn(At, b, solver="gmres")


def test_lsrn_deterministic(rng):
    A, b = _ill_conditioned(rng, 80, 15, cond=1e3)
    At, _ = _ops(A)
    r1, r2 = lt.lsrn(At, b, seed=7), lt.lsrn(At, b, seed=7)
    assert torch.equal(r1.x, r2.x) and torch.equal(r1.N, r2.N)
    assert not torch.equal(lt.sketch_left(At, 30, seed=7), lt.sketch_left(At, 30, seed=8))
