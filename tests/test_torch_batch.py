"""The port's batched solves (lsqr_tpu_torch.batch) against its own
standalone solves and the JAX package (tests/test_batch_precond.py).

Every problem is a row of (k, ·) tensors, its products one call a row and
its sums one reduction a row, so each column is bit for bit its standalone
solve on the same route: istop, itn and x are held with ``torch.equal``
(the bound the port asks of itself is istop and itn equal and x within
1e-12).

Against JAX's vmapped solve (JAX on the CPU in x64) the port inherits its
standalone solves' rounding differences: tests/test_batch_precond.py's COO
problem (80 x 50, condition 16) runs past Krylov exhaustion (itn 60-64 at
atol = btol = 1e-10), where one solve stops an iteration before the other.
So the bands are the port's standalone ones (ROADMAP Queue 3): istop equal,
itn within 1, x within 1e-9 of max|x| (LSMR, which stops at its limit of n
iterations there: 1e-7) where JAX's own test holds 1e-10 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.batch import cgls_batch as cgls_batch_j
from lsqr_tpu.batch import lsmr_batch as lsmr_batch_j

from _torch_parity import DEV, banded, rel_err, to_np

SOLVERS = ["lsqr", "lsmr", "cgls"]


def _triplets(rng, m=80, n=50, nnz=400):
    return rng.standard_normal(nnz), rng.integers(0, m, nnz), rng.integers(0, n, nnz)


def _route(rng, route):
    """(operator, B (k, m), per-problem damps, tolerance kw, route kw)."""
    if route == "coo":
        vals, rows, cols = _triplets(rng)
        A = lt.coo_operator(80, 50, vals, rows, cols, device=DEV)
        return (A, rng.standard_normal((4, 80)), np.array([0.0, 0.1, 1.0, 0.01]),
                dict(atol=1e-10, btol=1e-10), {})
    m, ks = 300, (-3, 0, 1, 5)
    dtype = np.float64 if route == "packed_f64" else np.float32
    data, _ = banded(rng, m, m, ks, dtype, boost=3.0, dense=False)
    B = rng.standard_normal((3, m)).astype(dtype)
    if route == "packed_f64":
        A = lt.dia_operator(m, m, ks, data, device=DEV)
    else:
        A = lt.dia_shared_operator(m, m, ks, data, device=DEV)
    kw = {"pair": dict(pair=True), "halfstep": dict(pair=False, fused=True),
          "plain": dict(pair=False, fused=False), "packed_f64": {}}[route]
    return A, B, np.array([0.0, 0.05, 0.5]), dict(atol=1e-5, btol=1e-5), kw


def _sibling_kw(solver, kw):
    """The route options each solver takes: lsqr all; lsmr and cgls pair."""
    return kw if solver == "lsqr" else {k: v for k, v in kw.items() if k == "pair"}


def _near_jax(res, res_j, x_rel):
    """The bands of the module docstring."""
    np.testing.assert_array_equal(to_np(res.istop), np.asarray(res_j.istop))
    assert np.abs(to_np(res.itn) - np.asarray(res_j.itn)).max() <= 1
    for j in range(res.x.shape[0]):
        assert rel_err(res.x[j], res_j.x[j]) <= x_rel, j


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("route", ["coo", "pair", "halfstep", "plain", "packed_f64"])
def test_each_column_is_its_standalone_solve(rng, solver, route):
    A, B, damps, tol, kw = _route(rng, route)
    if solver != "lsqr" and route in ("halfstep", "plain"):
        kw = dict(pair=False)
    kw = _sibling_kw(solver, kw)
    res = getattr(lt, solver + "_batch")(A, B, damps, **tol, **kw)
    assert res.x.shape == (B.shape[0], A.n) and res.istop.shape == (B.shape[0],)
    for j in range(B.shape[0]):
        ref = getattr(lt, solver)(A, B[j], float(damps[j]), **tol, **kw)
        assert int(res.istop[j]) == int(ref.istop), j
        assert int(res.itn[j]) == int(ref.itn), j
        assert torch.equal(res.x[j], ref.x), j


def test_lsqr_batch_matches_jax(rng):
    """tests/test_batch_precond.py:24-37."""
    vals, rows, cols = _triplets(rng)
    B = rng.standard_normal((5, 80))
    kw = dict(atol=1e-10, btol=1e-10, itnlim=200)
    res = lt.lsqr_batch(lt.coo_operator(80, 50, vals, rows, cols, device=DEV), B, 0.1, **kw)
    res_j = lj.lsqr_batch(lj.coo_operator(80, 50, vals, rows, cols), jnp.asarray(B), 0.1, **kw)
    assert res.x.shape == (5, 50) and res.istop.shape == (5,)
    _near_jax(res, res_j, 1e-9)


@pytest.mark.parametrize("solver", ["lsmr", "cgls"])
def test_sibling_batch_matches_jax(rng, solver):
    """lsmr_batch and cgls_batch against JAX's (tests/test_complex.py:
    244-268's solves over R)."""
    vals, rows, cols = _triplets(rng)
    B = rng.standard_normal((3, 80))
    damps = np.array([0.0, 0.05, 0.5])
    res = getattr(lt, solver + "_batch")(lt.coo_operator(80, 50, vals, rows, cols, device=DEV),
                                         B, damps, atol=1e-10, btol=1e-10)
    fn_j = lsmr_batch_j if solver == "lsmr" else cgls_batch_j
    res_j = fn_j(lj.coo_operator(80, 50, vals, rows, cols), jnp.asarray(B), jnp.asarray(damps),
                 atol=1e-10, btol=1e-10)
    _near_jax(res, res_j, 1e-7 if solver == "lsmr" else 1e-9)


def test_batch_per_problem_damp(rng):
    """tests/test_batch_precond.py:40-53: damped problems stop at istop 3,
    and more damping shrinks the solution."""
    vals, rows, cols = _triplets(rng)
    A = lt.coo_operator(80, 50, vals, rows, cols, device=DEV)
    B = np.tile(rng.standard_normal(80), (3, 1))
    res = lt.lsqr_batch(A, B, np.array([0.0, 0.1, 1.0]), atol=1e-10, btol=1e-10,
                        itnlim=200)
    assert int(res.istop[0]) in (1, 2)
    assert int(res.istop[1]) == 3 and int(res.istop[2]) == 3
    norms = torch.linalg.vector_norm(res.x, dim=1)
    assert norms[2] < norms[1] <= norms[0] + 1e-9


def test_batch_wantse_and_mixed_scalars(rng):
    """se and the mixed-precision scalars, bit for bit, column by column."""
    vals, rows, cols = _triplets(rng)
    A = lt.coo_operator(80, 50, vals, rows, cols, device=DEV)
    B = rng.standard_normal((2, 80))
    res = lt.lsqr_batch(A, B, [0.0, 0.2], wantse=True, atol=1e-10, btol=1e-10)
    A32 = lt.coo_operator(80, 50, vals, rows, cols, dtype=torch.float32, device=DEV)
    B32 = B.astype(np.float32)
    mixed = lt.lsqr_batch(A32, B32, 0.2, scalar_dtype=torch.float64, atol=1e-6, btol=1e-6)
    for j, damp in enumerate([0.0, 0.2]):
        ref = lt.lsqr(A, B[j], damp, wantse=True, atol=1e-10, btol=1e-10)
        assert torch.equal(res.se[j], ref.se) and torch.equal(res.x[j], ref.x)
        ref = lt.lsqr(A32, B32[j], 0.2, scalar_dtype=torch.float64, atol=1e-6, btol=1e-6)
        assert int(mixed.itn[j]) == int(ref.itn) and torch.equal(mixed.x[j], ref.x)


def test_batch_validation(rng):
    """tests/test_batch_precond.py:56-59, and the options the batch takes
    no route for."""
    vals, rows, cols = _triplets(rng)
    A = lt.coo_operator(80, 50, vals, rows, cols, device=DEV)
    for fn in (lt.lsqr_batch, lt.lsmr_batch, lt.cgls_batch):
        with pytest.raises(ValueError, match="shape"):
            fn(A, np.zeros((4, 81)))
        with pytest.raises(ValueError, match="shape"):
            fn(A, np.zeros(80))
        with pytest.raises(ValueError, match="one per problem"):
            fn(A, np.zeros((4, 80)), np.zeros(3))
    with pytest.raises(ValueError, match="record_trace"):
        lt.lsqr_batch(A, np.zeros((2, 80)), record_trace=True)
    with pytest.raises(ValueError, match="megakernel"):
        lt.lsqr_batch(A, np.zeros((2, 80)), megakernel=True)


def test_zero_rows_stop_at_once(rng):
    """A zero right-hand side beside a live one: x = 0 (istop 0, itn 0),
    and the other row solves as alone."""
    vals, rows, cols = _triplets(rng)
    A = lt.coo_operator(80, 50, vals, rows, cols, device=DEV)
    B = np.stack([np.zeros(80), rng.standard_normal(80)])
    for solver in SOLVERS:
        res = getattr(lt, solver + "_batch")(A, B, 0.1, atol=1e-8, btol=1e-8)
        ref = getattr(lt, solver)(A, B[1], 0.1, atol=1e-8, btol=1e-8)
        assert int(res.istop[0]) == 0 and int(res.itn[0]) == 0
        assert not res.x[0].any() and torch.equal(res.x[1], ref.x)
