"""The sibling solvers of the PyTorch port (lsmr, craig, cgls) against the
JAX package and scipy.

The same numpy problem goes to both packages: JAX on the CPU in x64
(tests/conftest.py), the port on the CPU through its plain twins, on the
COO operator and both DIA layouts, in f64 and f32, with and without pair
mode. Bounds: istop equal; itn within 1 in f64 and within max(2, 10%) in
f32 (the two packages sum norms in different orders, which moves a
borderline test); x within 1e-8 (f64) or 1e-4 (f32) of max|x|. LSMR is
also held to scipy.sparse.linalg.lsmr as tests/test_lsmr.py does.
"""

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

from _torch_parity import DEV, banded, banded_triplets, rel_err, to_np

KS = (-2, -1, 0, 1, 3)
#: per solver: (m, n, damp, keyword arguments); CRAIG gets a consistent b
CASES = {
    "lsmr": (300, 200, 0.1, dict(atol=1e-8, btol=1e-8)),
    "craig": (200, 300, None, dict(atol=1e-8, btol=1e-8)),
    "cgls": (300, 200, 0.05, dict(atol=1e-8, btol=1e-8)),
}


def _build(layout, pkg, m, n, data):
    kw = dict(device=DEV) if pkg is lt else {}
    if layout == "coo":
        vals, rows, cols = banded_triplets(data, KS, n)
        return pkg.coo_operator(m, n, vals, rows, cols, **kw)
    return (pkg.dia_operator if layout == "dia" else pkg.dia_shared_operator)(m, n, KS, data,
                                                                             **kw)


def _solve(pkg, solver, A, b, damp, **kw):
    fn = getattr(pkg, solver)
    return fn(A, b, **kw) if damp is None else fn(A, b, damp, **kw)


def _problem(rng, solver, dtype):
    m, n, damp, kw = CASES[solver]
    data, dense = banded(rng, m, n, KS, dtype, boost=6.0)
    if solver == "craig":
        b = (dense @ rng.standard_normal(n)).astype(dtype)
    else:
        b = rng.standard_normal(m).astype(dtype)
    return m, n, damp, kw, data, b


def _hold(rt, rj, dtype):
    assert rt.x.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    assert int(rt.istop) == int(rj.istop)
    band = 1 if dtype == np.float64 else max(2, int(0.1 * int(rj.itn)))
    assert abs(int(rt.itn) - int(rj.itn)) <= band
    assert rel_err(rt.x, rj.x) < (1e-8 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", ["coo", "dia", "dia_shared"])
@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_siblings_match_jax(rng, solver, layout, dtype):
    m, n, damp, kw, data, b = _problem(rng, solver, dtype)
    rj = _solve(lj, solver, _build(layout, lj, m, n, data), b, damp, **kw)
    rt = _solve(lt, solver, _build(layout, lt, m, n, data), b, damp, **kw)
    _hold(rt, rj, dtype)
    norms = {"lsmr": ("normr", "normar", "normx"), "craig": ("rnorm", "xnorm", "anorm"),
             "cgls": ("rnorm", "xnorm", "anorm")}[solver]
    for name in norms:
        # in f32 LSMR's normar ends at ~1e-5 of its start, where the two
        # summation orders part by a few 1e-3 of it
        rtol = 1e-6 if dtype == np.float64 else (1e-2 if name == "normar" else 1e-3)
        np.testing.assert_allclose(float(getattr(rt, name)), float(getattr(rj, name)),
                                   rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("layout", ["dia", "dia_shared"])
@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_siblings_pair_mode_match_jax(rng, solver, layout):
    # tests/test_pair_siblings.py: the pair drives the bidiagonalization or
    # CG step; f32 stripes, the port's pair twins against JAX's XLA pair
    m, n, damp, kw, data, b = _problem(rng, solver, np.float32)
    rj = _solve(lj, solver, _build(layout, lj, m, n, data), b, damp, pair=True, **kw)
    At = _build(layout, lt, m, n, data)
    rt = _solve(lt, solver, At, b, damp, pair=True, **kw)
    _hold(rt, rj, np.float32)
    ref = _solve(lt, solver, At, b, damp, pair=False, **kw)
    assert int(rt.istop) == int(ref.istop) and rel_err(rt.x, ref.x) < 1e-4


def _scipy_problem(m, n, seed):
    """tests/test_lsmr.py::_random_problem."""
    rng = np.random.default_rng(seed)
    nnz = 4 * max(m, n)
    rows, cols, vals = rng.integers(0, m, nnz), rng.integers(0, n, nnz), rng.standard_normal(nnz)
    if m == n:
        d = np.arange(n)
        rows, cols = np.concatenate([rows, d]), np.concatenate([cols, d])
        vals = np.concatenate([vals, np.full(n, 4.0)])
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    rows, cols, vals = rows[first], cols[first], vals[first]
    b = rng.standard_normal(m)
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n))
    return lt.coo_operator(m, n, vals, rows, cols, device=DEV), S, b


@pytest.mark.parametrize("m,n,damp", [(300, 120, 0.0), (200, 200, 0.0), (120, 300, 0.0),
                                      (300, 120, 0.1)])
def test_lsmr_matches_scipy(m, n, damp):
    # tests/test_lsmr.py::test_lsmr_matches_scipy, with its bounds
    A, S, b = _scipy_problem(m, n, seed=m + n)
    res = lt.lsmr(A, b, damp, atol=1e-10, btol=1e-10)
    ref = scipy.sparse.linalg.lsmr(S, b, damp=damp, atol=1e-10, btol=1e-10)
    assert int(res.istop) == ref[1] and int(res.itn) == ref[2]
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-9)
    np.testing.assert_allclose(float(res.normr), ref[3], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(res.normar), ref[4], rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(res.norma), ref[5], rtol=1e-2)
    np.testing.assert_allclose(float(res.normx), ref[7], rtol=1e-7)


def test_lsmr_defaults_itnlim_and_trace_match_scipy_and_jax():
    A, S, b = _scipy_problem(250, 100, seed=7)
    res, ref = lt.lsmr(A, b), scipy.sparse.linalg.lsmr(S, b)
    assert int(res.istop) == ref[1] and int(res.itn) == ref[2]
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-5)
    # the iteration limit: istop 7 (tests/test_lsmr.py::test_lsmr_itnlim)
    A, S, b = _scipy_problem(400, 200, seed=5)
    res = lt.lsmr(A, b, atol=0.0, btol=0.0, conlim=0.0, itnlim=5)
    ref = scipy.sparse.linalg.lsmr(S, b, atol=0.0, btol=0.0, conlim=0.0, maxiter=5)
    assert int(res.istop) == 7 == ref[1] and int(res.itn) == 5
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-10)
    # the trace, against JAX's
    A, S, b = _scipy_problem(150, 60, seed=13)
    Aj = lj.coo_operator(150, 60, S.data, S.row, S.col)
    rt = lt.lsmr(A, b, atol=1e-9, btol=1e-9, record_trace=True)
    rj = lj.lsmr(Aj, b, atol=1e-9, btol=1e-9, record_trace=True)
    assert int(rt.itn) == int(rj.itn) and rt.trace.shape == np.asarray(rj.trace).shape
    tt, tj = to_np(rt.trace), np.asarray(rj.trace)
    col_err = np.abs(tt - tj).max(0) / np.abs(tj).max(0)
    # itn, x[0], normr, normar, test1, test2 to 1e-4 of each column's max;
    # norma and conda sum late-iteration alphas and betas, past the Krylov
    # space's exhaustion (n = 60), whose rounding parts by ~1% across
    # implementations (tests/test_lsmr.py holds them to scipy's at 1e-2, 0.5)
    assert np.all(col_err[:6] < 1e-4) and np.all(col_err[6:] < 5e-2), col_err
    assert lt.LSMR_ISTOP_MESSAGES == lj.LSMR_ISTOP_MESSAGES
    assert rt.istop_message == lj.LSMR_ISTOP_MESSAGES[int(rt.istop)]


@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_siblings_zero_rhs_and_warm_start_match_jax(rng, solver):
    m, n, damp, kw, data, b = _problem(rng, solver, np.float64)
    Aj, At = _build("dia", lj, m, n, data), _build("dia", lt, m, n, data)
    zero = _solve(lt, solver, At, np.zeros(m), None if damp is None else 0.0)
    assert int(zero.istop) == 0 and int(zero.itn) == 0 and not zero.x.any()
    x0 = 0.01 * rng.standard_normal(n)
    damp0 = None if damp is None else 0.0
    rj = _solve(lj, solver, Aj, b, damp0, x0=x0, **kw)
    rt = _solve(lt, solver, At, b, damp0, x0=x0, **kw)
    _hold(rt, rj, np.float64)
    if damp is not None:  # the damped warm start: the stacked form in both
        rj = _solve(lj, solver, Aj, b, damp, x0=x0, **kw)
        rt = _solve(lt, solver, At, b, damp, x0=x0, **kw)
        _hold(rt, rj, np.float64)


def test_siblings_refuse_what_they_do_not_take(rng):
    A = lt.coo_operator(3, 3, np.ones(3, np.float32), np.arange(3), np.arange(3), device=DEV)
    b = np.ones(3, np.float32)
    for fn in (lt.lsmr, lt.craig, lt.cgls):
        with pytest.raises(ValueError, match="fused_pair"):
            fn(A, b, pair=True)
        # complex solves are ported (item 12): the identity's solution is b
        xc = fn(A, ((1 + 1j) * b).astype(np.complex64)).x
        assert xc.dtype == torch.complex64 and np.allclose(xc.numpy(), (1 + 1j) * b,
                                                           atol=1e-5)
        with pytest.raises(ValueError, match="length m"):
            fn(A, b[:2])
    for pkg_msgs, port_msgs in ((lj.CRAIG_ISTOP_MESSAGES, lt.CRAIG_ISTOP_MESSAGES),
                                (lj.CGLS_ISTOP_MESSAGES, lt.CGLS_ISTOP_MESSAGES)):
        assert pkg_msgs == port_msgs


def test_craig_breakdown_and_cgls_divergence_guard_match_jax(rng):
    # CRAIG on b with no component in range(A): istop 4 at setup
    data = np.zeros((1, 4))
    data[0, :2] = 1.0
    b = np.array([0.0, 0.0, 1.0, 1.0])
    rj = lj.craig(lj.dia_operator(4, 4, (0,), data), b)
    rt = lt.craig(lt.dia_operator(4, 4, (0,), data, device=DEV), b)
    assert int(rt.istop) == int(rj.istop) == 4 and int(rt.itn) == int(rj.itn) == 0
    # CGLS run past convergence in f32 with zero tolerances: the same
    # istop and iterate as JAX
    m, n, damp, kw, data, b = _problem(rng, "cgls", np.float32)
    kw = dict(atol=0.0, btol=0.0, itnlim=200)
    rj = lj.cgls(lj.dia_operator(m, n, KS, data), b, damp, **kw)
    rt = lt.cgls(lt.dia_operator(m, n, KS, data, device=DEV), b, damp, **kw)
    assert int(rt.istop) == int(rj.istop)
    assert rel_err(rt.x, rj.x) < 1e-4


@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_result_to_numpy_takes_both_packages(rng, solver):
    m, n, damp, kw, data, b = _problem(rng, solver, np.float64)
    rt = _solve(lt, solver, _build("dia", lt, m, n, data), b, damp, **kw)
    rj = _solve(lj, solver, _build("dia", lj, m, n, data), b, damp, **kw)
    got, ref = lt.result_to_numpy(rt), lt.result_to_numpy(rj)
    assert got.keys() == ref.keys() == set(type(rt)._fields)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-7, atol=1e-10)
    assert type(rt).__name__ == type(rj).__name__
