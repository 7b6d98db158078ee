"""The port's multi-damp solves (lsqr_tpu_torch.multidamp) against its own
standalone solves and the JAX package (tests/test_multidamp.py).

One bidiagonalization serves every damp, so each damp's iterates are those
of a standalone solve with that damp: the port holds istop, itn, x and
every estimate bit for bit (``torch.equal``) to its own ``lsqr``/``lsmr`` on
the same product route.

Against JAX's multi-damp sweep (JAX on the CPU in x64, its DIA products as
its own tests run them) the port inherits its standalone solves' rounding
differences: on tests/test_multidamp.py's problems the solves run past
Krylov exhaustion (itn > n at atol = btol = 1e-12), where the recurrence
is rounding noise. So these comparisons hold the bands of the port's
standalone parity (ROADMAP Queue 3): istop equal, itn within 1 (f32: 1%
+ 1), x within 1e-9 of max|x|, rnorm/xnorm/bnorm/dxmax (LSMR: normr,
normx) within 1e-8 and anorm/acond (norma/conda) within 5e-2, relative.
The f32 band's x, rnorm and xnorm are held for its damped problems, within
1e-4 (its condition estimates part by up to 10%): undamped it has
condition 2.2e4, and its x parts by 25% in the standalone solves too.
arnorm, normar and se, noise after exhaustion, are held only against the
port's own solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

from _torch_parity import DEV, banded, rel_err, to_np

DAMPS = [0.0, 1e-6, 1e-3, 0.5, 2.0]
LSQR_FIELDS = ("anorm", "acond", "rnorm", "arnorm", "xnorm", "dxmax", "bnorm")
LSMR_FIELDS = ("normr", "normar", "norma", "conda", "normx")


def _dense(rng, m=60, n=40):
    a = rng.standard_normal((m, n))
    return a, rng.standard_normal(m)


def _band(rng, dtype=np.float32, m=96, offsets=(-2, 0, 3)):
    data, _ = banded(rng, m, m, offsets, dtype, dense=False)
    return data, rng.standard_normal(m).astype(dtype), offsets


def _port_operator(rng, route):
    """(operator, b, damps, tolerance kw, standalone route kw) of a route."""
    if route == "dense":
        a, b = _dense(rng)
        return (lt.as_operator(a, device=DEV), torch.from_numpy(b), DAMPS,
                dict(atol=1e-12, btol=1e-12), {})
    data, b, ks = _band(rng, np.float64 if route == "packed_f64" else np.float32)
    if route == "packed_f64":
        A = lt.dia_operator(96, 96, ks, data, device=DEV)
    else:
        A = lt.dia_shared_operator(96, 96, ks, data, device=DEV)
    pair = route == "shared_pair"
    return (A, torch.from_numpy(b), [0.0, 1e-2, 1.0], dict(atol=1e-5, btol=1e-5),
            dict(pair=pair))


ROUTES = ["dense", "shared_pair", "shared_plain", "packed_f64"]


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
@pytest.mark.parametrize("route", ROUTES)
def test_each_damp_is_its_standalone_solve_bitwise(rng, solver, route):
    """istop, itn, x and every estimate equal to the port's standalone solve
    on the same route (pair, or the plain products)."""
    A, b, damps, tol, kw = _port_operator(rng, route)
    multi = getattr(lt, solver + "_multidamp")
    single = getattr(lt, solver)
    if solver == "lsqr":
        kw = dict(kw, fused=kw.get("pair", False))
    res = multi(A, b, damps, **tol, **kw)
    assert res.x.shape == (len(damps), A.n)
    for j, damp in enumerate(damps):
        ref = single(A, b, damp, **tol, **kw)
        assert int(res.istop[j]) == int(ref.istop), damp
        assert int(res.itn[j]) == int(ref.itn), damp
        assert torch.equal(res.x[j], ref.x), damp
        for f in (LSQR_FIELDS if solver == "lsqr" else LSMR_FIELDS):
            assert torch.equal(getattr(res, f)[j], getattr(ref, f)), (f, damp)


def _near_jax(res, res_j, solver, *, itn_band=lambda itn: 1, x_tol=1e-9, rtol=1e-8,
              loose_rtol=5e-2, damps=None):
    """The bands of the module docstring; with ``damps``, x and the
    estimates of the damped problems only."""
    np.testing.assert_array_equal(to_np(res.istop), np.asarray(res_j.istop))
    itn, itn_j = to_np(res.itn), np.asarray(res_j.itn)
    assert np.all(np.abs(itn - itn_j) <= [itn_band(i) for i in itn_j]), (itn, itn_j)
    rows = [j for j in range(len(itn)) if damps is None or damps[j] > 0]
    for j in rows:
        assert rel_err(res.x[j], res_j.x[j]) <= x_tol, j
    tight = ("rnorm", "xnorm", "bnorm", "dxmax") if solver == "lsqr" else ("normr", "normx")
    loose = ("anorm", "acond") if solver == "lsqr" else ("norma", "conda")
    for fields, tol in ((tight, rtol), (loose, loose_rtol)):
        for f in fields if tol else ():
            np.testing.assert_allclose(to_np(getattr(res, f))[rows],
                                       np.asarray(getattr(res_j, f))[rows], rtol=tol,
                                       err_msg=f)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_dense_matches_jax(rng, solver):
    """tests/test_multidamp.py:30-47 and :118-136, against JAX's sweep."""
    a, b = _dense(rng)
    res = getattr(lt, solver + "_multidamp")(lt.as_operator(a, device=DEV), b, DAMPS,
                                             atol=1e-12, btol=1e-12)
    res_j = getattr(lj, solver + "_multidamp")(lj.DenseOperator(jnp.asarray(a)),
                                               jnp.asarray(b), DAMPS, atol=1e-12, btol=1e-12)
    _near_jax(res, res_j, solver)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_dia_pair_matches_jax(rng, solver):
    """tests/test_multidamp.py:66-80 and :156-170: f32 stripes through the
    port's pair route (its twin), JAX's sweep as its test runs it."""
    data, b, ks = _band(rng)
    damps = [0.0, 1e-2, 1.0] if solver == "lsqr" else [0.0, 0.5]
    A_j = lj.dia_operator(96, 96, ks, jnp.asarray(data))
    res_j = getattr(lj, solver + "_multidamp")(A_j, jnp.asarray(b), damps, atol=1e-5,
                                               btol=1e-5)
    A = lt.operator_from_arrays("dia", {"data": np.asarray(A_j.data),
                                        "tdata": np.asarray(A_j.tdata)},
                                {"m": 96, "n": 96, "offsets": ks}, device=DEV)
    res = getattr(lt, solver + "_multidamp")(A, b, damps, atol=1e-5, btol=1e-5, pair=True)
    _near_jax(res, res_j, solver, itn_band=lambda itn: 1 + itn // 100, x_tol=1e-4,
              rtol=1e-4, loose_rtol=None, damps=damps)


def test_wantse_matches_standalone_and_jax(rng):
    """tests/test_multidamp.py:50-57: se bit for bit against the port's
    standalone solves; x and the estimates against JAX's sweep."""
    a, b = _dense(rng, m=50, n=30)
    damps = [0.0, 1e-2]
    res = lt.lsqr_multidamp(lt.as_operator(a, device=DEV), b, damps, wantse=True,
                            atol=1e-12, btol=1e-12)
    res_j = lj.lsqr_multidamp(lj.DenseOperator(jnp.asarray(a)), jnp.asarray(b), damps,
                              wantse=True, atol=1e-12, btol=1e-12)
    assert res.se.shape == (2, 30)
    _near_jax(res, res_j, "lsqr")
    for j, damp in enumerate(damps):
        ref = lt.lsqr(lt.as_operator(a, device=DEV), b, damp, wantse=True, atol=1e-12,
                      btol=1e-12)
        assert torch.equal(res.se[j], ref.se)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_segment_length_leaves_the_bits(rng, solver):
    """tests/test_multidamp.py:60-63, :139-153: the masked segments' length
    changes no bit."""
    a, b = _dense(rng)
    A = lt.as_operator(a, device=DEV)
    fn = getattr(lt, solver + "_multidamp")
    seg = dict(options=lt.LSQROptions(loop_segment=7)) if solver == "lsqr" else dict(
        loop_segment=5)
    res = fn(A, b, DAMPS, atol=1e-9, btol=1e-9)
    res_s = fn(A, b, DAMPS, atol=1e-9, btol=1e-9, **seg)
    assert torch.equal(res.itn, res_s.itn) and torch.equal(res.istop, res_s.istop)
    assert torch.equal(res.x, res_s.x)


def test_mixed_precision_scalars_are_the_standalone_solve(rng):
    """scalar_dtype f64 over f32 vectors (the plain route), bit for bit."""
    a, b = _dense(rng)
    A = lt.as_operator(a.astype(np.float32), device=DEV)
    b32 = b.astype(np.float32)
    res = lt.lsqr_multidamp(A, b32, [0.0, 0.1], atol=1e-6, btol=1e-6,
                            scalar_dtype=torch.float64)
    for j, damp in enumerate([0.0, 0.1]):
        ref = lt.lsqr(A, b32, damp, atol=1e-6, btol=1e-6, scalar_dtype=torch.float64)
        assert int(res.itn[j]) == int(ref.itn) and torch.equal(res.x[j], ref.x)
        assert res.anorm.dtype == torch.float64


def test_oracle_damped_normal_equations(rng):
    """tests/test_multidamp.py:83-95: each x solves (A'A + damp^2 I) x = A'b."""
    a, b = _dense(rng, m=80, n=30)
    damps = [1e-2, 0.1, 1.0]
    res = lt.lsqr_multidamp(lt.as_operator(a, device=DEV), b, damps, atol=1e-13,
                            btol=1e-13)
    for j, damp in enumerate(damps):
        x = np.linalg.solve(a.T @ a + damp ** 2 * np.eye(30), a.T @ b)
        np.testing.assert_allclose(to_np(res.x[j]), x, rtol=1e-8, atol=1e-10)


def test_lsmr_multidamp_vs_scipy(rng):
    """tests/test_multidamp.py:118-136."""
    a, b = _dense(rng, m=70, n=50)
    damps = [0.0, 1e-3, 0.3]
    res = lt.lsmr_multidamp(lt.as_operator(a, device=DEV), b, damps, atol=1e-10,
                            btol=1e-10)
    for j, damp in enumerate(damps):
        ref = scipy.sparse.linalg.lsmr(a, b, damp=damp, atol=1e-10, btol=1e-10)
        assert int(res.istop[j]) == ref[1] and int(res.itn[j]) == ref[2]
        np.testing.assert_allclose(to_np(res.x[j]), ref[0], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_zero_rhs_and_scalar_damp(rng, solver):
    """tests/test_multidamp.py:98-102, :111-115."""
    fn = getattr(lt, solver + "_multidamp")
    eye = lt.as_operator(np.eye(4), device=DEV)
    res = fn(eye, torch.zeros(4, dtype=torch.float64), [0.0, 1.0])
    assert torch.equal(res.istop, torch.zeros(2, dtype=torch.int32))
    assert torch.equal(res.x, torch.zeros((2, 4), dtype=torch.float64))
    a, b = _dense(rng)
    A = lt.as_operator(a, device=DEV)
    res = fn(A, b, 0.5, atol=1e-10, btol=1e-10)
    assert res.x.shape == (1, 40)
    assert torch.equal(res.x[0], getattr(lt, solver)(A, b, 0.5, atol=1e-10, btol=1e-10).x)


def test_validation_errors(rng):
    """tests/test_multidamp.py:105-112, and JAX's refusals of the pair route
    (lsqr_tpu/multidamp.py:134-143, :672-676)."""
    a, b = _dense(rng)
    A = lt.as_operator(a, device=DEV)
    with pytest.raises(ValueError, match="non-empty"):
        lt.lsqr_multidamp(A, b, np.zeros(0))
    with pytest.raises(ValueError, match="record_trace"):
        lt.lsqr_multidamp(A, b, [0.0], record_trace=True)
    with pytest.raises(ValueError, match="megakernel"):
        lt.lsqr_multidamp(A, b, [0.0], megakernel=True)
    with pytest.raises(ValueError, match="length m"):
        lt.lsqr_multidamp(A, b[:-1], [0.0])
    with pytest.raises(ValueError, match="non-empty"):
        lt.lsmr_multidamp(A, b, [])
    data, bd, ks = _band(rng)
    S = lt.dia_shared_operator(96, 96, ks, data, device=DEV)
    with pytest.raises(ValueError, match="scalar_dtype"):
        lt.lsqr_multidamp(S, bd, [0.0], pair=True, scalar_dtype=torch.float64)
    C = lt.dia_shared_operator(96, 96, ks, data + 1j * data, device=DEV)
    for fn in (lt.lsqr_multidamp, lt.lsmr_multidamp):
        with pytest.raises(ValueError, match="real-f32 only"):
            fn(C, bd + 0j, [0.0], pair=True)
        with pytest.raises(ValueError, match="fused_pair"):
            fn(A, b, [0.0], pair=True)
