"""The port's preconditioning and scaling (ops/precondition.py) against the
JAX package (the preconditioning cases of tests/test_batch_precond.py).

The same numpy matrices go to both packages (JAX on the CPU in x64, the
port on the CPU). Bounds: column norms within 1e-12 of JAX's and of numpy's
(f64 storage), within 1e-6 for f32 storage; solves on the composites with
JAX's istop and itn and x within 1e-10 of JAX's (relative to max |x|); the
oracles at tests/test_batch_precond.py's tolerances. The f64 shared stripes
are held to scipy's f64 norms within 1e-14, where the JAX package's f32
reading of them is not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops.precondition import column_norms as column_norms_j

from _torch_parity import DEV, banded, rel_err, to_np


def _unique_coo(rng, m, n, nnz):
    flat = rng.choice(m * n, nnz, replace=False)
    return rng.standard_normal(nnz), flat // n, flat % n


def _formats(rng, m=60, n=40):
    """{name: (port operator, JAX operator, dense)} of one f64 matrix per
    storage type with an analytic rule."""
    vals, rows, cols = _unique_coo(rng, m, n, 400)
    dense = np.zeros((m, n))
    dense[rows, cols] = vals
    offs = (-3, 0, 2, 5)
    data, band = banded(rng, m, n, offs, np.float64)
    return {
        "dense": (lt.as_operator(torch.tensor(dense)), lj.as_operator(jnp.asarray(dense)),
                  dense),
        "coo": (lt.coo_operator(m, n, vals, rows, cols, device=DEV),
                lj.coo_operator(m, n, vals, rows, cols), dense),
        "ell": (lt.ell_operator(m, n, vals, rows, cols, device=DEV),
                lj.ell_operator(m, n, vals, rows, cols), dense),
        "dia": (lt.dia_operator(m, n, offs, data, device=DEV),
                lj.dia_operator(m, n, offs, data), band),
        "dia_shared": (lt.dia_shared_operator(m, n, offs, data.astype(np.float32), device=DEV),
                       lj.dia_shared_operator(m, n, offs, data.astype(np.float32)),
                       band.astype(np.float32)),
    }


@pytest.mark.parametrize("fmt", ["dense", "coo", "ell", "dia", "dia_shared"])
def test_column_norms_match_jax_per_format(rng, fmt):
    At, Aj, dense = _formats(rng)[fmt]
    got = lt.column_norms(At)
    tol = 1e-6 if dense.dtype == np.float32 else 1e-12
    np.testing.assert_allclose(to_np(got), np.linalg.norm(dense.astype(np.float64), axis=0),
                               rtol=tol)
    np.testing.assert_allclose(to_np(got), np.asarray(column_norms_j(Aj)), rtol=tol)


def test_column_norms_refuse_other_operators(rng):
    A = lt.vstack_operators([lt.as_operator(torch.eye(3, dtype=torch.float64))])
    with pytest.raises(TypeError, match="no analytic rule"):
        lt.column_norms(A)
    with pytest.raises(TypeError, match="no analytic rule"):
        column_norms_j(lj.vstack_operators([lj.as_operator(jnp.eye(3))]))


@pytest.mark.parametrize("m, n, offs", [(200, 200, (-4, -1, 0, 2, 5)),
                                        (150, 202, (-7, 0, 6)), (202, 150, (-3, 0, 60))])
def test_column_norms_shared_f64_stay_f64(rng, m, n, offs):
    """f64 shared stripes: the halo adds exact zeros and the padding past
    the matrix is never read, so the norms equal scipy's f64 norms and the
    packed layout's; the JAX package reads these stripes in f32 and misses
    that bound (ROADMAP Queue 3), which the port does not copy."""
    data, _ = banded(rng, m, n, offs, np.float64)
    As = lt.dia_shared_operator(m, n, offs, data, device=DEV)
    got = lt.column_norms(As)
    assert got.dtype == torch.float64
    ref = scipy.sparse.linalg.norm(lt.to_scipy(As), axis=0)
    np.testing.assert_allclose(to_np(got), ref, rtol=1e-14)
    np.testing.assert_allclose(to_np(got), to_np(lt.column_norms(
        lt.dia_operator(m, n, offs, data, device=DEV))), rtol=1e-14)
    jax_f32 = np.asarray(column_norms_j(lj.dia_shared_operator(m, n, offs, data)))
    assert np.abs(jax_f32 - ref).max() / ref.max() > 1e-12


def test_column_scaling_matches_jax(rng):
    """A badly column-scaled system: the scaled solve converges in under
    half the iterations, x = scale * z is the LS solution, and the solve
    matches JAX's."""
    m, n = 100, 30
    dense = rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-6, 6, n)
    b = rng.standard_normal(m)
    At, Aj = lt.as_operator(torch.tensor(dense)), lj.DenseOperator(a=jnp.asarray(dense))
    kw = dict(atol=1e-12, btol=1e-12, itnlim=2000)
    raw = lt.lsqr(At, b, 0.0, **kw)
    scaled, scale = lt.column_scaled(At)
    assert isinstance(scaled, lt.ColumnScaledOperator)
    pre = lt.lsqr(scaled, b, 0.0, **kw)
    scaled_j, scale_j = lj.column_scaled(Aj)
    pre_j = lj.lsqr(scaled_j, b, 0.0, **kw)
    np.testing.assert_allclose(to_np(scale), np.asarray(scale_j), rtol=1e-12)
    assert int(pre.itn) == int(pre_j.itn) and int(pre.istop) == int(pre_j.istop)
    assert rel_err(pre.x, np.asarray(pre_j.x)) < 1e-10
    assert int(pre.itn) < int(raw.itn) / 2
    xref = np.linalg.lstsq(dense, b, rcond=None)[0]
    np.testing.assert_allclose(to_np(scale * pre.x), xref, atol=1e-6)


def test_right_preconditioning_matches_jax(rng):
    m, n = 90, 40
    dense = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    M = np.diag(1.0 / np.linalg.norm(dense, axis=0))
    Bt = lt.right_preconditioned(lt.as_operator(torch.tensor(dense)),
                                 lt.as_operator(torch.tensor(M)))
    Bj = lj.right_preconditioned(lj.DenseOperator(a=jnp.asarray(dense)),
                                 lj.DenseOperator(a=jnp.asarray(M)))
    assert isinstance(Bt, lt.ComposedOperator) and Bt.shape == (m, n)
    kw = dict(atol=1e-12, btol=1e-12, itnlim=1000)
    res, res_j = lt.lsqr(Bt, b, 0.0, **kw), lj.lsqr(Bj, b, 0.0, **kw)
    assert int(res.itn) == int(res_j.itn) and int(res.istop) == int(res_j.istop)
    assert rel_err(res.x, np.asarray(res_j.x)) < 1e-10
    xref = np.linalg.lstsq(dense, b, rcond=None)[0]
    np.testing.assert_allclose(M @ to_np(res.x), xref, atol=1e-7)
    with pytest.raises(ValueError, match="M_inv must map"):
        lt.right_preconditioned(Bt, lt.as_operator(torch.eye(3, dtype=torch.float64)))


@pytest.mark.parametrize("solver", ["lsmr", "cgls"])
def test_preconditioning_composes_with_siblings(rng, solver):
    """Column scaling under LSMR and CGLS: fewer than half the iterations,
    the LS solution, and JAX's iterations on the same scaled operator."""
    m, n = 120, 50
    dense = rng.standard_normal((m, n)) * np.logspace(0, 3, n)
    b = rng.standard_normal(m)
    kw = dict(atol=1e-12, btol=1e-12, itnlim=3000)
    At = lt.as_operator(torch.tensor(dense))
    scaled, scale = lt.column_scaled(At)
    scaled_j, _ = lj.column_scaled(lj.DenseOperator(a=jnp.asarray(dense)))
    raw = getattr(lt, solver)(At, b, **kw)
    pre = getattr(lt, solver)(scaled, b, **kw)
    pre_j = getattr(lj, solver)(scaled_j, b, **kw)
    assert int(pre.itn) < int(raw.itn) / 2
    assert int(pre.itn) == int(pre_j.itn) and int(pre.istop) == int(pre_j.istop)
    xref = np.linalg.lstsq(dense, b, rcond=None)[0]
    np.testing.assert_allclose(to_np(scale * pre.x), xref, atol=1e-5)
