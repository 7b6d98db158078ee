"""The port's regularization paths (lsqr_tpu_torch.regpath) against the JAX
package (tests/test_regpath.py), JAX on the CPU in x64.

The problem is tests/test_regpath.py's: a smooth ill-posed 80 x 40 matrix
(singular values 1 to 1e-6) and a noisy b. Its small damps take 150-160
iterations, past Krylov exhaustion, where the port and JAX stop up to two
iterations apart (their standalone solves' rounding, ROADMAP Queue 3). So
the path is held against JAX's at: residual norms within 1e-5 and solution
norms within 1e-3 (relative to the largest), the same grid points chosen by
the discrepancy principle, the L-curve and GCV, and GCV's values within 1e-4
(with JAX's Rademacher probes passed to the port). The checks of
tests/test_regpath.py hold as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.regpath import gcv_damp as gcv_damp_j

from _torch_parity import DEV, rel_err, to_np


def _ill_posed(rng, m=80, n=40, noise=1e-2):
    """tests/test_regpath.py:12-23."""
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 10.0 ** np.linspace(0, -6, n)
    A = U @ np.diag(s) @ V.T
    x_true = V @ (rng.standard_normal(n) / (1 + np.arange(n)))
    e = rng.standard_normal(m)
    e *= noise / np.linalg.norm(e)
    return A, A @ x_true + e, x_true, noise


def _both(A):
    return lt.as_operator(A, device=DEV), lj.DenseOperator(jnp.asarray(A))


def _path_near_jax(path, path_j):
    np.testing.assert_allclose(to_np(path.damps), np.asarray(path_j.damps), rtol=1e-12)
    np.testing.assert_array_equal(to_np(path.result.istop), np.asarray(path_j.result.istop))
    assert rel_err(path.residual_norm, path_j.residual_norm) <= 1e-5
    assert rel_err(path.solution_norm, path_j.solution_norm) <= 1e-3


@pytest.mark.parametrize("exact", [False, True], ids=["estimates", "exact_residual"])
def test_reg_sweep_matches_jax(rng, exact):
    """tests/test_regpath.py:26-41: the path, with the residual from the
    exit estimates or from one product a damp."""
    A, b, _, _ = _ill_posed(rng)
    At, Aj = _both(A)
    damps = np.logspace(-5, 0, 8)
    path = lt.reg_sweep(At, b, damps, exact_residual=exact, atol=1e-12, btol=1e-12)
    path_j = lj.reg_sweep(Aj, jnp.asarray(b), jnp.asarray(damps), exact_residual=exact,
                          atol=1e-12, btol=1e-12)
    _path_near_jax(path, path_j)
    assert np.all(np.diff(to_np(path.residual_norm)) >= -1e-10)
    assert np.all(np.diff(to_np(path.solution_norm)) <= 1e-10)


def test_reg_sweep_residual_identity(rng):
    """tests/test_regpath.py:26-41: the estimate-based norms against the
    computed ones, and the products of the computed ones."""
    A, b, _, _ = _ill_posed(rng)
    At = lt.as_operator(A, device=DEV)
    damps = np.logspace(-5, 0, 8)
    est = lt.reg_sweep(At, b, damps, atol=1e-12, btol=1e-12)
    exact = lt.reg_sweep(At, b, damps, exact_residual=True, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(to_np(est.residual_norm), to_np(exact.residual_norm),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(to_np(est.solution_norm), to_np(exact.solution_norm), rtol=1e-6)
    x = to_np(exact.x)
    np.testing.assert_allclose(to_np(exact.residual_norm),
                               np.linalg.norm(b[None, :] - x @ A.T, axis=1), rtol=1e-12)


def test_reg_sweep_default_grid_matches_jax(rng):
    """tests/test_regpath.py:44-49: the grid anchored at ||A'b|| / ||b||."""
    A, b, _, _ = _ill_posed(rng)
    At, Aj = _both(A)
    path = lt.reg_sweep(At, b, num=6, atol=1e-10, btol=1e-10)
    path_j = lj.reg_sweep(Aj, jnp.asarray(b), num=6, atol=1e-10, btol=1e-10)
    assert path.damps.shape == (6,) and path.x.shape == (6, 40)
    assert float(path.damps.min()) > 0
    _path_near_jax(path, path_j)


def test_discrepancy_principle_matches_jax(rng):
    """tests/test_regpath.py:52-69."""
    A, b, x_true, noise = _ill_posed(rng, noise=1e-2)
    At, Aj = _both(A)
    grid = np.logspace(-6, 0, 20)
    damp, x, path = lt.discrepancy_damp(At, b, noise, tau=1.05, damps=grid, atol=1e-12,
                                        btol=1e-12)
    damp_j, _, path_j = lj.discrepancy_damp(Aj, jnp.asarray(b), noise, tau=1.05,
                                            damps=jnp.asarray(grid), atol=1e-12, btol=1e-12)
    assert float(damp) == float(damp_j)
    _path_near_jax(path, path_j)
    assert np.linalg.norm(b - A @ to_np(x)) <= 1.05 * noise * (1 + 1e-6)
    d = to_np(path.damps)
    bigger = d[d > float(damp)]
    if bigger.size:
        j = int(np.argmin(np.abs(d - bigger.min())))
        assert float(path.residual_norm[j]) > 1.05 * noise
    assert np.linalg.norm(to_np(x) - x_true) <= np.linalg.norm(to_np(path.x[0]) - x_true)


def test_discrepancy_no_acceptable_point(rng):
    """tests/test_regpath.py:72-79: the smallest residual's damp."""
    A, b, _, _ = _ill_posed(rng)
    damp, _, path = lt.discrepancy_damp(lt.as_operator(A, device=DEV), b, 1e-30,
                                        damps=[1e-3, 1e-1], atol=1e-12, btol=1e-12)
    assert float(damp) == float(path.damps[int(torch.argmin(path.residual_norm))])


def test_lcurve_corner_matches_jax(rng):
    """tests/test_regpath.py:82-97: the same corner and curvature."""
    A, b, x_true, _ = _ill_posed(rng, noise=1e-3)
    At, Aj = _both(A)
    grid = np.logspace(-8, 0, 25)
    path = lt.reg_sweep(At, b, grid, atol=1e-12, btol=1e-12)
    path_j = lj.reg_sweep(Aj, jnp.asarray(b), jnp.asarray(grid), atol=1e-12, btol=1e-12)
    damp, x, kappa = lt.lcurve_corner(path)
    damp_j, _, kappa_j = lj.lcurve_corner(path_j)
    assert kappa.shape == path.damps.shape
    assert float(damp) == float(damp_j)
    assert rel_err(kappa[1:-1], np.asarray(kappa_j)[1:-1]) <= 1e-3
    assert float(kappa[0]) == float(kappa[-1]) == -np.inf
    err = np.linalg.norm(to_np(x) - x_true)
    assert err < min(np.linalg.norm(to_np(path.x[0]) - x_true),
                     np.linalg.norm(to_np(path.x[-1]) - x_true))
    with pytest.raises(ValueError, match="at least 3"):
        lt.lcurve_corner(lt.reg_sweep(At, b, [1e-3, 1e-2], atol=1e-10, btol=1e-10))


def test_gcv_damp_matches_jax(rng):
    """tests/test_regpath.py:100-115: with JAX's probes the same GCV curve
    and choice; with the port's own probes the choice regularizes."""
    A, b, x_true, _ = _ill_posed(rng, m=120, n=50, noise=1e-2)
    At, Aj = _both(A)
    grid = np.logspace(-6, 0, 15)
    kw = dict(atol=1e-12, btol=1e-12)
    damp_j, _, _, gcv_j = gcv_damp_j(Aj, jnp.asarray(b), damps=jnp.asarray(grid), probes=2,
                                     **kw)
    key, probes = jax.random.PRNGKey(0), []
    for _ in range(2):  # gcv_damp's draws (lsqr_tpu/regpath.py:219-221)
        key, sub = jax.random.split(key)
        probes.append(np.asarray(jax.random.rademacher(sub, (120,), dtype=jnp.float64)))
    damp, x, path, gcv = lt.gcv_damp(At, b, damps=grid, probes=np.stack(probes), **kw)
    assert float(damp) == float(damp_j)
    assert rel_err(gcv, gcv_j) <= 1e-4
    damp, x, path, gcv = lt.gcv_damp(At, b, damps=grid, probes=2, **kw)
    assert gcv.shape == path.damps.shape
    assert float(damp) == float(path.damps[int(torch.argmin(gcv))])
    errs = [np.linalg.norm(to_np(path.x[j]) - x_true) for j in range(len(grid))]
    assert np.linalg.norm(to_np(x) - x_true) <= 10 * min(errs)
    assert np.linalg.norm(to_np(x) - x_true) < 0.2 * errs[0]
