"""Gradients through the port's solver (lsqr_tpu_torch.implicit) against the
JAX package (tests/test_implicit.py), the dense closed form and central
differences, JAX on the CPU in x64.

Bands: tests/test_implicit.py's (b 1e-10 and dense entries 1e-9 absolute
against the closed form, damp 1e-9 relative; central differences within
1e-5 for COO values and 1e-4 for stripes), and the same bands against
JAX's gradients. The packed DIA operator is built by
``dia_operator_device`` from stripes that require grad, so its transpose
stripes follow them, as JAX's test rebuilds them; the shared layout's
stripes are held against JAX's dense-entry gradient on the band.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.implicit import lsqr_grad as lsqr_grad_j
from lsqr_tpu.implicit import normal_cg as normal_cg_j

from _torch_parity import DEV, to_np

TIGHT = dict(atol=1e-14, btol=1e-14)


@pytest.fixture
def problem(rng):
    m, n = 30, 18
    return m, n, rng.standard_normal((m, n)), rng.standard_normal(m), rng.standard_normal(n)


def _closed_form(a, b, lam):
    n = a.shape[1]
    return torch.linalg.solve(a.T @ a + lam * lam * torch.eye(n, dtype=a.dtype), a.T @ b)


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float64, requires_grad=grad)


def _grad(loss, *inputs):
    return torch.autograd.grad(loss(*inputs), inputs)


def test_normal_cg_solves_and_matches_jax(rng):
    """tests/test_implicit.py:34-43."""
    a = rng.standard_normal((40, 25))
    g = rng.standard_normal(25)
    s = lt.normal_cg(lt.as_operator(a, device=DEV), 0.4, g, tol=1e-12)
    s_j = normal_cg_j(lj.as_operator(jnp.asarray(a)), jnp.asarray(0.4), jnp.asarray(g),
                      tol=1e-12)
    normal = a.T @ a + 0.16 * np.eye(25)
    np.testing.assert_allclose(normal @ to_np(s), g, atol=1e-8)
    np.testing.assert_allclose(to_np(s), np.asarray(s_j), atol=1e-8)
    assert not lt.normal_cg(lt.as_operator(a, device=DEV), 0.4, np.zeros(25)).any()


def test_grad_b_damp_and_entries_match_closed_form_and_jax(problem):
    """tests/test_implicit.py:46-82: gradients to b, the dense entries and
    damp."""
    m, n, a, b, tgt = problem

    def loss(mat, vec, damp):
        return torch.sum((lt.lsqr_grad(lt.as_operator(mat), vec, damp, **TIGHT) - _t(tgt)) ** 2)

    def loss_exact(mat, vec, damp):
        return torch.sum((_closed_form(mat, vec, damp) - _t(tgt)) ** 2)

    inputs = (_t(a, True), _t(b, True), _t(0.3, True))
    got = _grad(loss, *inputs)
    want = _grad(loss_exact, *inputs)

    def loss_j(mat, vec, damp):
        return jnp.sum((lsqr_grad_j(mat, vec, damp, **TIGHT) - tgt) ** 2)

    jax_grads = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b),
                                                   jnp.asarray(0.3))
    for g, w, j, tol in zip(got, want, jax_grads, (1e-9, 1e-10, None)):
        if tol is None:  # damp, relative
            np.testing.assert_allclose(float(g), float(w), rtol=1e-9)
            np.testing.assert_allclose(float(g), float(j), rtol=1e-9)
        else:
            np.testing.assert_allclose(to_np(g), to_np(w), atol=tol)
            np.testing.assert_allclose(to_np(g), np.asarray(j), atol=tol)


def test_grad_coo_values_match_jax_and_differences(rng, problem):
    """tests/test_implicit.py:76-94."""
    m, n, _, b, tgt = problem
    rr, cc = rng.integers(0, m, 120), rng.integers(0, n, 120)
    vv = rng.standard_normal(120)

    def loss(v):
        A = lt.coo_operator(m, n, v, rr, cc, device=DEV)
        return torch.sum((lt.lsqr_grad(A, b, 0.3, **TIGHT) - _t(tgt)) ** 2)

    def loss_j(v):
        A = lj.coo_operator(m, n, v, rr, cc)
        return jnp.sum((lsqr_grad_j(A, jnp.asarray(b), 0.3, **TIGHT) - tgt) ** 2)

    (gv,) = _grad(loss, _t(vv, True))
    np.testing.assert_allclose(to_np(gv), np.asarray(jax.grad(loss_j)(jnp.asarray(vv))),
                               atol=1e-9)
    for i in (0, 7, 42):
        e = 1e-6
        up, down = vv.copy(), vv.copy()
        up[i] += e
        down[i] -= e
        fd = (float(loss(_t(up))) - float(loss(_t(down)))) / (2 * e)
        assert abs(float(gv[i]) - fd) < 1e-5


def _band(rng, m=60):
    offsets = (-1, 0, 1)
    data = rng.standard_normal((3, m))
    data[1] += 4.0
    return m, offsets, data, rng.standard_normal(m), rng.standard_normal(m)


def _jax_stripe_loss(m, offsets, b, tgt):
    """tests/test_implicit.py:97-132's loss: the JAX DIA operator rebuilt
    from traced stripes (its transpose stripes too)."""
    base = lj.dia_operator(m, m, offsets, np.zeros((3, m)), use_pallas=False)

    def shift(row, k):
        return jnp.pad(row[: m - k], (k, 0)) if k >= 0 else jnp.pad(row[-k:], (0, -k))

    def loss(data):
        tdata = jnp.stack([shift(data[j], offsets[j]) for j in range(3)])
        A = dataclasses.replace(base, data=data, tdata=tdata)
        return jnp.sum((lsqr_grad_j(A, jnp.asarray(b), 0.2, **TIGHT) - tgt) ** 2)

    return loss


@pytest.mark.parametrize("layout", ["packed", "shared"])
def test_grad_dia_stripes_match_jax_and_differences(rng, layout):
    """tests/test_implicit.py:97-132 on both layouts: every stripe entry
    against JAX's gradient, and central differences at three entries."""
    m, offsets, data0, b, tgt = _band(rng)
    if layout == "packed":
        def build(d):
            return lt.dia_operator_device(m, m, offsets, d)
    else:
        def build(d):
            return lt.dia_shared_operator(m, m, offsets, d, device=DEV)

    def loss(data):
        return torch.sum((lt.lsqr_grad(build(data), b, 0.2, **TIGHT) - _t(tgt)) ** 2)

    (g,) = _grad(loss, _t(data0, True))
    if layout == "packed":
        want = np.asarray(jax.grad(_jax_stripe_loss(m, offsets, b, tgt))(jnp.asarray(data0)))
    else:
        # JAX's gradient to the dense entries, read on the band
        dense = to_np(lt.dia_shared_operator(m, m, offsets, data0, device=DEV).todense())
        gd = np.asarray(jax.grad(lambda a: jnp.sum(
            (lsqr_grad_j(a, jnp.asarray(b), 0.2, **TIGHT) - tgt) ** 2))(jnp.asarray(dense)))
        i = np.arange(m)
        want = np.zeros_like(data0)
        for d, k in enumerate(offsets):
            ok = (i + k >= 0) & (i + k < m)
            want[d, ok] = gd[i[ok], i[ok] + k]
    np.testing.assert_allclose(to_np(g), want, atol=1e-9)
    for j, i in ((0, 5), (1, 30), (2, 50)):
        e = 1e-6
        up, down = data0.copy(), data0.copy()
        up[j, i] += e
        down[j, i] -= e
        fd = (float(loss(_t(up))) - float(loss(_t(down)))) / (2 * e)
        assert abs(float(g[j, i]) - fd) < 1e-4, (j, i)


def test_other_operators_refuse_value_gradients(rng, problem):
    """A tensor that requires grad on an operator without sampled gradients
    raises TypeError naming those that have them; b and damp take
    gradients through any operator."""
    m, n, a, b, tgt = problem
    rr, cc = rng.integers(0, m, 120), rng.integers(0, n, 120)
    coo = lt.coo_operator(m, n, _t(rng.standard_normal(120), True), rr, cc, device=DEV)
    with pytest.raises(TypeError, match="DIASharedOperator"):
        lt.lsqr_grad(lt.scale_operator(coo, 2.0), b)
    ell = lt.ell_operator(m, n, rng.standard_normal(120), rr, cc, device=DEV)
    dense = ell.todense()
    vec, damp = _t(b, True), _t(0.3, True)
    got = _grad(lambda v, d: torch.sum((lt.lsqr_grad(ell, v, d, **TIGHT) - _t(tgt)) ** 2),
                vec, damp)
    want = _grad(lambda v, d: torch.sum((_closed_form(dense, v, d) - _t(tgt)) ** 2), vec, damp)
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), atol=1e-10)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-9)
