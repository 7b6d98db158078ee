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
from lsqr_tpu_torch.ops.linop import CallbackOperator

from _torch_parity import DEV, banded, to_np

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


def _unique(rng, m, n, nnz):
    """nnz distinct (row, col) pairs."""
    flat = rng.choice(m * n, nnz, replace=False)
    return flat // n, flat % n


def _zipf(rng, m, n, nnz, a=1.5):
    cols = rng.zipf(a, size=6 * nnz) - 1
    cols = cols[cols < n][:nnz].astype(np.int64)
    return rng.standard_normal(cols.size).astype(np.float32), rng.integers(0, m, cols.size), cols


def _jdia_pattern(rng, m, n):
    """Five jittered diagonals with the main one boosted, and 4% of the
    entries at random columns: a JDIA packing with a remainder."""
    rows = np.repeat(np.arange(m), 5)
    cols = rows + np.tile([-9, -2, 0, 3, 14], m) + rng.integers(-3, 4, rows.size)
    far = rng.random(rows.size) < 0.04
    cols[far] = rng.integers(0, n, far.sum())
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    _, first = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[first], cols[first]
    vals = rng.standard_normal(rows.size) + 4.0 * (rows == cols)
    return vals, rows, cols


def _dev(b):
    return torch.as_tensor(b).to(DEV)


def _get(obj, path):
    for part in path.split("."):
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    return obj


#: f64 layouts: the forward solve to 1e-14, every leaf within 1e-9 of JAX's
#: gradient (tests/test_implicit.py's band for dense entries)
F64 = dict(kw=TIGHT, damp=0.2, band=1e-9, fd=1e-6, fd_band=1e-5)
#: f32 chunked layouts (their products compute in f32 in both packages):
#: damped so that both forward solves stop on their own (istop 3, ~40
#: iterations on these Zipf patterns) where their x agree to ~1e-6 of its
#: size; the gradient is a product of x, its residual and the CG solution,
#: ~6e-7 of the largest entry apart (measured), held to 2e-5 of it. Central
#: differences of the f32 loss (summed in f64) take the entry of the largest
#: gradient, a step of 0.03 and 2e-3 of the gradient: the step's truncation
#: error is ~1e-4 of it, x's f32 rounding (~1e-7 of each entry) ~3e-5.
F32 = dict(kw=dict(atol=1e-7, btol=1e-7, itnlim=200), damp=3.0, band=2e-5, fd=0.03,
           fd_band=2e-3)


def _case(name, rng):
    """(port operator, JAX operator, the builder of the port's operator
    from the triplet values, those values, the paths of the leaves packed
    from them, the paths of the other leaves, precision)."""
    from lsqr_tpu.ops.jdia import jdia_operator as j_jdia
    from lsqr_tpu.ops.linop import _TransposedOperator as JT

    m, n = 40, 26
    rows, cols = _unique(rng, m, n, 160)
    vals = rng.standard_normal(160)

    def ell(v):
        return lt.ell_operator(m, n, v, rows, cols, device=DEV)

    def coo(v):
        return lt.coo_operator(m, n, v, rows, cols, device=DEV)

    d = rng.uniform(0.5, 2.0, n)
    if name == "ell":
        return ell(vals), lj.ell_operator(m, n, vals, rows, cols), ell, vals, \
            ["vals", "tvals"], [], F64
    if name == "hyb":
        def build(v):
            return lt.hyb_operator(m, n, v, rows, cols, width=3, device=DEV)
        Aj = lj.hyb_operator(m, n, vals, rows, cols, width=3)
        return build(vals), Aj, build, vals, ["ops.0.vals", "ops.0.tvals", "ops.1.vals"], \
            [], F64
    if name == "jdia":
        jm, jn = 300, 280
        jv, jr, jc = _jdia_pattern(rng, jm, jn)

        def build(v):
            return lt.jdia_operator(jm, jn, v, jr, jc, ns_max=4, tm=128, device=DEV)
        Aj = j_jdia(jm, jn, jv, jr, jc, ns_max=4, tm=128)
        assert build(jv).rem_vals.numel() > 0
        return build(jv), Aj, build, jv, ["data", "tdata", "rem_vals"], [], F64
    if name == "block_ell":
        def build(v):
            return lt.block_ell_operator(m, n, v, rows, cols, block=(8, 8), device=DEV)
        Aj = lj.block_ell_operator(m, n, vals, rows, cols, block=(8, 8))
        return build(vals), Aj, build, vals, ["blocks", "tblocks"], [], F64
    if name in ("wcoo", "wwcoo", "rwcoo"):
        cm, cn, nnz = {"wcoo": (2048, 256, 8000), "wwcoo": (2048, 8192, 8000),
                       "rwcoo": (4096, 8192, 20000)}[name]
        cv, cr, cc = _zipf(rng, cm, cn, nnz)

        def build(v):
            return getattr(lt, name + "_operator")(cm, cn, v, cr, cc, device=DEV)
        Aj = getattr(lj, name + "_operator")(cm, cn, cv, cr, cc, use_pallas=False)
        return build(cv), Aj, build, cv, ["coo.vals"], [], F32
    if name == "vstack":
        def build(v):
            return lt.vstack_operators([ell(v), lt.diagonal_operator(d, device=DEV)])
        Aj = lj.vstack_operators([lj.ell_operator(m, n, vals, rows, cols),
                                  lj.diagonal_operator(d)])
        return build(vals), Aj, build, vals, ["ops.0.vals", "ops.0.tvals"], ["ops.1.d"], F64
    if name == "hstack":
        r2, c2 = _unique(rng, m, 9, 50)
        v2 = rng.standard_normal(50)

        def build(v):
            return lt.hstack_operators([ell(v), lt.coo_operator(m, 9, v2, r2, c2, device=DEV)])
        Aj = lj.hstack_operators([lj.ell_operator(m, n, vals, rows, cols),
                                  lj.coo_operator(m, 9, v2, r2, c2)])
        return build(vals), Aj, build, vals, ["ops.0.vals", "ops.0.tvals"], ["ops.1.vals"], F64
    if name == "sum":
        def build(v):
            return lt.add_operators([ell(v), lt.block_ell_operator(
                m, n, v, rows, cols, block=(8, 8), device=DEV)])
        Aj = lj.add_operators([lj.ell_operator(m, n, vals, rows, cols),
                               lj.block_ell_operator(m, n, vals, rows, cols, block=(8, 8))])
        return build(vals), Aj, build, vals, \
            ["ops.0.vals", "ops.0.tvals", "ops.1.blocks", "ops.1.tblocks"], [], F64
    if name == "scaled":
        def build(v):
            return lt.scale_operator(ell(v), torch.tensor(1.7, dtype=torch.float64))
        Aj = lj.scale_operator(lj.ell_operator(m, n, vals, rows, cols), 1.7)
        return build(vals), Aj, build, vals, ["op.vals", "op.tvals"], ["alpha"], F64
    if name == "diagonal":
        def build(v):
            return lt.diagonal_operator(v, device=DEV)
        return build(d), lj.diagonal_operator(d), build, d, ["d"], [], F64
    if name == "column_scaled":
        from lsqr_tpu_torch.ops.precondition import ColumnScaledOperator

        def build(v):
            return ColumnScaledOperator(op=coo(v), scale=_dev(d))
        Aj = lj.ColumnScaledOperator(op=lj.coo_operator(m, n, vals, rows, cols),
                                     scale=jnp.asarray(d))
        return build(vals), Aj, build, vals, ["op.vals"], ["scale"], F64
    if name == "composed":
        def build(v):
            return lt.right_preconditioned(coo(v), lt.diagonal_operator(d, device=DEV))
        Aj = lj.right_preconditioned(lj.coo_operator(m, n, vals, rows, cols),
                                     lj.diagonal_operator(d))
        return build(vals), Aj, build, vals, ["outer.vals"], ["inner.d"], F64
    if name == "transposed":
        def build(v):
            return ell(v).T
        Aj = JT(op=lj.ell_operator(m, n, vals, rows, cols))
        return build(vals), Aj, build, vals, ["op.vals", "op.tvals"], [], F64
    if name == "warm_start":
        from lsqr_tpu_torch.solver import damped_warm_start

        offsets = (-2, 0, 1, 3)
        data, _ = banded(rng, 60, 50, offsets, dtype=np.float64, boost=3.0)
        x0, b = rng.standard_normal(50), rng.standard_normal(60)

        def build(v):
            A = lt.dia_shared_operator(60, 50, offsets, v.reshape(4, 60), device=DEV)
            return damped_warm_start(A, _dev(b), _dev(x0), 0.3)[0]
        Aj = lj.vstack_operators([lj.dia_shared_operator(60, 50, offsets, data),
                                  lj.diagonal_operator(np.full(50, 0.3))])
        return build(data.ravel()), Aj, build, data.ravel(), ["ops.0.dp"], ["ops.1.d"], F64
    if name == "paige_saunders":
        from lsqr_tpu.models.paige_saunders import lstp as lstp_j
        from lsqr_tpu_torch.models.paige_saunders import lstp

        P = lstp(30, 20, 2, 1, 0.1, dtype=torch.float64, device=DEV)
        Pj = lstp_j(30, 20, 2, 1, 0.1)
        np.testing.assert_allclose(to_np(P.A.d), np.asarray(Pj.A.d), rtol=1e-15)

        def build(v):
            return dataclasses.replace(P.A, d=_dev(v))
        return P.A, Pj.A, build, to_np(P.A.d), ["d"], ["hy", "hz"], F64
    raise AssertionError(name)


LAYOUTS = ["ell", "hyb", "jdia", "block_ell", "wcoo", "wwcoo", "rwcoo", "vstack", "hstack",
           "sum", "scaled", "diagonal", "column_scaled", "composed", "transposed",
           "warm_start", "paige_saunders"]


def _port_grads(A, paths, b, damp, tgt, kw):
    leaves = [_get(A, p) for p in paths]
    for t in leaves:
        t.requires_grad_(True)
    info = {}
    try:
        loss = torch.sum((lt.lsqr_grad(A, _dev(b), damp, info=info, **kw) - tgt) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        assert info["istop"] in (1, 2, 3) and info["itn"] > 0 and info["cg_itn"] > 0, info
        return grads
    finally:
        for t in leaves:
            t.requires_grad_(False)


@pytest.mark.parametrize("name", LAYOUTS)
def test_grad_every_leaf_matches_jax(rng, name):
    """Every value tensor of each layout (padding included) against JAX's
    gradient pytree on the same operator; then central differences of the
    loss in one triplet value against the gradient read on the leaves
    packed from it (the packer is linear in the values)."""
    A, Aj, build, vals, packed, others, prec = _case(name, rng)
    dt = np.float32 if prec is F32 else np.float64
    b = rng.standard_normal(A.m).astype(dt)
    tgt = rng.standard_normal(A.n).astype(dt)
    damp, kw = prec["damp"], prec["kw"]
    paths = packed + others
    got = _port_grads(A, paths, b, damp, _dev(tgt), kw)

    def loss_j(op):
        return jnp.sum((lsqr_grad_j(op, jnp.asarray(b), damp, **kw) - tgt) ** 2)

    want = jax.grad(loss_j, allow_int=True)(Aj)
    scale = max(float(np.abs(np.asarray(_get(want, p))).max()) for p in paths)
    tol = prec["band"] * (scale if prec is F32 else 1.0)
    for path, g in zip(paths, got):
        w = np.asarray(_get(want, path))
        assert g.shape == w.shape, path
        np.testing.assert_allclose(to_np(g), w, atol=tol, err_msg=path)
    if name == "ell":  # the padding slots take -(A s)_i x_0, as in JAX
        pad = to_np(A.vals) == 0
        assert pad.any() and np.abs(to_np(got[0])[pad]).max() > 1e-3
    if prec is F32:  # JAX's packed copies take zeros; the port's take nothing
        assert not np.asarray(want.packed.vals if name != "rwcoo" else want.hot.vals).any()

    # central differences in one triplet value: the largest (f32: the one of
    # the largest gradient, whose loss change stands above the rounding)
    k = int(torch.argmax(got[0].abs())) if prec is F32 else int(np.argmax(np.abs(vals)))
    probe = build(np.eye(1, len(vals), k, dtype=vals.dtype).ravel())
    direction = sum(float(torch.sum(g * _get(probe, p).to(g.dtype)))
                    for p, g in zip(packed, got))

    def loss(v):
        x = lt.lsqr_grad(build(v), _dev(b), damp, **kw).double()
        return float(torch.sum((x - _dev(tgt)) ** 2))
    e = prec["fd"] * max(1.0, abs(float(vals[k])))
    up, down = vals.copy(), vals.copy()
    up[k] += e
    down[k] -= e
    fd = (loss(up) - loss(down)) / (2 * e)
    assert abs(direction - fd) <= prec["fd_band"] * max(1.0, abs(fd)), (direction, fd)


def test_other_operators_refuse_value_gradients(rng, problem):
    """The refusals that remain: a tensor that requires grad on a callback
    operator (opaque products, so no stored values: JAX gives callbacks no
    gradient) raises TypeError naming it and why; complex operators are
    refused whole (real-only in both packages). b and damp take gradients
    through any real operator, a callback too."""
    m, n, a, b, tgt = problem
    held = _t(a, True)
    cb = CallbackOperator(m, n, lambda x: held @ x, lambda y: held.T @ y, _device=DEV)
    with pytest.raises(TypeError, match="CallbackOperator.*opaque callables"):
        lt.lsqr_grad(cb, b)
    with pytest.raises(TypeError, match="real-only"):
        lt.lsqr_grad(lt.zdia_operator(m, n, (0, 1), (rng.standard_normal((2, m))
                                                      + 1j * rng.standard_normal((2, m))),
                                      device=DEV), b)
    plain = _t(a)
    for op in (CallbackOperator(m, n, lambda x: plain @ x, lambda y: plain.T @ y, _device=DEV),
               lt.ell_operator(m, n, a.ravel(), np.repeat(np.arange(m), n),
                               np.tile(np.arange(n), m), device=DEV)):
        vec, damp = _t(b, True), _t(0.3, True)
        got = _grad(lambda v, d: torch.sum((lt.lsqr_grad(op, v, d, **TIGHT) - _t(tgt)) ** 2),
                    vec, damp)
        want = _grad(lambda v, d: torch.sum((_closed_form(plain, v, d) - _t(tgt)) ** 2),
                     vec, damp)
        np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), atol=1e-10)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-9)
