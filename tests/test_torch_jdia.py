"""The port's JDIA path against the JAX package: the packing byte for byte
(native assigner and numpy fallback), the product twin against the Pallas
kernel in interpret mode and against ``_jdia_matvec_xla``, the operator's
products, ``operator_from_arrays("jdia")`` and solves.

Inputs come from numpy seeds and go through both packages. JAX runs on the
CPU in x64, the port on the CPU through its plain twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu.native as jnative
import lsqr_tpu_torch as lt
import lsqr_tpu_torch.native as tnative
from lsqr_tpu.ops.jdia import _jdia_matvec_xla
from lsqr_tpu.ops.jdia import jdia_operator as j_jdia_operator
from lsqr_tpu.ops.jdia import jdia_pack as j_jdia_pack
from lsqr_tpu.ops.pallas_spmv import jdia_matvec as j_jdia_matvec
from lsqr_tpu_torch.models.synthetic import jittered_band_coo
from lsqr_tpu_torch.ops.jdia import jdia_pack
from lsqr_tpu_torch.ops.spmv_sparse import jdia_matvec, jdia_matvec_plain

from _torch_parity import DEV, rel_err, to_np

PACK_KEYS = ("data", "eoff", "base", "tdata", "teoff", "tbase", "rem_vals", "rem_rows",
             "rem_cols", "p_lo", "win", "tp_lo", "twin", "tm")
SHAPES = [(600, 600), (900, 500), (500, 900)]


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _pattern(m, n, seed=0, outliers=0.01, dtype=np.float64, diag=0.0):
    return jittered_band_coo(m, n, outliers=outliers, seed=seed, dtype=dtype, diag=diag)


@pytest.fixture(params=["native", "numpy"])
def assigner(request, monkeypatch):
    """Run the packers through the compiled assigner or the numpy loop,
    in both packages alike."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_LIB", False)
        monkeypatch.setattr(tnative, "_LIB", False)
    else:
        assert tnative.available() and jnative.available()
    return request.param


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jdia_pack_equals_jax(assigner, m, n, dtype):
    vals, rows, cols = _pattern(m, n, seed=m + n, dtype=dtype)
    pj = j_jdia_pack(m, n, vals, rows, cols, tm=1024, dtype=dtype)
    pt = jdia_pack(m, n, vals, rows, cols, tm=1024, dtype=dtype)
    assert pt["rem_vals"].size > 0  # the outliers exercise the remainder
    for key in PACK_KEYS:
        a, b = np.asarray(pj[key]), np.asarray(pt[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_jdia_native_and_numpy_packs_agree(monkeypatch):
    vals, rows, cols = _pattern(1500, 1300, seed=3, dtype=np.float32)
    native = jdia_pack(1500, 1300, vals, rows, cols, tm=1024)
    monkeypatch.setattr(tnative, "_LIB", False)
    plain = jdia_pack(1500, 1300, vals, rows, cols, tm=1024)
    for key in PACK_KEYS:
        assert np.asarray(native[key]).tobytes() == np.asarray(plain[key]).tobytes(), key


@pytest.mark.parametrize("m,n", [(2048, 2048), (2500, 1700)])
def test_jdia_plain_matches_jax_kernel_interpret(rng, m, n):
    """jdia_matvec_plain against the Pallas kernel (interpret mode) and the
    XLA oracle, on JAX's own f32 packing, both orientations."""
    vals, rows, cols = _pattern(m, n, seed=5, outliers=0.0, dtype=np.float32)
    A = j_jdia_operator(m, n, vals, rows, cols, tm=1024, use_pallas=False)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    for data, eoff, base, vec, p_lo, win, m_out in (
            (A.data, A.eoff, A.base, x, A.p_lo, A.win, m),
            (A.tdata, A.teoff, A.tbase, y, A.tp_lo, A.twin, n)):
        xp = A._xpad(jnp.asarray(vec), p_lo, win, m_out)
        ref = np.asarray(j_jdia_matvec(data, eoff, base, xp, m=m_out, n=len(vec), win=win,
                                       tm=1024, interpret=True))
        oracle = np.asarray(_jdia_matvec_xla(data, eoff, base, xp, m_out, 1024))
        got = jdia_matvec_plain(_t(np.asarray(data)), _t(np.asarray(eoff)),
                                _t(np.asarray(base)), _t(vec), m=m_out, p_lo=p_lo, tm=1024)
        assert got.dtype == torch.float32 and got.shape == (m_out,)
        np.testing.assert_allclose(to_np(got), ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(to_np(got), oracle, rtol=2e-5, atol=2e-5)
        # the wrapper takes the twin for CPU tensors
        again = jdia_matvec(_t(np.asarray(data)), _t(np.asarray(eoff)), _t(np.asarray(base)),
                            _t(vec), m=m_out, p_lo=p_lo, tm=1024)
        assert torch.equal(again, got)


@pytest.mark.parametrize("m,n", SHAPES)
def test_jdia_f64_operator_matches_jax(rng, m, n):
    vals, rows, cols = _pattern(m, n, seed=11)
    Aj = j_jdia_operator(m, n, vals, rows, cols, tm=1024)
    At = lt.jdia_operator(m, n, vals, rows, cols, tm=1024, device=DEV)
    assert At.dtype == torch.float64 and At.rem_vals.numel() > 0
    assert At.fit_fraction == pytest.approx(Aj.fit_fraction, abs=0)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    assert rel_err(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) < 1e-13
    assert rel_err(At.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y))) < 1e-13
    np.testing.assert_array_equal(to_np(At.todense()), np.asarray(Aj.todense()))


def test_jdia_dtype_rule_matches_jax():
    vals, rows, cols = _pattern(300, 300, seed=2)
    for v in (vals, vals.astype(np.float32), np.round(vals * 10).astype(np.int64)):
        Aj = j_jdia_operator(300, 300, v, rows, cols, tm=1024)
        At = lt.jdia_operator(300, 300, v, rows, cols, tm=1024, device=DEV)
        assert to_np(At.data).dtype == np.asarray(Aj.data).dtype
    At = lt.jdia_operator(300, 300, vals, rows, cols, tm=1024, dtype=torch.float32,
                          device=DEV)
    assert At.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jdia_operator_from_arrays_matches_jax(rng, dtype):
    m, n = 1100, 900
    vals, rows, cols = _pattern(m, n, seed=7, dtype=dtype)
    Aj = j_jdia_operator(m, n, vals, rows, cols, tm=1024)
    arrays = {k: np.asarray(getattr(Aj, k)) for k in PACK_KEYS[:9]}
    meta = {k: getattr(Aj, k) for k in ("m", "n", "p_lo", "win", "tp_lo", "twin", "tm",
                                        "nnz")}
    At = lt.operator_from_arrays("jdia", arrays, meta, device=DEV)
    assert isinstance(At, lt.JDIAOperator) and At.dtype == torch.from_numpy(
        np.zeros(1, dtype)).dtype
    x, y = rng.standard_normal(n).astype(dtype), rng.standard_normal(m).astype(dtype)
    tol = 1e-13 if dtype == np.float64 else 2e-6
    assert rel_err(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) < tol
    assert rel_err(At.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y))) < tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jdia_solve_matches_jax(rng, dtype):
    m, n = 1500, 1200
    vals, rows, cols = _pattern(m, n, seed=13, dtype=dtype, diag=12.0)
    b = rng.standard_normal(m).astype(dtype)
    kw = dict(atol=1e-6, btol=1e-6) if dtype == np.float32 else dict(atol=1e-10, btol=1e-10)
    rj = lj.lsqr(j_jdia_operator(m, n, vals, rows, cols, tm=1024), jnp.asarray(b), 0.01,
                 **kw)
    rt = lt.lsqr(lt.jdia_operator(m, n, vals, rows, cols, tm=1024, device=DEV), _t(b),
                 0.01, **kw)
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= 2
    xj, xt = np.asarray(rj.x), to_np(rt.x)
    if dtype == np.float32:
        np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-8)


def test_jdia_window_budget_refusal_matches_jax():
    """A far outlier widens the slot window past the budget: both packers
    refuse the matrix with ValueError."""
    m = n = 4096
    vals, rows, cols = _pattern(m, n, seed=1, outliers=0.0)
    rows = np.concatenate([rows, [0]])
    cols = np.concatenate([cols, [n - 1]])
    vals = np.concatenate([vals, [1.0]])
    kw = dict(tm=1024, win_budget=4 * 4096)
    with pytest.raises(ValueError, match="window"):
        j_jdia_pack(m, n, vals, rows, cols, **kw)
    with pytest.raises(ValueError, match="window"):
        jdia_pack(m, n, vals, rows, cols, **kw)
