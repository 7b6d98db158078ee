"""Core layers of the PyTorch port against the JAX package: config, BLAS-1
primitives, the dense/callback/COO operators, carrying operators across
(ops/convert.py), and the rule that the port never imports JAX."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops import blas as jblas
from lsqr_tpu_torch.ops import blas as tblas

from _torch_parity import DEV, banded, jax_imports_in, rel_err, shared_to_torch, to_np

EDGE_VECTORS = {
    "zeros": np.zeros(7),
    "huge": np.full(5, 1e300),
    "tiny": np.full(5, 1e-300),
    "mixed_scale": np.array([1e300, -1e-300, 3.0, 0.0, -2e299]),
    "one": np.array([-4.0]),
    "random": np.random.default_rng(3).standard_normal(1000),
}


@pytest.mark.parametrize("name", sorted(EDGE_VECTORS))
@pytest.mark.parametrize("safe", [True, False])
def test_nrm2_matches_jax(name, safe):
    x = EDGE_VECTORS[name]
    ref = float(jblas.nrm2(jnp.asarray(x), safe=safe))
    got = float(tblas.nrm2(torch.from_numpy(x), safe=safe))
    if not np.isfinite(ref):
        assert got == ref
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)


D2NORM_PAIRS = [(0.0, 0.0), (3.0, -4.0), (1e300, 1e300), (1e-300, -1e-300),
                (-2.0, 1e-20), (0.0, 5.0), (1.5e154, 2.5e154)]


@pytest.mark.parametrize("a,b", D2NORM_PAIRS)
def test_d2norm_matches_jax(a, b):
    ref = float(jblas.d2norm(jnp.float64(a), jnp.float64(b)))
    got = float(tblas.d2norm(torch.tensor(a, dtype=torch.float64),
                             torch.tensor(b, dtype=torch.float64)))
    # same operation order; XLA's sqrt/divide may round the last ulp apart
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)


def test_safe_divide_and_abs2():
    num = np.array([1.0, -2.0, 0.0, 5.0])
    den = np.array([2.0, 0.0, 0.0, -0.5])
    ref = np.asarray(jblas.safe_divide(jnp.asarray(num), jnp.asarray(den)))
    got = to_np(tblas.safe_divide(torch.from_numpy(num), torch.from_numpy(den)))
    np.testing.assert_array_equal(got, ref)
    z = np.array([3 + 4j, -1j, 0.5])
    np.testing.assert_array_equal(to_np(tblas.abs2(torch.from_numpy(z))),
                                  np.asarray(jblas.abs2(jnp.asarray(z))))


def test_options_mirror_jax():
    jf = {f.name: f.default for f in dataclasses.fields(lj.LSQROptions)}
    tf = {f.name: f.default for f in dataclasses.fields(lt.LSQROptions)}
    assert tf == jf
    opts = lt.LSQROptions(itnlim=None).replace(atol=1e-3)
    assert opts.atol == 1e-3 and opts.resolve_itnlim(7) == 28


def test_dtype_policy():
    assert lt.eps_for(torch.float32) == lj.config.eps_for(jnp.float32)
    assert lt.eps_for("float64") == lj.config.eps_for(jnp.float64)
    assert lt.default_dtype() == torch.get_default_dtype()


def _coo(rng, m, n, nnz):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    return vals, rows, cols


@pytest.mark.parametrize("m,n", [(40, 25), (25, 40), (1, 9)])
def test_coo_products_match_jax(rng, m, n):
    vals, rows, cols = _coo(rng, m, n, 3 * max(m, n))
    Aj = lj.coo_operator(m, n, vals, rows, cols)
    At = lt.coo_operator(m, n, vals, rows, cols, device=DEV)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    assert rel_err(At.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) < 1e-14
    assert rel_err(At.rmatvec(torch.from_numpy(y)), Aj.rmatvec(jnp.asarray(y))) < 1e-14
    np.testing.assert_allclose(to_np(At.todense()), np.asarray(Aj.todense()),
                               rtol=1e-14, atol=1e-14)
    assert At.nnz == Aj.nnz and At.dtype == torch.float64


def test_dense_callback_and_transpose_match_jax(rng):
    a = rng.standard_normal((30, 20))
    x, y = rng.standard_normal(20), rng.standard_normal(30)
    Dj = lj.DenseOperator(jnp.asarray(a))
    Dt = lt.as_operator(a, device=DEV)
    assert isinstance(Dt, lt.DenseOperator) and Dt.shape == (30, 20)
    assert rel_err(Dt.matvec(torch.from_numpy(x)), Dj.matvec(jnp.asarray(x))) < 1e-14
    assert rel_err(Dt.rmatvec(torch.from_numpy(y)), Dj.rmatvec(jnp.asarray(y))) < 1e-14
    at = torch.from_numpy(a)
    Ct = lt.as_operator((lambda v: at @ v, lambda w: at.T @ w), m=30, n=20)
    assert isinstance(Ct, lt.CallbackOperator) and Ct.dtype is None
    Ct = lt.CallbackOperator(30, 20, Ct.matvec, Ct.rmatvec, dtype=torch.float64)
    np.testing.assert_allclose(to_np(Ct.todense()), a, rtol=1e-15)
    Tt = Dt.T
    assert Tt.shape == (20, 30)
    assert rel_err(Tt.matvec(torch.from_numpy(y)), Dj.T.matvec(jnp.asarray(y))) < 1e-14
    assert rel_err(Tt.rmatvec(torch.from_numpy(x)), Dj.T.rmatvec(jnp.asarray(x))) < 1e-14


def test_as_operator_and_coo_validation_errors():
    with pytest.raises(TypeError):
        lt.as_operator(lambda v: v)
    with pytest.raises(ValueError):
        lt.as_operator((lambda v: v, lambda v: v))
    with pytest.raises(ValueError):
        lt.as_operator(np.zeros(3), device=DEV)
    with pytest.raises(ValueError):
        lt.coo_operator(3, 3, [1.0, 2.0], [0, 1, 2], [0, 1, 2], device=DEV)
    with pytest.raises(ValueError):
        lt.coo_operator(2, 3, [1.0], [2], [0], device=DEV)
    with pytest.raises(ValueError):
        lt.coo_operator(3, 2, [1.0], [0], [2], device=DEV)


def test_operator_from_arrays_round_trips_shared(rng):
    m, n, ks = 330, 200, (-60, -3, 0, 5)
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    Aj = lj.dia_shared_operator(m, n, ks, data)
    At = lt.operator_from_arrays(
        "dia_shared", {"dp": np.asarray(Aj.dp)},
        {"m": m, "n": n, "offsets": Aj.offsets, "H": Aj.H}, device=DEV)
    assert isinstance(At, lt.DIASharedOperator)
    assert to_np(At.dp).tobytes() == np.asarray(Aj.dp).tobytes()
    np.testing.assert_array_equal(to_np(At.todense()), np.asarray(Aj.todense()))
    np.testing.assert_array_equal(to_np(At.data), np.asarray(Aj.data))
    assert (At.nnz, At.Lp, At.dtype) == (Aj.nnz, Aj.Lp, torch.float32)
    with pytest.raises(ValueError, match="geometry"):
        lt.operator_from_arrays("dia_shared", {"dp": np.asarray(Aj.dp)[:-1]},
                                {"m": m, "n": n, "offsets": ks, "H": Aj.H}, device=DEV)
    with pytest.raises(ValueError, match="unknown"):
        lt.operator_from_arrays("wcoo", {}, {}, device=DEV)


def test_operator_from_arrays_bf16_stripes(rng):
    m, n, ks = 300, 300, (-2, 0, 1)
    data = rng.standard_normal((3, m)).astype(np.float32)
    Aj = lj.dia_shared_operator(m, n, ks, data, storage_dtype="bfloat16")
    At = lt.operator_from_arrays(
        "dia_shared", {"dp": np.asarray(Aj.dp)},
        {"m": m, "n": n, "offsets": Aj.offsets, "H": Aj.H}, device=DEV)
    assert At.is_bf16_storage and At.dtype == torch.float32
    x = rng.standard_normal(n).astype(np.float32)
    assert rel_err(At.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) < 1e-6


def test_operator_from_arrays_round_trips_coo(rng):
    vals, rows, cols = _coo(rng, 20, 15, 50)
    Aj = lj.coo_operator(20, 15, vals, rows, cols)
    At = lt.operator_from_arrays(
        "coo", {"vals": np.asarray(Aj.vals), "rows": np.asarray(Aj.rows),
                "cols": np.asarray(Aj.cols)}, {"m": 20, "n": 15}, device=DEV)
    np.testing.assert_allclose(to_np(At.todense()), np.asarray(Aj.todense()),
                               rtol=1e-15)


def test_result_to_numpy_reads_both_packages(rng):
    m, n, ks = 600, 500, (-3, 0, 2)
    data, _ = banded(rng, m, n, ks, np.float64, boost=6.0)
    b = rng.standard_normal(m)
    Aj = lj.dia_shared_operator(m, n, ks, data)
    kw = dict(wantse=True, atol=1e-6, btol=1e-6)
    rj = lt.result_to_numpy(lj.lsqr(Aj, b, **kw))
    rt = lt.result_to_numpy(lt.lsqr(shared_to_torch(Aj), b, **kw))
    assert set(rj) == set(rt) and rt["trace"] is None and rj["trace"] is None
    assert int(rj["itn"]) == int(rt["itn"]) and int(rj["istop"]) == int(rt["istop"])
    np.testing.assert_allclose(rt["x"], rj["x"], rtol=1e-8)
    np.testing.assert_allclose(rt["se"], rj["se"], rtol=1e-8)


def test_port_never_imports_jax():
    assert jax_imports_in() == []


def test_no_jax_scan_sees_imports(tmp_path):
    (tmp_path / "bad.py").write_text("import os\nfrom jax import numpy\n")
    (tmp_path / "ok.py").write_text("from .sibling import jax_like\n")
    assert jax_imports_in(tmp_path) == [("bad.py", 2)]
