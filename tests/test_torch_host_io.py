"""The port's host export (ops/host.py), Matrix Market and torch-sparse
input and scipy drop-ins (ops/interop.py) against the JAX package (the I/O
and scipy cases of tests/test_interop.py and the host-export cases of
tests/test_refine.py).

The same numpy triplets go to both packages (JAX on the CPU in x64, the
port on the CPU). Bounds: ``host_coo`` triplets equal to JAX's, value for
value, after sorting both by (row, col, value); products within 1e-10 of
the dense f64 ones; the scipy drop-ins with scipy's and JAX's istop and
itn and x within 1e-8 (the bounds of tests/test_interop.py), and the
norm estimates within its 1e-8 / 1e-6 / 1e-3.
"""

import gzip
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse
import scipy.sparse.linalg
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops.host import host_coo as host_coo_j
from lsqr_tpu.ops.host import host_products as host_products_j
from lsqr_tpu.ops.jdia import jdia_operator as jdia_operator_j
from lsqr_tpu.ops.precondition import ColumnScaledOperator as ColumnScaledJ
from lsqr_tpu.ops.precondition import ComposedOperator as ComposedJ

from _torch_parity import DEV, to_np


def _sparse(rng, m, n, nnz, dtype=np.float32):
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    return rng.standard_normal(nnz).astype(dtype), rows, cols


def _sorted(trip):
    r, c, v = (np.asarray(a) for a in trip)
    order = np.lexsort((v, c, r))
    return r[order], c[order], v[order]


def _same_triplets(At, Aj):
    got, ref = _sorted(lt.host_coo(At)), _sorted(host_coo_j(Aj))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def _operators(rng):
    """{name: (port operator, JAX operator)} over the same stored values."""
    m = n = 96
    offs = (-3, -1, 0, 2, 5)
    data = rng.standard_normal((len(offs), m)).astype(np.float32)
    vals, rows, cols = _sparse(rng, m, n, 400)
    flat = rng.choice(m * n, 300, replace=False)
    uv, ur, uc = rng.standard_normal(300).astype(np.float32), flat // n, flat % n
    dense = rng.standard_normal((14, 10)).astype(np.float32)
    d = rng.standard_normal(10).astype(np.float32)
    Dt, Dj = lt.as_operator(torch.tensor(dense)), lj.as_operator(jnp.asarray(dense))
    return {
        "coo": (lt.coo_operator(m, n, vals, rows, cols, device=DEV),
                lj.coo_operator(m, n, vals, rows, cols)),
        "dense": (Dt, Dj),
        "dia": (lt.dia_operator(m, n, offs, data, device=DEV),
                lj.dia_operator(m, n, offs, data)),
        "dia_shared": (lt.dia_shared_operator(m, n, offs, data, device=DEV),
                       lj.dia_shared_operator(m, n, offs, data)),
        "ell": (lt.ell_operator(m, n, uv, ur, uc, device=DEV),
                lj.ell_operator(m, n, uv, ur, uc)),
        "block_ell": (lt.block_ell_operator(m, n, vals, rows, cols, block=(8, 8), device=DEV),
                      lj.block_ell_operator(m, n, vals, rows, cols, block=(8, 8))),
        "jdia": (lt.jdia_operator(m, n, uv, ur, uc, device=DEV),
                 jdia_operator_j(m, n, uv, ur, uc)),
        "transposed": (Dt.T, Dj.T),
        "vstack": (lt.vstack_operators([Dt, Dt]), lj.vstack_operators([Dj, Dj])),
        "hstack": (lt.hstack_operators([Dt, Dt]), lj.hstack_operators([Dj, Dj])),
        "diagonal": (lt.diagonal_operator(d, device=DEV), lj.diagonal_operator(d)),
        "scaled": (lt.scale_operator(Dt, 2.5), lj.scale_operator(Dj, 2.5)),
        "column_scaled": (lt.ColumnScaledOperator(op=Dt, scale=torch.tensor(d)),
                          ColumnScaledJ(op=Dj, scale=jnp.asarray(d))),
        "composed": (lt.ComposedOperator(outer=Dt, inner=lt.diagonal_operator(d, device=DEV)),
                     ComposedJ(outer=Dj, inner=lj.diagonal_operator(d))),
    }


@pytest.mark.parametrize("name", ["coo", "dense", "dia", "dia_shared", "ell", "block_ell",
                                  "jdia", "transposed", "vstack", "hstack", "diagonal",
                                  "scaled", "column_scaled", "composed"])
def test_host_coo_matches_jax(rng, name):
    """The same triplets, in f64, as JAX's export of the same operator; the
    CSR is the operator's stored matrix (its products in f64)."""
    At, Aj = _operators(rng)[name]
    _same_triplets(At, Aj)
    mat = lt.to_scipy(At)
    assert isinstance(mat, scipy.sparse.csr_matrix) and mat.dtype == np.float64
    x = rng.standard_normal(At.n)
    ref = to_np(At.matvec(torch.tensor(x, dtype=At.dtype))).astype(np.float64)
    np.testing.assert_allclose(mat @ x, ref, rtol=1e-5, atol=1e-5)


def test_host_products_match_f64_oracle_and_jax(rng):
    m, n = 40, 28
    vals, rows, cols = _sparse(rng, m, n, 200)
    At = lt.coo_operator(m, n, vals, rows, cols, device=DEV)
    dense = lt.to_scipy(At).toarray()
    mv, rmv = lt.host_products(At)
    mvj, rmvj = host_products_j(lj.coo_operator(m, n, vals, rows, cols))
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    np.testing.assert_allclose(mv(x), dense @ x, rtol=1e-13)
    np.testing.assert_allclose(rmv(y), dense.T @ y, rtol=1e-13)
    np.testing.assert_array_equal(mv(x), mvj(x))
    np.testing.assert_array_equal(rmv(y), rmvj(y))
    # complex: the adjoint conjugates
    zc = (rng.standard_normal((6, 5)) + 1j * rng.standard_normal((6, 5)))
    _, rmvc = lt.host_products(lt.as_operator(torch.tensor(zc)), dtype=np.complex128)
    yc = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    np.testing.assert_allclose(rmvc(yc), zc.conj().T @ yc, rtol=1e-13)


def test_host_coo_dense_limit_guard_and_roundtrip(rng):
    A = lt.CallbackOperator(10, 8, lambda x: torch.zeros(10), lambda y: torch.zeros(8))
    with pytest.raises(NotImplementedError):
        lt.host_coo(A, dense_limit=4)
    m, n = 31, 19
    vals, rows, cols = _sparse(rng, m, n, 150, np.float64)
    mat = scipy.sparse.csr_matrix(scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n)))
    back = lt.to_scipy(lt.from_scipy(mat, device=DEV))
    assert abs(back - mat).max() == 0.0


@pytest.mark.parametrize("gz", [False, True], ids=["mtx", "mtx.gz"])
def test_from_matrix_market_matches_jax(tmp_path, rng, gz):
    """Sparse, dense and complex .mtx (and .mtx.gz) files: the operator
    JAX builds from the same file, the same products, and the solve."""
    m, n, nnz = 40, 25, 150
    v, r, c = _sparse(rng, m, n, nnz, np.float64)
    S = scipy.sparse.coo_matrix((v, (r, c)), shape=(m, n))
    S.sum_duplicates()
    D = rng.standard_normal((6, 4))
    Dc = D + 2j * rng.standard_normal((6, 4))
    paths = {}
    for name, mat in (("sparse", S), ("dense", D), ("complex", Dc)):
        p = tmp_path / f"{name}.mtx"
        scipy.io.mmwrite(str(p), mat)
        if gz:
            with open(p, "rb") as src, gzip.open(f"{p}.gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
            p = tmp_path / f"{name}.mtx.gz"
        paths[name] = p

    A = lt.from_matrix_market(paths["sparse"], dtype="float64", device=DEV)
    Aj = lj.from_matrix_market(paths["sparse"], dtype=jnp.float64)
    assert type(A).__name__ == type(Aj).__name__
    x = rng.standard_normal(n)
    np.testing.assert_allclose(to_np(A.matvec(torch.tensor(x))), S @ x, rtol=1e-10)
    b = rng.standard_normal(m)
    res = lt.lsqr(A, b, atol=1e-10, btol=1e-10)
    ref = scipy.sparse.linalg.lsqr(S.tocsr(), b, atol=1e-10, btol=1e-10)
    np.testing.assert_allclose(to_np(res.x), ref[0], atol=1e-7)

    Ad = lt.from_matrix_market(paths["dense"], dtype=torch.float64, device=DEV)
    assert isinstance(Ad, lt.DenseOperator)
    np.testing.assert_allclose(to_np(Ad.matvec(torch.ones(4, dtype=torch.float64))),
                               D @ np.ones(4), rtol=1e-12)
    Ac = lt.from_matrix_market(paths["complex"], device=DEV)
    Acj = lj.from_matrix_market(paths["complex"])
    assert Ac.dtype == torch.complex128 and type(Ac).__name__ == type(Acj).__name__
    y = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    np.testing.assert_allclose(to_np(Ac.rmatvec(torch.tensor(y))), Dc.conj().T @ y,
                               rtol=1e-10)


def _bcoo_pair(rng, m=60, n=40, nnz=300, layout="coo"):
    from jax.experimental import sparse as jsparse

    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    mat_j = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(np.stack([rows, cols], 1))),
                         shape=(m, n))
    mat_t = torch.sparse_coo_tensor(np.stack([rows, cols]), vals, (m, n))
    if layout == "csr":
        mat_j = jsparse.BCSR.from_bcoo(mat_j.sum_duplicates().sort_indices())
        mat_t = mat_t.coalesce().to_sparse_csr()
    return mat_t, mat_j, dense


@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("fmt", [None, "coo", "ell", "block"])
def test_from_torch_sparse_routes_as_from_bcoo(rng, layout, fmt):
    """A torch sparse COO or CSR tensor (duplicates summed) lands on the
    operator ``from_bcoo`` builds from the same triplets, with its
    products."""
    mat_t, mat_j, dense = _bcoo_pair(rng, layout=layout)
    A = lt.from_torch_sparse(mat_t, format=fmt)
    Aj = lj.from_bcoo(mat_j, format=fmt)
    assert type(A).__name__ == type(Aj).__name__
    x, y = rng.standard_normal(dense.shape[1]), rng.standard_normal(dense.shape[0])
    np.testing.assert_allclose(to_np(A.matvec(torch.tensor(x))), dense @ x, rtol=1e-10)
    np.testing.assert_allclose(to_np(A.rmatvec(torch.tensor(y))), dense.T @ y, rtol=1e-10)
    assert lt.from_bcoo is lt.from_torch_sparse


def test_from_torch_sparse_refusals(rng):
    with pytest.raises(TypeError, match="sparse COO or CSR"):
        lt.from_torch_sparse(torch.eye(3))
    hybrid = torch.sparse_coo_tensor(np.array([[0, 1]]), torch.ones(2, 3), (2, 3))
    with pytest.raises(ValueError, match="without dense dimensions"):
        lt.from_torch_sparse(hybrid)
    cplx = torch.sparse_coo_tensor(np.array([[0, 1], [1, 0]]),
                                   torch.tensor([1 + 1j, 2 - 1j]), (2, 2))
    with pytest.raises(ValueError, match="real-only"):
        lt.from_torch_sparse(cplx, format="ell")
    one = torch.sparse_coo_tensor(np.array([[0], [0]]), torch.ones(1), (1, 1))
    with pytest.raises(ValueError, match="unknown format"):
        lt.from_torch_sparse(one, format="bsr")


@pytest.mark.parametrize("damp", [0.1, 0.0])
def test_lsqr_scipy_matches_scipy_and_jax(rng, damp):
    """scipy.sparse.linalg.lsqr's 10-tuple with calc_var, damped and not."""
    m, n, nnz = 400, 150, 3000
    v, r, c = _sparse(rng, m, n, nnz, np.float64)
    S = scipy.sparse.coo_matrix((v, (r, c)), shape=(m, n))
    b = rng.standard_normal(m)
    kw = dict(damp=damp, atol=1e-9, btol=1e-9, calc_var=True)
    ours = lt.lsqr_scipy(S, b, device=DEV, **kw)
    ref = scipy.sparse.linalg.lsqr(S, b, **kw)
    jax_t = lj.lsqr_scipy(S, b, **kw)
    assert len(ours) == 10
    x, istop, itn, r1, r2, anorm, acond, arnorm, xnorm, var = ours
    assert istop == ref[1] == jax_t[1] and itn == ref[2] == jax_t[2]
    np.testing.assert_allclose(x, ref[0], atol=1e-8)
    np.testing.assert_allclose(x, jax_t[0], atol=1e-10)
    np.testing.assert_allclose(r1, ref[3], rtol=1e-8)
    np.testing.assert_allclose(r2, ref[4], rtol=1e-8)
    np.testing.assert_allclose(anorm, ref[5], rtol=1e-6)
    np.testing.assert_allclose(acond, ref[6], rtol=1e-3)
    np.testing.assert_allclose(arnorm, ref[7], rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(xnorm, ref[8], rtol=1e-8)
    np.testing.assert_allclose(var, ref[9], rtol=1e-3, atol=1e-12)
    # var sums (w/rho)^2 over every iteration, past the loss of
    # orthogonality: JAX's differs from the port's as scipy's does
    np.testing.assert_allclose(var, jax_t[9], rtol=1e-3, atol=1e-12)


def test_lsmr_scipy_matches_scipy_and_jax(rng):
    m, n = 120, 60
    S = scipy.sparse.csr_matrix(rng.standard_normal((m, n)))
    b = rng.standard_normal(m)
    kw = dict(damp=0.1, atol=1e-9, btol=1e-9)
    ours = lt.lsmr_scipy(S, b, device=DEV, **kw)
    ref = scipy.sparse.linalg.lsmr(S, b, **kw)
    jax_t = lj.lsmr_scipy(S, b, **kw)
    assert len(ours) == len(ref) == 8
    assert ours[1] == ref[1] == jax_t[1] and ours[2] == ref[2] == jax_t[2]
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-8)
    np.testing.assert_allclose(ours[0], jax_t[0], atol=1e-10)
    for i in (3, 4, 5, 7):
        np.testing.assert_allclose(ours[i], ref[i], rtol=1e-3)
    np.testing.assert_allclose(ours[6], ref[6], rtol=1e-2)
