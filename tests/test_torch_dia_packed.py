"""The packed DIA layer of the PyTorch port against the JAX package: stripe
bytes, the four packed kernels' plain twins against the Pallas kernels
(interpret mode) and the XLA oracles, the bf16 twins of the shared kernels,
the operator in solves, ``auto_operator``/``from_scipy`` routing, the
synthetic generators, conversion and CPU dispatch. The kernels themselves
are held against the twins in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.models import synthetic as jsyn
from lsqr_tpu.ops import pallas_spmv as jspmv
from lsqr_tpu.ops.structured import _dia_matvec_xla, dia_operator_device, dia_pair_xla
from lsqr_tpu_torch.ops import spmv

from _torch_parity import DEV, banded, banded_triplets, rel_err, to_np

# tests/test_pair.py shapes of the pair kernel (tm = 1024): aligned, ragged,
# over- and under-determined, offsets wider than the tile, one tile, lo > tm
PAIR_CASES = [
    (4096, 4096, (-2, -1, 0, 1, 2)),
    (5000, 5000, (-3, 0, 5)),
    (3000, 2000, (-5, -1, 0, 2)),
    (2000, 3000, (0, 1, 900)),
    (2048, 2048, (-1500, 0, 1500)),
    (1024, 1024, (0,)),
    (5000, 4000, (-4000, -1, 0)),
]
PAIR_IDS = [f"{m}x{n}_{min(ks)}_{max(ks)}" for m, n, ks in PAIR_CASES]
# tests/test_pallas.py shapes of dia_matvec
MATVEC_CASES = [
    (300, 280, (-5, -1, 0, 2, 7)),
    (280, 300, (-3, 0, 3)),
    (256, 256, (0,)),
    (2100, 2100, (-17, -2, 0, 1, 29)),
]
# tests/test_fused.py shapes of the half-step kernels
FUSED_SHAPES = [(2100, 1900), (1024, 1024), (300, 400), (400, 300)]
FUSED_OFFSETS = (-5, -1, 0, 2, 7)
TOL = 5e-6  # f32, relative to the max: the two sides differ in rounding only


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    """The raw bytes of a port tensor or JAX array (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return to_np(a).tobytes()
    return np.asarray(a).tobytes()


def _packed(rng, m, n, ks, dtype=np.float32, **kw):
    data = rng.standard_normal((len(ks), m)).astype(dtype)
    return (data, lj.dia_operator(m, n, ks, data, **kw),
            lt.dia_operator(m, n, ks, data, **kw, device=DEV))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", PAIR_CASES, ids=PAIR_IDS)
def test_packed_stripes_byte_equal_to_jax(rng, m, n, ks, storage):
    dtype = np.float64 if storage == "float64" else np.float32
    sd = "bfloat16" if storage == "bfloat16" else None
    data = rng.standard_normal((len(ks), m)).astype(dtype)
    for Aj, At in (
        (lj.dia_operator(m, n, ks, data, storage_dtype=sd),
         lt.dia_operator(m, n, ks, data, storage_dtype=sd, device=DEV)),
        (dia_operator_device(m, n, ks, jnp.asarray(data), storage_dtype=sd),
         lt.dia_operator_device(m, n, ks, _t(data), storage_dtype=sd)),
    ):
        assert At.offsets == Aj.offsets and At.toffsets == Aj.toffsets
        assert At.is_bf16_storage == (sd is not None) and At.nnz == Aj.nnz
        assert str(At.dtype).split(".")[-1] == np.dtype(Aj.dtype).name
        assert _bits(At.data) == _bits(Aj.data)
        assert _bits(At.tdata) == _bits(Aj.tdata)
    if m * n <= 4_200_000:
        np.testing.assert_array_equal(to_np(At.todense()), np.asarray(Aj.todense()))


# ---------------------------------------------------------------------------
# the four packed twins against the Pallas kernels (f32) and XLA (f64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,ks", PAIR_CASES, ids=PAIR_IDS)
def test_pair_twin_matches_pallas(rng, m, n, ks):
    data, dense = banded(rng, m, n, ks, np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    c1, c2 = 0.7, 1.3
    uj, zj = jspmv.dia_pair(jnp.asarray(data), jnp.asarray(y), jnp.asarray(v), c1, c2,
                            offsets=ks, m=m, n=n, interpret=True, tm=1024)
    # the solver's route: c1, c2 as 0-d tensors
    ut, zt = spmv.dia_pair_plain(_t(data), _t(y), _t(v), torch.tensor(c1),
                                 torch.tensor(c2), offsets=ks, m=m, n=n)
    assert ut.dtype == zt.dtype == torch.float32
    assert rel_err(ut, uj) < TOL and rel_err(zt, zj) < TOL
    u_ref = dense @ (v * np.float32(c1)) - np.float32(c2) * y
    assert rel_err(ut, u_ref) < TOL and rel_err(zt, dense.T @ u_ref) < TOL


def test_pair_twin_bf16_storage_matches_pallas(rng):
    # tests/test_pair.py::test_dia_pair_bf16_storage
    m = n = 2048
    ks = (-1, 0, 3)
    data, _ = banded(rng, m, n, ks, np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    d16 = jnp.asarray(data).astype(jnp.bfloat16)
    uj, zj = jspmv.dia_pair(d16, jnp.asarray(y), jnp.asarray(v), 1.0, 0.5,
                            offsets=ks, m=m, n=n, interpret=True, tm=1024)
    t16 = _t(data).to(torch.bfloat16)
    assert _bits(t16) == _bits(d16)
    ut, zt = spmv.dia_pair_plain(t16, _t(y), _t(v), 1.0, 0.5, offsets=ks, m=m, n=n)
    assert ut.dtype == zt.dtype == torch.float32
    assert rel_err(ut, uj) < TOL and rel_err(zt, zj) < TOL


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
@pytest.mark.parametrize("m,n,ks", MATVEC_CASES)
def test_matvec_twin_matches_pallas(rng, m, n, ks, direction):
    data, Aj, At = _packed(rng, m, n, ks)
    dense = to_np(At.todense())
    if direction == "forward":
        stripes_j, stripes_t, offs, dims, vec = Aj.data, At.data, ks, (m, n), \
            rng.standard_normal(n).astype(np.float32)
        ref_dense = dense @ vec
    else:  # the adjoint on the transpose stripes, as the operator runs it
        stripes_j, stripes_t, offs, dims, vec = Aj.tdata, At.tdata, Aj.toffsets, (n, m), \
            rng.standard_normal(m).astype(np.float32)
        ref_dense = dense.T @ vec
        # the column side of data (the pair's wide-halo route) gives the same
        col = spmv.dia_matvec_plain(At.data, _t(vec), offsets=ks, m=m, n=n, adjoint=True)
        assert rel_err(col, ref_dense) < TOL
    got = spmv.dia_matvec_plain(stripes_t, _t(vec), offsets=offs, m=dims[0], n=dims[1])
    ref = jspmv.dia_matvec(stripes_j, jnp.asarray(vec), offsets=offs, m=dims[0],
                           n=dims[1], interpret=True)
    assert got.dtype == torch.float32 and got.shape == (dims[0],)
    assert rel_err(got, ref) < TOL and rel_err(got, ref_dense) < TOL


@pytest.mark.parametrize("kernel", ["axpy", "fused"])
@pytest.mark.parametrize("m,n", FUSED_SHAPES)
def test_axpy_and_fused_twins_match_pallas(rng, m, n, kernel):
    data, Aj, At = _packed(rng, m, n, FUSED_OFFSETS)
    y = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    c1, c2 = 0.37, 1.21
    kw = dict(offsets=FUSED_OFFSETS, m=m, n=n)
    if kernel == "axpy":
        ref = jspmv.dia_matvec_axpy(Aj.data, jnp.asarray(y), jnp.asarray(v), c1, c2,
                                    interpret=True, **kw)
        got = spmv.dia_matvec_axpy_plain(At.data, _t(y), _t(v), c1, c2, **kw)
        assert rel_err(got, ref) < TOL
        return
    ref, ssq_ref = jspmv.dia_fused_halfstep(Aj.data, jnp.asarray(y), jnp.asarray(v), c1,
                                            c2, interpret=True, **kw)
    got, ssq = spmv.dia_fused_halfstep_plain(At.data, _t(y), _t(v), torch.tensor(c1),
                                             torch.tensor(c2), **kw)
    assert got.dtype == ssq.dtype == torch.float32 and ssq.shape == ()
    assert rel_err(got, ref) < TOL
    np.testing.assert_allclose(float(ssq), float(ssq_ref), rtol=1e-5)


@pytest.mark.parametrize("m,n,ks", [(3000, 3000, (-2, 0, 3)), (2500, 3100, (-7, -1, 0, 2, 9)),
                                    (3100, 2500, (-3, 0, 1)), (2048, 2048, (0,))])
def test_f64_twins_match_xla(rng, m, n, ks):
    data, Aj, At = _packed(rng, m, n, ks, np.float64)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    kw = dict(offsets=ks, m=m, n=n)
    got = spmv.dia_matvec_plain(At.data, _t(x), **kw)
    assert got.dtype == torch.float64
    assert rel_err(got, _dia_matvec_xla(Aj.data, jnp.asarray(x), ks, m, n)) < 1e-13
    got = spmv.dia_matvec_plain(At.tdata, _t(y), offsets=At.toffsets, m=n, n=m)
    assert rel_err(got, _dia_matvec_xla(Aj.tdata, jnp.asarray(y), Aj.toffsets, n, m)) < 1e-13
    uj, zj = dia_pair_xla(Aj.data, jnp.asarray(y), jnp.asarray(x), 0.7, 1.3, **kw)
    ut, zt = spmv.dia_pair_plain(At.data, _t(y), _t(x), torch.tensor(0.7, dtype=torch.float64),
                                 1.3, **kw)
    assert rel_err(ut, uj) < 1e-13 and rel_err(zt, zj) < 1e-13


# ---------------------------------------------------------------------------
# bf16 stripes in the shared kernels' twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["product", "axpy", "pair"])
def test_shared_bf16_twins_match_pallas(rng, kernel):
    m, n, ks = 500, 300, (-4, 0, 3)
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    Aj = lj.dia_shared_operator(m, n, ks, data, storage_dtype="bfloat16")
    At = lt.dia_shared_operator(m, n, ks, data, storage_dtype=torch.bfloat16, device=DEV)
    assert _bits(At.dp) == _bits(Aj.dp)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    kw = dict(offsets=ks, m=m, n=n)
    if kernel == "pair":
        refs = jspmv.dia_pair_shared(Aj.dp, jnp.asarray(v), jnp.asarray(y), 0.8, 1.1,
                                     interpret=True, **kw)
        gots = spmv.dia_pair_shared_plain(At.dp, _t(v), _t(y), 0.8, 1.1, **kw)
    else:
        refs, gots = [], []
        for adjoint, vec, out in ((False, v, y), (True, y, v)):
            if kernel == "product":
                refs.append(jspmv.dia_product_shared(Aj.dp, jnp.asarray(vec), adjoint=adjoint,
                                                     interpret=True, **kw))
                gots.append(spmv.dia_product_shared_plain(At.dp, _t(vec), adjoint=adjoint,
                                                          **kw))
            else:
                refs.append(jspmv.dia_product_shared_axpy(
                    Aj.dp, jnp.asarray(vec), jnp.asarray(out), 0.7, 1.3, adjoint=adjoint,
                    interpret=True, **kw))
                gots.append(spmv.dia_product_shared_axpy_plain(
                    At.dp, _t(vec), _t(out), 0.7, 1.3, adjoint=adjoint, **kw))
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
        assert rel_err(got, ref) < TOL


# ---------------------------------------------------------------------------
# the operator in solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pair", "fused"])
@pytest.mark.parametrize("problem", ["square", "rect_damped_wantse", "underdetermined"])
def test_forced_modes_on_packed_f32_match_jax(rng, problem, mode):
    # tests/test_pair.py::test_pair_solver_*
    m, n, ks, damp, extra = {
        "square": (3000, 3000, (-2, -1, 0, 1, 3), 0.01, {}),
        "rect_damped_wantse": (2500, 1500, (-1, 0, 2), 0.1, dict(wantse=True)),
        "underdetermined": (1500, 2400, (-1, 0, 2), 0.0, {}),
    }[problem]
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    data[ks.index(0)] += 6.0
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-6, btol=1e-6, **extra)
    kw.update(pair=True) if mode == "pair" else kw.update(fused=True, pair=False)
    rj = lj.lsqr(lj.dia_operator(m, n, ks, data), b, damp, **kw)
    rt = lt.lsqr(lt.dia_operator(m, n, ks, data, device=DEV), b, damp, **kw)
    assert rt.x.dtype == torch.float32
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= 2
    assert rel_err(rt.x, rj.x) < 1e-4
    if extra:
        np.testing.assert_allclose(to_np(rt.se), np.asarray(rj.se), rtol=5e-2, atol=1e-5)


@pytest.mark.parametrize("damp", [0.0, 0.3])
def test_f64_banded_through_auto_operator_matches_jax(rng, damp):
    m, n, ks = 1500, 1200, (-3, -1, 0, 2, 5)
    data, _ = banded(rng, m, n, ks, np.float64, boost=6.0)
    vals, rows, cols = banded_triplets(data, ks, n)
    b = rng.standard_normal(m)
    Aj = lj.auto_operator(m, n, vals, rows, cols)
    At = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert isinstance(At, lt.DIAOperator) and type(Aj).__name__ == "DIAOperator"
    kw = dict(atol=1e-10, btol=1e-10, wantse=True)
    rj, rt = lj.lsqr(Aj, b, damp, **kw), lt.lsqr(At, b, damp, **kw)
    assert rt.x.dtype == torch.float64 and int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= 1
    assert rel_err(rt.x, rj.x) < 1e-10
    # se sums dk**2 over every iteration; past itn ~30 the dk are at rounding
    # level and the two summation orders part by up to ~1e-6 relative
    np.testing.assert_allclose(to_np(rt.se), np.asarray(rj.se), rtol=1e-5)
    np.testing.assert_allclose(float(rt.rnorm), float(rj.rnorm), rtol=1e-8)


def test_f64_forced_modes_stay_exact(rng):
    m, n, ks = 600, 500, (-1, 0, 2)
    data, dense = banded(rng, m, n, ks, np.float64)
    At = lt.dia_operator(m, n, ks, data, device=DEV)
    v, y = rng.standard_normal(n), rng.standard_normal(m)
    c1, c2 = torch.tensor(0.3, dtype=torch.float64), torch.tensor(1.7, dtype=torch.float64)
    u_ref = dense @ (v * 0.3) - 1.7 * y
    u, z = At.fused_pair(y=_t(y), win=_t(v), c1=c1, c2=c2)
    assert u.dtype == torch.float64
    assert rel_err(u, u_ref) < 1e-14 and rel_err(z, dense.T @ u_ref) < 1e-14
    out, ssq = At.fused_halfstep(forward=False, y=_t(v), win=_t(u_ref), c1=c1, c2=c2)
    ref = dense.T @ (u_ref * 0.3) - 1.7 * v
    assert rel_err(out, ref) < 1e-14
    np.testing.assert_allclose(float(ssq), float(ref @ ref), rtol=1e-13)


def test_bf16_packed_solve_matches_jax():
    # tests/test_bf16_solve.py::test_bf16_dia_solve_well_conditioned
    rng = np.random.default_rng(5)
    m = 4096
    ks = (-2, -1, 0, 1, 2)
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    data[2] += 10.0
    x_true = rng.standard_normal(m).astype(np.float32)
    b = np.asarray(lj.dia_operator(m, m, ks, data).matvec(jnp.asarray(x_true)))
    Aj = lj.dia_operator(m, m, ks, data, storage_dtype="bfloat16")
    At = lt.dia_operator(m, m, ks, data, storage_dtype=torch.bfloat16, device=DEV)
    assert At.is_bf16_storage and At.dtype == torch.float32
    rj = lj.lsqr(Aj, b, atol=1e-6, btol=1e-6)
    rt = lt.lsqr(At, b, atol=1e-6, btol=1e-6)
    assert rt.x.dtype == torch.float32 and int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= max(3, int(0.2 * int(rj.itn)))
    assert np.abs(to_np(rt.x) - x_true).max() < 5e-2
    assert np.abs(np.asarray(rj.x) - x_true).max() < 5e-2


# ---------------------------------------------------------------------------
# from_scipy, the generators, conversion, dispatch
# ---------------------------------------------------------------------------


def _scipy_banded(rng, m=400, n=300, ks=(-3, 0, 2, 7)):
    data, dense = banded(rng, m, n, ks, np.float64)
    return scipy.sparse.csr_matrix(dense), dense


@pytest.mark.parametrize("fmt", [None, "dia", "coo"])
def test_from_scipy_matches_jax(rng, fmt):
    S, dense = _scipy_banded(rng)
    Aj = lj.from_scipy(S, format=fmt)
    At = lt.from_scipy(S, format=fmt, device=DEV)
    assert type(At).__name__ == type(Aj).__name__
    assert type(At).__name__ == {"coo": "COOOperator"}.get(fmt, "DIAOperator")
    x, y = rng.standard_normal(S.shape[1]), rng.standard_normal(S.shape[0])
    assert rel_err(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) < 1e-13
    assert rel_err(At.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y))) < 1e-13
    assert rel_err(At.matvec(_t(x)), dense @ x) < 1e-13


def test_from_scipy_unported_formats_raise(rng):
    S, _ = _scipy_banded(rng)
    # "ell" and "block" are ported since the general-sparsity slice; this
    # thin band is not blocky, which both packages refuse for "block"
    assert type(lt.from_scipy(S, format="ell", device=DEV)).__name__ == \
        type(lj.from_scipy(S, format="ell")).__name__ == "ELLOperator"
    for pkg, kw in ((lj, {}), (lt, dict(device=DEV))):
        with pytest.raises(ValueError, match="not blocky"):
            pkg.from_scipy(S, format="block", **kw)
    with pytest.raises(ValueError, match="unknown format"):
        lt.from_scipy(S, format="csr", device=DEV)
    with pytest.raises(TypeError):
        lt.from_scipy(S.toarray(), device=DEV)
    # complex "dia" is ported (item 12): the plane-split ZDIA operator of JAX
    Sc = S.astype(np.complex128) * (1 - 2j)
    Z = lt.from_scipy(Sc, format="dia", device=DEV)
    assert type(Z).__name__ == type(lj.from_scipy(Sc, format="dia")).__name__ == "ZDIAOperator"
    xc = rng.standard_normal(Sc.shape[1]) + 1j * rng.standard_normal(Sc.shape[1])
    np.testing.assert_allclose(Z.matvec(torch.from_numpy(xc)).numpy(), Sc @ xc, rtol=1e-12)


@pytest.mark.parametrize("gen", ["banded_dia", "banded_problem", "random_coo_problem",
                                 "block_banded_coo"])
def test_synthetic_generators_match_jax(gen):
    if gen == "banded_dia":
        Aj = jsyn.banded_dia(500, 400, (-2, 0, 3), seed=3)
        At = lt.banded_dia(500, 400, (-2, 0, 3), seed=3, device=DEV)
        assert _bits(At.data) == _bits(Aj.data) and _bits(At.tdata) == _bits(Aj.tdata)
    elif gen == "banded_problem":
        (Aj, bj, nj), (At, bt, nt) = (jsyn.banded_problem(600, 500, 2, seed=4),
                                      lt.banded_problem(600, 500, 2, seed=4, device=DEV))
        assert nt == nj and isinstance(At, lt.DIAOperator)
        assert _bits(At.data) == _bits(Aj.data) and _bits(bt) == _bits(bj)
    elif gen == "random_coo_problem":
        (Aj, bj), (At, bt) = (jsyn.random_coo_problem(80, 60, 300, seed=5),
                              lt.random_coo_problem(80, 60, 300, seed=5, device=DEV))
        assert _bits(At.vals) == _bits(Aj.vals) and _bits(bt) == _bits(bj)
        np.testing.assert_array_equal(to_np(At.rows), np.asarray(Aj.rows))
        np.testing.assert_array_equal(to_np(At.cols), np.asarray(Aj.cols))
    else:
        ref = jsyn.block_banded_coo(64, 64, 8, 1, seed=6)
        for got in (lt.block_banded_coo(64, 64, 8, 1, seed=6),
                    lt.block_banded_coo(64, 64, 8, 1, seed=6, device="cpu")):
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(to_np(a), b)


@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_operator_from_arrays_round_trips_packed(rng, storage):
    m, n, ks = 330, 200, (-60, -3, 0, 5)
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    Aj = lj.dia_operator(m, n, ks, data, storage_dtype=storage)
    At = lt.operator_from_arrays(
        "dia", {"data": np.asarray(Aj.data), "tdata": np.asarray(Aj.tdata)},
        {"m": m, "n": n, "offsets": Aj.offsets}, device=DEV)
    assert isinstance(At, lt.DIAOperator) and At.dtype == torch.float32
    assert At.is_bf16_storage == (storage is not None)
    assert _bits(At.data) == _bits(Aj.data) and _bits(At.tdata) == _bits(Aj.tdata)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    assert rel_err(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) < 1e-6
    assert rel_err(At.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y))) < 1e-6


def test_cpu_wrappers_run_twins_and_count_nothing(rng):
    m, n, ks = 300, 330, (-3, 0, 7)
    data, _, At = _packed(rng, m, n, ks)
    v, y = _t(rng.standard_normal(n).astype(np.float32)), _t(
        rng.standard_normal(m).astype(np.float32))
    kw = dict(offsets=ks, m=m, n=n)
    spmv.reset_launch_counts()
    pairs = [
        (spmv.dia_matvec(At.data, v, **kw), spmv.dia_matvec_plain(At.data, v, **kw)),
        (spmv.dia_matvec(At.data, y, adjoint=True, **kw),
         spmv.dia_matvec_plain(At.data, y, adjoint=True, **kw)),
        (spmv.dia_matvec_axpy(At.data, y, v, 0.5, 2.0, **kw),
         spmv.dia_matvec_axpy_plain(At.data, y, v, 0.5, 2.0, **kw)),
        *zip(spmv.dia_fused_halfstep(At.data, y, v, 0.5, 2.0, **kw),
             spmv.dia_fused_halfstep_plain(At.data, y, v, 0.5, 2.0, **kw)),
        *zip(spmv.dia_pair(At.data, y, v, 0.5, 2.0, **kw),
             spmv.dia_pair_plain(At.data, y, v, 0.5, 2.0, **kw)),
    ]
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for kw in (dict(pair=True), dict(fused=True, pair=False), dict(fused=False)):
        lt.lsqr(At, y, itnlim=3, **kw)
    assert not any(spmv.launch_counts(by_variant=True).values())
    assert not At.prefers_pair and not At.prefers_fused


def test_megakernel_on_packed_raises_naming_item_13(rng):
    # item 13 is ported: megakernel=True runs on the packed operator and
    # raises ValueError only where the configuration is unsupported
    data, _, At = _packed(rng, 100, 100, (-1, 0, 1))
    data[1] += 6.0
    At = lt.dia_operator(100, 100, (-1, 0, 1), data, device=DEV)
    b = np.ones(100, np.float32)
    res = lt.lsqr(At, b, megakernel=True, atol=1e-6, btol=1e-6)
    ref = lt.lsqr(At, b, atol=1e-6, btol=1e-6)
    assert int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 1
    with pytest.raises(ValueError, match="megakernel=True requires"):
        lt.lsqr(At, b, megakernel=True, record_trace=True)
    with pytest.raises(ValueError, match="megakernel=True requires"):
        lt.lsqr(lt.dia_shared_operator(100, 100, (-1, 0, 1), data, device=DEV), b, megakernel=True)


@pytest.mark.parametrize("m,n", FUSED_SHAPES)
def test_axpy_and_fused_twins_return_stripe_dtype_on_bf16(rng, m, n):
    """JAX's dia_matvec_axpy and dia_fused_halfstep return data.dtype: bf16
    results for bf16 stripes, the sum of squares in f32. JAX's kernels take
    bf16 stripes with a bf16 window vector, so v holds bf16 values on both
    sides (f32 in the port)."""
    data, Aj, At = _packed(rng, m, n, FUSED_OFFSETS, storage_dtype="bfloat16")
    y = rng.standard_normal(m).astype(np.float32)
    v16 = jnp.asarray(rng.standard_normal(n), jnp.bfloat16)
    v = _t(np.asarray(v16.astype(jnp.float32)))
    c1, c2 = 0.37, 1.21
    kw = dict(offsets=FUSED_OFFSETS, m=m, n=n)
    ref = jspmv.dia_matvec_axpy(Aj.data, jnp.asarray(y), v16, c1, c2, interpret=True, **kw)
    got = spmv.dia_matvec_axpy_plain(At.data, _t(y), v, c1, c2, **kw)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # both round an f32 sum to bf16: at most one bf16 ulp (2^-8) apart
    assert rel_err(got.float(), np.asarray(ref, np.float32)) < 1e-2
    got32 = spmv.dia_matvec_axpy(At.data, _t(y), v, c1, c2, out_dtype=torch.float32, **kw)
    assert got32.dtype == torch.float32 and rel_err(got.float(), got32) < 1e-2
    ref, ssq_ref = jspmv.dia_fused_halfstep(Aj.data, jnp.asarray(y), v16, c1, c2,
                                            interpret=True, **kw)
    got, ssq = spmv.dia_fused_halfstep_plain(At.data, _t(y), v, torch.tensor(c1),
                                             torch.tensor(c2), **kw)
    assert got.dtype == torch.bfloat16 and ssq.dtype == torch.float32 and ssq.shape == ()
    assert rel_err(got.float(), np.asarray(ref, np.float32)) < 1e-2
    # JAX sums bf16-rounded per-tile partials; the port the f32 squares
    np.testing.assert_allclose(float(ssq), float(ssq_ref), rtol=1e-2)
    np.testing.assert_allclose(float(ssq), float(got32 @ got32), rtol=1e-5)
