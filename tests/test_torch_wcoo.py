"""The port's WCOO path against the JAX package: the packing byte for byte
(native packer and numpy loop), the packer's refusals, the three product
twins against JAX's plain operator products and scipy,
``operator_from_arrays("wcoo")``, ``auto_operator``'s WCOO route and a solve.

Inputs come from numpy seeds and go through both packages. JAX runs on the
CPU in x64 with its operators' plain (``use_pallas=False``) products, which
is what it runs on a CPU; the port on the CPU through its twins.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import lsqr_tpu as lj
import lsqr_tpu.native as jnative
import lsqr_tpu_torch as lt
import lsqr_tpu_torch.native as tnative
from lsqr_tpu.ops.wcoo import WCOOPackError as JWCOOPackError
from lsqr_tpu.ops.wcoo import wcoo_operator as j_wcoo_operator
from lsqr_tpu.ops.wcoo import wcoo_pack as j_wcoo_pack
from lsqr_tpu_torch.models.synthetic import zipf_column_coo
from lsqr_tpu_torch.ops import spmv_wcoo
from lsqr_tpu_torch.ops.wcoo import WCOOPackError, WCOOPacked, wcoo_pack, wcoo_pack_arrays

from _torch_parity import DEV, rel_err, to_np


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def jax_arrays(packed):
    """(arrays, statics) of a JAX packing dataclass, as numpy and ints."""
    arrays, meta = {}, {}
    for f in dataclasses.fields(packed):
        value = getattr(packed, f.name)
        if f.metadata.get("static"):
            meta[f.name] = value
        else:
            arrays[f.name] = np.asarray(value)
    return arrays, meta


def assert_same_arrays(arrays, meta, jax_packed):
    """A packer's numpy arrays and statics equal JAX's packing, field for
    field (the TPU tables included)."""
    ref, ref_meta = jax_arrays(jax_packed)
    assert sorted(arrays) == sorted(ref)
    for name, got in arrays.items():
        assert got.dtype == ref[name].dtype and got.shape == ref[name].shape, name
        assert got.tobytes() == ref[name].tobytes(), name
    assert meta == ref_meta


def assert_same_packing(port, jax_packed, fields):
    arrays, meta = jax_arrays(jax_packed)
    for name in fields:
        got, ref = to_np(getattr(port, name)), arrays[name]
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert got.tobytes() == ref.tobytes(), name
    for name, value in meta.items():
        assert getattr(port, name) == value, name


def _uniform(rng, m, n, nnz):
    return (rng.standard_normal(nnz).astype(np.float32), rng.integers(0, m, nnz),
            rng.integers(0, n, nnz))


def _ragged(rng, m, n, nnz):
    """Zipf columns, duplicates, and rows the pattern leaves empty."""
    vals, rows, cols = zipf_column_coo(m, n, nnz, seed=int(rng.integers(1 << 30)))
    rows = np.where((rows > m // 3) & (rows < m // 3 + 300), rows - 300, rows)
    rows[-100:], cols[-100:] = rows[:100], cols[:100]
    return vals, rows, cols


def _long_rows(rng, m, n, nnz):
    """:func:`_ragged` with 40 rows of 150 more entries and 3 of 1500: rows
    longer than the card forward's 32-slot step and its 32-row warp."""
    vals, rows, cols = _ragged(rng, m, n, nnz)
    extra = np.concatenate([np.repeat(rng.choice(m, 40, replace=False), 150),
                            np.repeat(rng.choice(m, 3, replace=False), 1500)])
    return (np.concatenate([vals, rng.standard_normal(extra.size).astype(np.float32)]),
            np.concatenate([rows, extra]), np.concatenate([cols, rng.integers(0, n, extra.size)]))


PATTERNS = {
    "long_rows_40000x1000": lambda rng: (40000, 1000, *_long_rows(rng, 40000, 1000, 100000)),
    "uniform_20000x300": lambda rng: (20000, 300, *_uniform(rng, 20000, 300, 60000)),
    "zipf_16384x1024": lambda rng: (16384, 1024, *zipf_column_coo(16384, 1024, 50000, seed=3)),
    "ragged_40000x513": lambda rng: (40000, 513, *_ragged(rng, 40000, 513, 100000)),
    "one_chunk_empty_33000x77": lambda rng: (
        33000, 77, rng.standard_normal(30000).astype(np.float32),
        np.concatenate([rng.integers(0, 16384, 20000), rng.integers(32768, 33000, 10000)]),
        rng.integers(0, 77, 30000)),
}


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_wcoo_pack_matches_jax_byte_for_byte(rng, monkeypatch, impl, name):
    if impl == "numpy":
        monkeypatch.setattr(jnative, "_LIB", False)
        monkeypatch.setattr(tnative, "_LIB", False)
    m, n, vals, rows, cols = PATTERNS[name](rng)
    arrays, meta = wcoo_pack_arrays(m, n, vals, rows, cols)
    assert tnative.available() == (impl == "native")
    ref = j_wcoo_pack(m, n, vals, rows, cols)
    assert_same_arrays(arrays, meta, ref)
    assert_same_packing(wcoo_pack(m, n, vals, rows, cols, device=DEV), ref,
                        WCOOPacked.DEVICE_FIELDS)


def test_wcoo_pack_forced_shapes_match_jax(rng):
    m, n, vals, rows, cols = PATTERNS["uniform_20000x300"](rng)
    kw = dict(force_emax=52224, force_kb=3, force_ku=12)
    ref = j_wcoo_pack(m, n, vals, rows, cols, **kw)
    assert_same_arrays(*wcoo_pack_arrays(m, n, vals, rows, cols, **kw), ref)
    assert_same_packing(wcoo_pack(m, n, vals, rows, cols, device=DEV, **kw), ref,
                        WCOOPacked.DEVICE_FIELDS)
    with pytest.raises(WCOOPackError, match="forced 1024"):
        wcoo_pack(m, n, vals, rows, cols, force_emax=1024, device=DEV)


def _outcome(fn):
    try:
        fn()
    except (ValueError, JWCOOPackError) as exc:
        return type(exc).__name__, str(exc)
    return "packed", ""


def _sweep_case(seed):
    """JAX's random sweep (tests/test_wcoo.py), widened to the shapes that
    each refusal needs."""
    r = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:    # mostly-empty rows: a subtile spans too many rows
        m = 1 << 20
        rows = np.sort(r.choice(m, 2000, replace=False))
        return m, 100, np.ones(2000, np.float32), rows, r.integers(0, 100, 2000)
    if kind == 1:    # a dense chunk at a wide n: the VMEM guard
        m, n = 16384, int(r.choice([2048, 4096]))
        nnz = int(r.integers(90_000, 110_000))
        return m, n, r.standard_normal(nnz).astype(np.float32), r.integers(0, m, nnz), \
            r.integers(0, n, nnz)
    m = 16384 + int(r.integers(0, 2000))
    n = int(r.choice([64, 200, 512, 1024, 2048, 5000]))
    nnz = max(16, int(m * float(r.uniform(0.05, 8.0))))
    if kind == 2:
        cols = r.zipf(1.1 + r.random(), size=4 * nnz) - 1
        cols = cols[cols < n][:nnz]
        nnz = cols.size
    else:
        cols = r.integers(0, n, nnz)
    return m, n, r.standard_normal(nnz).astype(np.float32), r.integers(0, m, nnz), cols


@pytest.mark.parametrize("seeds", [range(0, 8), range(8, 16)])
def test_wcoo_refusals_match_jax(seeds):
    outcomes = set()
    for seed in seeds:
        m, n, vals, rows, cols = _sweep_case(seed)
        ref = _outcome(lambda: j_wcoo_pack(m, n, vals, rows, cols))
        got = _outcome(lambda: wcoo_pack(m, n, vals, rows, cols, device=DEV))
        assert got[1] == ref[1], (seed, got, ref)
        assert (got[0] == "packed") == (ref[0] == "packed"), seed
        outcomes.add(got[0])
    assert outcomes == {"packed", "WCOOPackError"}


def test_wcoo_builder_refusals_match_jax():
    cases = [
        (lambda mod: mod(20000, 8192, [1.0], [0], [0]), "n <= 4096"),
        (lambda mod: mod(20000, 100, np.zeros(0, np.float32), np.zeros(0, int),
                         np.zeros(0, int)), "empty"),
        (lambda mod: mod(20000, 100, [1.0], [0], [0], dtype=np.float64), "f32"),
        (lambda mod: mod(20000, 100, np.ones(1, np.complex64), [0], [0]), "real-only"),
    ]
    port = lambda *a, **kw: lt.wcoo_operator(*a, device=DEV, **kw)  # noqa: E731
    for build, match in cases:
        with pytest.raises(JWCOOPackError, match=match) as ref:
            build(j_wcoo_operator)
        with pytest.raises(WCOOPackError, match=match) as got:
            build(port)
        assert str(got.value) == str(ref.value)


def _scipy(m, n, vals, rows, cols):
    return scipy.sparse.coo_matrix((vals.astype(np.float64), (rows, cols)),
                                   shape=(m, n)).tocsr()


def assert_close(got, ref):
    """JAX's own WCOO tolerance: atol = 2e-4 of the largest entry."""
    got, ref = to_np(got).astype(np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("c1,c2", [(1.0, 0.0), (0.7, 0.3), (1.3, -1.0)])
def test_wcoo_twins_match_jax_and_scipy(rng, name, c1, c2):
    m, n, vals, rows, cols = PATTERNS[name](rng)
    A = lt.wcoo_operator(m, n, vals, rows, cols, device=DEV)
    Aj = j_wcoo_operator(m, n, vals, rows, cols)
    S = _scipy(m, n, vals, rows, cols)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    u_ref = c1 * (S @ x) - c2 * y
    u_jax = Aj.matvec(jnp.asarray(x)) * c1 - c2 * jnp.asarray(y)
    u = spmv_wcoo.wcoo_forward(A.packed, _t(x), c1, c2, _t(y))
    assert u.shape == (m,)
    assert_close(u, u_ref)
    assert_close(u, u_jax)
    z = spmv_wcoo.wcoo_adjoint(A.packed, _t(y))
    assert_close(z, S.T @ y)
    assert_close(z, Aj.rmatvec(jnp.asarray(y)))
    u2, z2 = spmv_wcoo.wcoo_pair(A.packed, _t(y), _t(x), torch.tensor(c1), torch.tensor(c2))
    uj, zj = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=c1, c2=c2)
    assert_close(u2, u_ref)
    assert_close(u2, uj)
    assert_close(z2, S.T @ u_ref)
    assert_close(z2, zj)


def test_wcoo_twins_take_short_vectors_as_padded(rng):
    """y and u shorter than m_pad read as zero-padded, as in JAX."""
    m, n, vals, rows, cols = PATTERNS["ragged_40000x513"](rng)
    A = lt.wcoo_operator(m, n, vals, rows, cols, device=DEV)
    x = _t(rng.standard_normal(n).astype(np.float32))
    y = _t(rng.standard_normal(m).astype(np.float32))
    assert A.packed.m_pad == 49152 > m
    yp = torch.cat([y, torch.zeros(A.packed.m_pad - m)])
    assert torch.equal(spmv_wcoo.wcoo_forward(A.packed, x, 0.5, 2.0, y),
                       spmv_wcoo.wcoo_forward(A.packed, x, 0.5, 2.0, yp))
    assert torch.equal(spmv_wcoo.wcoo_adjoint(A.packed, y),
                       spmv_wcoo.wcoo_adjoint(A.packed, yp))
    assert torch.equal(A.matvec(x), spmv_wcoo.wcoo_forward(A.packed, x, 1.0, 0.0, y[:0]))


def test_wcoo_operator_from_arrays_matches_jax(rng):
    m, n, vals, rows, cols = PATTERNS["zipf_16384x1024"](rng)
    Aj = j_wcoo_operator(m, n, vals, rows, cols)
    arrays, meta = jax_arrays(Aj.packed)
    for f in ("vals", "rows", "cols"):
        arrays[f"coo_{f}"] = np.asarray(getattr(Aj.coo, f))
    A = lt.operator_from_arrays("wcoo", arrays, meta, device=DEV)
    assert isinstance(A, lt.WCOOOperator) and A.nnz == len(vals)
    assert_same_packing(A.packed, Aj.packed, WCOOPacked.DEVICE_FIELDS)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    assert_close(A.matvec(_t(x)), Aj.matvec(jnp.asarray(x)))
    assert_close(A.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y)))
    assert rel_err(A.todense() @ _t(x), A.matvec(_t(x))) < 1e-5


def test_wcoo_operator_on_the_cpu(rng):
    m, n, vals, rows, cols = PATTERNS["uniform_20000x300"](rng)
    A = lt.wcoo_operator(m, n, vals, rows, cols, device=DEV)
    assert A.shape == (m, n) and A.dtype == torch.float32 and A.device == DEV
    assert not A.prefers_pair  # the kernels run only on the card
    assert A.packed.device == DEV and A.packed.device_bytes() == 4 * (
        4 * A.packed.nc * A.packed.eb * 1024 + A.packed.nc * spmv_wcoo.CR)


def test_auto_operator_routes_wcoo_like_jax(rng):
    """tests/test_wcoo.py's routing cases."""
    def zipf(m, n, nnz):
        cols = rng.zipf(1.1, size=4 * nnz) - 1
        cols = cols[cols < n][:nnz].astype(np.int64)
        return (rng.standard_normal(cols.size).astype(np.float32),
                rng.integers(0, m, cols.size), cols)

    cases = [(32768, 1000, *zipf(32768, 1000, 150000))]
    m2 = 1 << 20
    cases.append((m2, 100, np.ones(2000, np.float32),
                   np.sort(rng.choice(m2, 2000, replace=False)), rng.integers(0, 100, 2000)))
    cases.append((32768, 8192, *_uniform(rng, 32768, 8192, 100000)))
    got = [type(lt.auto_operator(*c, device=DEV)).__name__ for c in cases]
    ref = [type(lj.auto_operator(*c)).__name__ for c in cases]
    assert got == ref and got[0] == "WCOOOperator" and "WCOOOperator" not in got[1:]
    # f64 keeps JAX's non-WCOO route
    m, n, vals, rows, cols = cases[0]
    assert type(lt.auto_operator(m, n, vals.astype(np.float64), rows, cols, device=DEV)
                ).__name__ == type(lj.auto_operator(m, n, vals.astype(np.float64), rows,
                                                    cols)).__name__ != "WCOOOperator"


@pytest.mark.parametrize("damp", [0.5, 1.0])
def test_wcoo_lsqr_matches_jax(rng, damp):
    m, n, nnz = 20000, 300, 80000
    vals, rows, cols = zipf_column_coo(m, n, nnz, seed=7)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-6, btol=1e-6)
    rj = lj.lsqr(j_wcoo_operator(m, n, vals, rows, cols), jnp.asarray(b), damp, **kw)
    A = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert isinstance(A, lt.WCOOOperator)
    rt = lt.lsqr(A, _t(b), damp, **kw)
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= max(3, int(rj.itn) // 5)
    assert rel_err(rt.x, rj.x) < 1e-4
