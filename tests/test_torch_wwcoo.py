"""The port's WWCOO and RWCOO paths against the JAX package: the WWCOO
packing byte for byte, the derived index plane the adjoint kernel reads, the
packers' refusals, the product twins against JAX's plain operator products
and scipy, ``operator_from_arrays("wwcoo"/"rwcoo")``, ``auto_operator``'s
RWCOO route and fallthrough, and a damped solve.

Inputs come from numpy seeds and go through both packages. JAX runs on the
CPU in x64 with its operators' plain (``use_pallas=False``) products; the
port on the CPU through its twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops.rwcoo import rwcoo_operator as j_rwcoo_operator
from lsqr_tpu.ops.wcoo import WCOOPackError as JWCOOPackError
from lsqr_tpu.ops.wwcoo import WWCOOPackError as JWWCOOPackError
from lsqr_tpu.ops.wwcoo import wwcoo_operator as j_wwcoo_operator
from lsqr_tpu.ops.wwcoo import wwcoo_pack as j_wwcoo_pack
from lsqr_tpu_torch.models.synthetic import zipf_column_coo
from lsqr_tpu_torch.ops import spmv_wcoo
from lsqr_tpu_torch.ops.wcoo import WCOOPacked, wcoo_pack_arrays
from lsqr_tpu_torch.ops.wwcoo import (WWCOOPackError, WWCOOPacked, column_index, column_lists,
                                      wwcoo_pack, wwcoo_pack_arrays)

from _torch_parity import DEV, rel_err, to_np, wide_band_triplets
from test_torch_wcoo import (_scipy, assert_close, assert_same_arrays, assert_same_packing,
                             jax_arrays)

#: the device arrays JAX stores too (cidx, zptr and zsrc are the port's own)
WW_FIELDS = [f for f in WWCOOPacked.DEVICE_FIELDS if f not in WWCOOPacked.DERIVED]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _zipf(rng, m, n, nnz, a):
    cols = rng.zipf(a, size=6 * nnz) - 1
    cols = cols[cols < n][:nnz].astype(np.int64)
    return (rng.standard_normal(cols.size).astype(np.float32),
            rng.integers(0, m, cols.size), cols)


def _long_rows(rng, m, n, nnz):
    """Uniform entries with duplicates, a band of empty rows, 40 rows of 150
    more entries and 3 of 1500."""
    rows = rng.integers(0, m, nnz)
    rows = np.where((rows > m // 3) & (rows < m // 3 + 300), rows - 300, rows)
    rows = np.concatenate([rows, np.repeat(rng.choice(m, 40, replace=False), 150),
                           np.repeat(rng.choice(m, 3, replace=False), 1500)])
    cols = rng.integers(0, n, rows.size)
    return _with_duplicates((rng.standard_normal(rows.size).astype(np.float32), rows, cols))


def _with_duplicates(trip):
    vals, rows, cols = trip
    rows[-100:], cols[-100:] = rows[:100], cols[:100]
    return vals, rows, cols


PATTERNS = {  # tests/test_wwcoo.py's shapes
    "uniform_20000x20000": lambda rng: (20000, 20000, rng.standard_normal(60000).astype(
        np.float32), rng.integers(0, 20000, 60000), rng.integers(0, 20000, 60000)),
    "zipf_dups_20001x12345": lambda rng: (20001, 12345,
                                          *_with_duplicates(_zipf(rng, 20001, 12345, 50000,
                                                                  1.2))),
    "zipf_16384x9000": lambda rng: (16384, 9000, *_zipf(rng, 16384, 9000, 50000, 1.3)),
    # rows longer than the card forward's 32-slot step and its 32-row warp
    "long_rows_33000x20000": lambda rng: (33000, 20000, *_long_rows(rng, 33000, 20000,
                                                                    40000)),
}
RW_PATTERNS = {
    "zipf_40000x30000": lambda rng: (40000, 30000, *_zipf(rng, 40000, 30000, 120000, 1.1)),
    "ragged_40000x8193": lambda rng: (40000, 8193,
                                      *_with_duplicates(zipf_column_coo(40000, 8193, 100000,
                                                                        seed=9))),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_wwcoo_pack_matches_jax_byte_for_byte(rng, name):
    m, n, vals, rows, cols = PATTERNS[name](rng)
    ref = j_wwcoo_pack(m, n, vals, rows, cols)
    assert_same_arrays(*wwcoo_pack_arrays(m, n, vals, rows, cols), ref)
    assert_same_packing(wwcoo_pack(m, n, vals, rows, cols, device=DEV), ref, WW_FIELDS)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_wwcoo_index_plane_pairs_each_slot_with_its_column(rng, name):
    """cidx = colc | rowl << 18 in the column-sorted order: decoded through
    colmap, the column-sorted copy is the same matrix as the row-sorted one,
    and its rows are JAX's rowl."""
    m, n, vals, rows, cols = PATTERNS[name](rng)
    p = wwcoo_pack(m, n, vals, rows, cols, device=DEV)
    code = to_np(p.cidx).view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(code >> 18, np.asarray(j_wwcoo_pack(m, n, vals, rows,
                                                                      cols).rowl))
    colc = code & ((1 << 18) - 1)
    assert np.all(np.diff(colc.reshape(p.nc, p.eb, 1024), axis=-1) >= 0)
    absolute = np.take_along_axis(to_np(p.colmap), colc, axis=1)
    chunk = np.arange(p.nc)[:, None] * spmv_wcoo.CR
    decoded = scipy.sparse.coo_matrix(
        (to_np(p.vals).ravel().astype(np.float64),
         ((chunk + (code >> 18)).ravel(), absolute.ravel())), shape=(p.m_pad, n)).tocsr()
    S = _scipy(m, n, vals, rows, cols)
    assert abs(decoded[:m] - S).max() < 1e-6
    assert decoded[m:].count_nonzero() == 0


def _outcome(fn):
    try:
        fn()
    except (ValueError, JWCOOPackError, JWWCOOPackError) as exc:
        return str(exc)
    return "packed"


def _rw_case(seed):
    """tests/test_wwcoo.py's random router sweep, with near-uniform wide
    patterns (every third seed), which exceed the cold work-list caps."""
    r = np.random.default_rng(100 + seed)
    if seed % 3 == 0:
        m = 32768 + int(r.integers(0, 2000))
        nnz = int(m * float(r.uniform(2.5, 4.0)))
        return m, 65536, r.standard_normal(nnz).astype(np.float32), \
            r.integers(0, m, nnz), r.integers(0, 65536, nnz)
    m = 16384 + int(r.integers(0, 2000))
    n = int(r.choice([5000, 8192, 20000, 40000, 65536]))
    nnz = max(64, int(m * float(r.uniform(0.3, 4.0))))
    cols = r.zipf(1.05 + r.random(), size=6 * nnz) - 1
    cols = cols[cols < n][:nnz]
    nnz = cols.size
    return m, n, r.standard_normal(nnz).astype(np.float32), r.integers(0, m, nnz), cols


@pytest.mark.parametrize("seeds", [range(0, 6), range(6, 12)])
def test_rwcoo_refusals_match_jax(seeds):
    outcomes = set()
    for seed in seeds:
        m, n, vals, rows, cols = _rw_case(seed)
        ref = _outcome(lambda: j_rwcoo_operator(m, n, vals, rows, cols))
        got = _outcome(lambda: lt.rwcoo_operator(m, n, vals, rows, cols, device=DEV))
        assert got == ref, seed
        outcomes.add(got == "packed")
    assert outcomes == {True, False}


def test_wwcoo_builder_refusals_match_jax():
    cases = [
        lambda mod: mod(100, 300_000, np.ones(1, np.float32), [0], [0]),
        lambda mod: mod(100, 8192, np.array([], np.float32), [], []),
        lambda mod: mod(100, 8192, np.ones(2, np.complex64), [0, 1], [0, 1]),
        lambda mod: mod(100, 8192, np.ones(2, np.float32), [0, 1], [0, 1], dtype="float64"),
    ]
    for build in cases:
        with pytest.raises(JWWCOOPackError) as ref:
            build(j_wwcoo_operator)
        with pytest.raises(WWCOOPackError) as got:
            build(lambda *a, **kw: lt.wwcoo_operator(*a, device=DEV, **kw))
        assert str(got.value) == str(ref.value)
    for args, kw in (((20000, 4096, np.ones(2, np.float32), [0, 1], [0, 1]), {}),
                     ((20000, 8192, np.ones(2, np.complex64), [0, 1], [0, 1]), {})):
        with pytest.raises(JWWCOOPackError) as ref:
            j_rwcoo_operator(*args, **kw)
        with pytest.raises(WWCOOPackError) as got:
            lt.rwcoo_operator(*args, device=DEV, **kw)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("c1,c2", [(1.0, 0.0), (0.7, 0.3), (1.3, -1.0)])
def test_wwcoo_twins_match_jax_and_scipy(rng, name, c1, c2):
    m, n, vals, rows, cols = PATTERNS[name](rng)
    A = lt.wwcoo_operator(m, n, vals, rows, cols, device=DEV)
    Aj = j_wwcoo_operator(m, n, vals, rows, cols)
    S = _scipy(m, n, vals, rows, cols)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    u_ref = c1 * (S @ x) - c2 * y
    u = spmv_wcoo.wwcoo_forward(A.packed, _t(x), c1, c2, _t(y))
    assert_close(u, u_ref)
    assert_close(u, Aj.matvec(jnp.asarray(x)) * c1 - c2 * jnp.asarray(y))
    z = spmv_wcoo.wwcoo_adjoint(A.packed, _t(y))
    assert_close(z, S.T @ y)
    assert_close(z, Aj.rmatvec(jnp.asarray(y)))
    u2, z2 = spmv_wcoo.wwcoo_pair(A.packed, _t(y), _t(x), c1, c2)
    uj, zj = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=c1, c2=c2)
    assert_close(u2, uj)
    assert_close(z2, S.T @ u_ref)
    assert_close(z2, zj)


@pytest.mark.parametrize("name", sorted(RW_PATTERNS))
@pytest.mark.parametrize("c1,c2", [(1.0, 0.0), (1.3, 0.7), (0.9, -1.0)])
def test_rwcoo_products_match_jax_and_scipy(rng, name, c1, c2):
    m, n, vals, rows, cols = RW_PATTERNS[name](rng)
    A = lt.rwcoo_operator(m, n, vals, rows, cols, device=DEV)
    Aj = j_rwcoo_operator(m, n, vals, rows, cols)
    assert A.cold is not None and Aj.cold is not None
    np.testing.assert_array_equal(to_np(A.hotmap), np.asarray(Aj.hotmap))
    assert_same_packing(A.hot, Aj.hot, WCOOPacked.DEVICE_FIELDS)
    assert_same_packing(A.cold, Aj.cold, WW_FIELDS)
    # the routed triplets pack to JAX's whole hot and cold packings
    hotmap = to_np(A.hotmap)
    hot = np.isin(cols, hotmap)
    assert_same_arrays(*wcoo_pack_arrays(m, hotmap.size, vals[hot], rows[hot],
                                         np.searchsorted(hotmap, cols[hot])), Aj.hot)
    assert_same_arrays(*wwcoo_pack_arrays(m, n, vals[~hot], rows[~hot], cols[~hot]), Aj.cold)
    S = _scipy(m, n, vals, rows, cols)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    assert_close(A.matvec(_t(x)), S @ x)
    assert_close(A.matvec(_t(x)), Aj.matvec(jnp.asarray(x)))
    assert_close(A.rmatvec(_t(y)), S.T @ y)
    assert_close(A.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y)))
    u_ref = c1 * (S @ x) - c2 * y
    u, z = A.fused_pair(y=_t(y), win=_t(x), c1=c1, c2=c2)
    uj, zj = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=c1, c2=c2)
    assert_close(u, u_ref)
    assert_close(u, uj)
    assert_close(z, S.T @ u_ref)
    assert_close(z, zj)


def test_operator_from_arrays_wwcoo_and_rwcoo_match_jax(rng):
    m, n, vals, rows, cols = PATTERNS["zipf_dups_20001x12345"](rng)
    Aj = j_wwcoo_operator(m, n, vals, rows, cols)
    arrays, meta = jax_arrays(Aj.packed)
    coo = {f"coo_{f}": np.asarray(getattr(Aj.coo, f)) for f in ("vals", "rows", "cols")}
    A = lt.operator_from_arrays("wwcoo", {**arrays, **coo}, meta, device=DEV)
    assert isinstance(A, lt.WWCOOOperator)
    ref = wwcoo_pack(m, n, vals, rows, cols, device=DEV)
    assert torch.equal(A.packed.cidx, ref.cidx)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    assert_close(A.matvec(_t(x)), Aj.matvec(jnp.asarray(x)))
    assert_close(A.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y)))

    m, n, vals, rows, cols = RW_PATTERNS["zipf_40000x30000"](rng)
    Rj = j_rwcoo_operator(m, n, vals, rows, cols)
    hot, hot_meta = jax_arrays(Rj.hot)
    cold, cold_meta = jax_arrays(Rj.cold)
    arrays = {**{f"hot_{k}": v for k, v in hot.items()},
              **{f"cold_{k}": v for k, v in cold.items()},
              "hotmap": np.asarray(Rj.hotmap),
              **{f"coo_{f}": np.asarray(getattr(Rj.coo, f)) for f in ("vals", "rows", "cols")}}
    R = lt.operator_from_arrays("rwcoo", arrays, {"n": n, "hot": hot_meta, "cold": cold_meta},
                                device=DEV)
    assert isinstance(R, lt.RWCOOOperator) and R.shape == (m, n) and R.nnz == len(vals)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    assert_close(R.matvec(_t(x)), Rj.matvec(jnp.asarray(x)))
    assert_close(R.rmatvec(_t(y)), Rj.rmatvec(jnp.asarray(y)))
    u, z = R.fused_pair(y=_t(y), win=_t(x), c1=0.5, c2=2.0)
    uj, zj = Rj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=0.5, c2=2.0)
    assert_close(u, uj)
    assert_close(z, zj)


def test_rwcoo_without_a_cold_stream(rng):
    """Every column hot (at most 4096 occupied): JAX keeps cold None."""
    m, n = 20000, 10000
    vals = rng.standard_normal(40000).astype(np.float32)
    rows, cols = rng.integers(0, m, 40000), rng.integers(0, 3000, 40000) * 3
    A = lt.rwcoo_operator(m, n, vals, rows, cols, device=DEV)
    Aj = j_rwcoo_operator(m, n, vals, rows, cols)
    assert A.cold is None and Aj.cold is None
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    assert_close(A.matvec(_t(x)), Aj.matvec(jnp.asarray(x)))
    assert_close(A.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y)))
    u, z = A.fused_pair(y=_t(y), win=_t(x), c1=0.5, c2=2.0)
    uj, zj = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=0.5, c2=2.0)
    assert_close(u, uj)
    assert_close(z, zj)


def test_auto_operator_routes_rwcoo_like_jax(rng):
    """tests/test_wwcoo.py's routing cases: RWCOO for a column-concentrated
    wide pattern, a fallthrough for a near-uniform one, and not for f64."""
    m, n = 32768, 30000
    vals, rows, cols = _zipf(rng, m, n, 120000, 1.1)
    vals2, rows2 = rng.standard_normal(100000).astype(np.float32), rng.integers(0, m, 100000)
    cols2 = rng.integers(0, 65536, 100000)
    cases = [((m, n, vals, rows, cols), {}),
             ((m, 65536, vals2, rows2, cols2), {}),
             ((m, n, vals.astype(np.float64), rows, cols), {"dtype": "float64"})]
    got = [type(lt.auto_operator(*a, device=DEV, **kw)).__name__ for a, kw in cases]
    ref = [type(lj.auto_operator(*a, **kw)).__name__ for a, kw in cases]
    assert got == ref
    assert got[0] == "RWCOOOperator" and "RWCOOOperator" not in got[1:]


def test_rwcoo_lsqr_matches_jax(rng):
    m, n, nnz = 40000, 8192, 120000
    vals, rows, cols = zipf_column_coo(m, n, nnz, seed=7)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-6, btol=1e-6)
    # damped well above the round-off of two f32 summation orders
    rj = lj.lsqr(j_rwcoo_operator(m, n, vals, rows, cols), jnp.asarray(b), 10.0, **kw)
    A = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert isinstance(A, lt.RWCOOOperator) and not A.prefers_pair
    rt = lt.lsqr(A, _t(b), 10.0, **kw)
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= max(3, int(rj.itn) // 5)
    assert rel_err(rt.x, rj.x) < 1e-4


def test_column_index_of_jax_arrays_equals_the_packers(rng):
    m, n, vals, rows, cols = PATTERNS["uniform_20000x20000"](rng)
    ref = j_wwcoo_pack(m, n, vals, rows, cols)
    got = column_index(np.asarray(ref.col_r), np.asarray(ref.rowl), ref.eb)
    assert got.dtype == np.int32
    assert got.tobytes() == to_np(wwcoo_pack(m, n, vals, rows, cols, device=DEV).cidx).tobytes()


#: the WWCOO packings of the inverse-list test: PATTERNS, RWCOO's cold
#: streams (name prefixed "cold"), and the wide band
INVERSE = sorted(PATTERNS) + [f"cold {k}" for k in sorted(RW_PATTERNS)] + ["band_32768x262144"]


def _inverse_case(rng, name):
    """(port's WWCOOPacked, JAX's packing) of an INVERSE entry."""
    if name.startswith("cold "):
        m, n, vals, rows, cols = RW_PATTERNS[name[5:]](rng)
        return (lt.rwcoo_operator(m, n, vals, rows, cols, device=DEV).cold,
                j_rwcoo_operator(m, n, vals, rows, cols).cold)
    if name == "band_32768x262144":
        m, n = 32768, 262144
        vals, rows, cols = wide_band_triplets(rng, m, 6, 8)
    else:
        m, n, vals, rows, cols = PATTERNS[name](rng)
    return wwcoo_pack(m, n, vals, rows, cols, device=DEV), j_wwcoo_pack(m, n, vals, rows, cols)


@pytest.mark.parametrize("name", INVERSE)
def test_inverse_column_lists_equal_jax_zexp(rng, name):
    """zptr/zsrc, the WWCOO adjoint's inverse of colmap, say for every chunk
    and column what JAX's expansion tables zexp say: column zwk_zb[t, i] + j
    sits at position zexp[t, 8 i:8 i + 8].ravel()[j] of chunk t (-1: absent),
    listed per column in chunk order."""
    p, ref = _inverse_case(rng, name)
    zexp, zb = np.asarray(ref.zexp), np.asarray(ref.zwk_zb)
    nc, wz = zb.shape
    want = []
    for t in range(nc):
        tabs = zexp[t].reshape(wz, 1024)
        i, j = np.nonzero(tabs >= 0)
        want.append(np.stack([zb[t, i] + j, np.full(i.size, t), tabs[i, j]], axis=1))
    want = np.unique(np.concatenate(want).astype(np.int64), axis=0)  # by (column, t)
    zptr, zsrc = to_np(p.zptr).astype(np.int64), to_np(p.zsrc).astype(np.int64)
    d_pad = p.js * 128
    got = np.stack([np.repeat(np.arange(p.n), np.diff(zptr)), zsrc // d_pad, zsrc % d_pad],
                   axis=1)
    assert zptr[0] == 0 and zptr[-1] == zsrc.size and p.zptr.dtype == torch.int32
    np.testing.assert_array_equal(got, want)
    lists = column_lists(np.asarray(ref.colmap), p.n)
    assert lists[0].tobytes() == to_np(p.zptr).tobytes()
    assert lists[1].tobytes() == to_np(p.zsrc).tobytes()


@pytest.mark.parametrize("c1,c2", [(1.0, 0.0), (0.7, 0.3)])
def test_wwcoo_twins_on_a_wide_band_match_jax_and_scipy(rng, c1, c2):
    """The pattern of the card's large-D_pad adjoint (98,304 positions a
    chunk): JAX packs it byte for byte as the port does, and the twins
    match JAX's plain products and scipy."""
    m, n = 32768, 262144
    vals, rows, cols = wide_band_triplets(rng, m, 6, 8)
    ref = j_wwcoo_pack(m, n, vals, rows, cols)
    assert_same_arrays(*wwcoo_pack_arrays(m, n, vals, rows, cols), ref)
    A = lt.wwcoo_operator(m, n, vals, rows, cols, device=DEV)
    assert A.packed.js * 128 == 98304
    Aj = j_wwcoo_operator(m, n, vals, rows, cols)
    S = _scipy(m, n, vals, rows, cols)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    z = spmv_wcoo.wwcoo_adjoint(A.packed, _t(y))
    assert_close(z, S.T @ y)
    assert_close(z, Aj.rmatvec(jnp.asarray(y)))
    u2, z2 = spmv_wcoo.wwcoo_pair(A.packed, _t(y), _t(x), c1, c2)
    uj, zj = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=c1, c2=c2)
    assert_close(u2, uj)
    assert_close(z2, zj)
    assert_close(z2, S.T @ (c1 * (S @ x) - c2 * y))


def test_wwcoo_pair_on_the_cpu_runs_its_twin_and_launches_nothing(rng):
    """On CPU tensors the pair is its twin (the forward, then the adjoint of
    its padded u), and neither its count nor its sequence route's moves."""
    from lsqr_tpu_torch.ops import spmv

    m, n = 40_000, 30_001
    vals, rows, cols = _zipf(rng, m, n, 9_000, 1.3)
    p = wwcoo_pack(m, n, vals, rows, cols, force_emax=4096, force_js=512, device=DEV)
    x = _t(rng.standard_normal(n).astype(np.float32))
    y = _t(rng.standard_normal(m).astype(np.float32))
    spmv.reset_launch_counts()
    u, z = spmv_wcoo.wwcoo_pair(p, y, x, 0.7, -1.0)
    u_f = spmv_wcoo.wwcoo_forward(p, x, 0.7, -1.0, y)
    assert torch.equal(u, u_f)
    assert torch.equal(z, spmv_wcoo.wwcoo_adjoint(p, u_f))
    counts = spmv.launch_counts(by_variant=True)
    assert counts["wwcoo_pair"] == counts["wwcoo_pair[sequence]"] == 0
    assert_close(z, _scipy(m, n, vals, rows, cols).T @ to_np(u))
