"""The plane-split complex operators (ZDIA, ZJDIA) and the complex pair's
twin against the JAX package, on the same seeded inputs.

JAX runs on the CPU in x64, its Pallas ``zdia_pair`` in interpret mode at
one shape; the port through its plain twins (``device="cpu"``).
Tolerances: complex128 products and pairs within 1e-12 (the JAX tests'
``tests/test_zdia.py:64-82``), complex64 pairs within 5e-6 relative to the
largest element (``tests/test_zdia.py:95-115``), solves: istop equal, itn
within 1, x within 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops.pallas_spmv import zdia_pair as j_zdia_pair
from lsqr_tpu.ops.zdia import zdia_operator as j_zdia_operator
from lsqr_tpu.ops.zdia import zdia_pair_xla as j_zdia_pair_xla
from lsqr_tpu.ops.zdia import zjdia_operator as j_zjdia_operator
from lsqr_tpu_torch.ops import spmv
from lsqr_tpu_torch.ops.zdia import zdia_pair_plain

from _torch_parity import DEV, to_np


def _dense_from_offsets(rng, m, n, offsets, dtype=np.complex128):
    """Complex stripes and the dense matrix (tests/test_zdia.py:21-33)."""
    data = np.zeros((len(offsets), m), dtype)
    A = np.zeros((m, n), dtype)
    i = np.arange(m)
    for d, k in enumerate(offsets):
        j = i + k
        valid = (j >= 0) & (j < n)
        vals = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(dtype) * valid
        data[d] = vals
        A[i[valid], j[valid]] = vals[valid]
    return data, A


def _zvec(rng, k, dtype=np.complex128):
    return (rng.standard_normal(k) + 1j * rng.standard_normal(k)).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _carry(op):
    """The port's ZDIAOperator over a JAX ZDIAOperator's four planes."""
    return lt.operator_from_arrays(
        "zdia", {k: np.asarray(getattr(op, k)) for k in ("dr", "di", "tdr", "tdi")},
        {"m": op.m, "n": op.n, "offsets": op.offsets}, device=DEV)


PRODUCT_CASES = [  # tests/test_zdia.py:38-46
    (256, 256, (-2, -1, 0, 1, 2)),
    (300, 200, (-5, -1, 0, 2)),
    (200, 300, (0, 1, 90)),
    (250, 250, (-200, 0, 200)),
]


@pytest.mark.parametrize("m,n,offsets", PRODUCT_CASES)
def test_zdia_products_match_jax(rng, m, n, offsets):
    data, A = _dense_from_offsets(rng, m, n, offsets)
    Aj = j_zdia_operator(m, n, offsets, data)
    At = _carry(Aj)
    own = lt.zdia_operator(m, n, offsets, data, device=DEV)
    for k in ("dr", "di", "tdr", "tdi"):  # the same planes, packed by each package
        np.testing.assert_array_equal(to_np(getattr(own, k)), np.asarray(getattr(Aj, k)))
    assert At.dtype == own.dtype == torch.complex128 and At.nnz == Aj.nnz
    x, y = _zvec(rng, n), _zvec(rng, m)
    for op in (At, own):
        np.testing.assert_allclose(to_np(op.matvec(_t(x))), np.asarray(Aj.matvec(x)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(to_np(op.matvec(_t(x))), A @ x, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(to_np(op.rmatvec(_t(y))), A.conj().T @ y, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(to_np(op.todense()), np.asarray(Aj.todense()), rtol=1e-12)
    assert int(lt.acheck(At).inform) == int(lj.acheck(Aj).inform) == 0


def test_zdia_pair_twin_matches_xla_in_complex128(rng):
    m, n, offsets = 300, 260, (-3, 0, 4)  # tests/test_zdia.py:64-82
    data, A = _dense_from_offsets(rng, m, n, offsets)
    Aj = j_zdia_operator(m, n, offsets, data)
    At = _carry(Aj)
    win, y = _zvec(rng, n), _zvec(rng, m)
    c1, c2 = 0.7, 1.3
    uj, zj = j_zdia_pair_xla(Aj.dr, Aj.di, jnp.asarray(y), jnp.asarray(win), c1, c2,
                             offsets=offsets, m=m, n=n)
    u, z = zdia_pair_plain(At.dr, At.di, _t(y), _t(win), c1, c2, offsets=offsets, m=m, n=n)
    assert u.dtype == z.dtype == torch.complex128
    np.testing.assert_allclose(to_np(u), np.asarray(uj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(z), np.asarray(zj), rtol=1e-12, atol=1e-12)
    u_ref = A @ (win * c1) - c2 * y
    np.testing.assert_allclose(to_np(z), A.conj().T @ u_ref, rtol=1e-12, atol=1e-12)
    # f64 planes: fused_pair is two exact products, and the wrapper on CPU
    # tensors takes the twin
    u2, z2 = At.fused_pair(y=_t(y), win=_t(win), c1=c1, c2=c2)
    np.testing.assert_allclose(to_np(u2), np.asarray(uj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(z2), np.asarray(zj), rtol=1e-12, atol=1e-12)
    u3, z3 = spmv.zdia_pair(At.dr, At.di, _t(y), _t(win), c1, c2, offsets=offsets, m=m, n=n)
    assert torch.equal(u3, u) and torch.equal(z3, z)


PAIR_CASES = [  # tests/test_zdia.py:86-93
    (4096, 4096, (-2, -1, 0, 1, 2)),
    (5000, 5000, (-3, 0, 5)),
    (3000, 2000, (-5, -1, 0, 2)),
    (2000, 3000, (0, 1, 900)),
    (2048, 2048, (-1500, 0, 1500)),
    (1024, 1024, (0,)),
]


@pytest.mark.parametrize("m,n,offsets", PAIR_CASES)
def test_zdia_pair_twin_in_complex64(rng, m, n, offsets):
    """f32 planes and complex64 vectors: the twin against JAX's blocked XLA
    pair in f32 and, both, against the same pair in f64 (no dense matrix at
    these sizes)."""
    data, _ = _dense_from_offsets(rng, m, n, offsets, np.complex64)
    Aj = j_zdia_operator(m, n, offsets, data)
    At = _carry(Aj)
    assert At.dtype == torch.complex64 and At.dr.dtype == torch.float32
    win, y = _zvec(rng, n, np.complex64), _zvec(rng, m, np.complex64)
    c1, c2 = np.float32(0.7), np.float32(1.3)
    u, z = At.fused_pair(y=_t(y), win=_t(win), c1=float(c1), c2=float(c2))
    assert u.dtype == z.dtype == torch.complex64
    uj, zj = j_zdia_pair_xla(Aj.dr, Aj.di, jnp.asarray(y), jnp.asarray(win), c1, c2,
                             offsets=offsets, m=m, n=n)
    u64, z64 = zdia_pair_plain(At.dr.double(), At.di.double(), _t(y.astype(np.complex128)),
                               _t(win.astype(np.complex128)), float(c1), float(c2),
                               offsets=offsets, m=m, n=n)
    for got, ref in ((u, u64), (z, z64), (np.asarray(uj), u64), (np.asarray(zj), z64)):
        ref = to_np(ref)
        assert np.abs(to_np(got) - ref).max() / (np.abs(ref).max() + 1e-30) < 5e-6


def test_zdia_pair_twin_matches_jax_interpret(rng):
    """JAX's Pallas zdia_pair in interpret mode (slow in JAX's own suite)
    at one ragged over-determined shape with several 1024-row tiles."""
    m, n, offsets = 3000, 2000, (-5, -1, 0, 2)
    data, _ = _dense_from_offsets(rng, m, n, offsets, np.complex64)
    Aj = j_zdia_operator(m, n, offsets, data)
    At = _carry(Aj)
    win, y = _zvec(rng, n, np.complex64), _zvec(rng, m, np.complex64)
    c1, c2 = np.float32(0.7), np.float32(1.3)
    uj, zj = j_zdia_pair(Aj.dr, Aj.di, jnp.asarray(y), jnp.asarray(win), c1, c2,
                         offsets=offsets, m=m, n=n, interpret=True, tm=1024)
    u, z = spmv.zdia_pair(At.dr, At.di, _t(y), _t(win), float(c1), float(c2),
                          offsets=offsets, m=m, n=n)
    for got, ref in ((u, uj), (z, zj)):
        ref = np.asarray(ref)
        assert np.abs(to_np(got) - ref).max() / np.abs(ref).max() < 5e-6


#: the staged complex pair's edges on the card: one-sided bands (lower,
#: upper), ragged m != n both ways with several tiles, m below one tile
ZPAIR_EDGES = [
    (2501, 1803, (-9, -4, 0)),
    (1803, 2501, (0, 3, 11)),
    (3001, 2003, (-60, -3, 0, 5)),
    (2003, 3001, (-5, 0, 3, 60)),
    (301, 203, (-2, 0, 1)),
]


@pytest.mark.parametrize("m,n,offsets", ZPAIR_EDGES)
def test_zdia_pair_twin_matches_jax_interpret_at_staging_edges(rng, m, n, offsets):
    """The port's zdia_pair (its twin on the CPU) against JAX's Pallas
    zdia_pair in interpret mode at the staged kernel's edges, within 5e-6 of
    the largest element (f32 sums in other orders)."""
    data, _ = _dense_from_offsets(rng, m, n, offsets, np.complex64)
    Aj = j_zdia_operator(m, n, offsets, data)
    At = _carry(Aj)
    win, y = _zvec(rng, n, np.complex64), _zvec(rng, m, np.complex64)
    c1, c2 = np.float32(0.7), np.float32(1.3)
    uj, zj = j_zdia_pair(Aj.dr, Aj.di, jnp.asarray(y), jnp.asarray(win), c1, c2,
                         offsets=offsets, m=m, n=n, interpret=True, tm=1024)
    u, z = spmv.zdia_pair(At.dr, At.di, _t(y), _t(win), torch.tensor(float(c1)),
                          torch.tensor(float(c2)), offsets=offsets, m=m, n=n)
    for got, ref in ((u, uj), (z, zj)):
        ref = np.asarray(ref)
        assert np.abs(to_np(got) - ref).max() / np.abs(ref).max() < 5e-6


#: the card's shared memory an SM and a block (NVIDIA H100 80GB HBM3)
H100_SMEM = (233_472, 232_448)


@pytest.mark.parametrize("nd,lo,hi,T,nbytes", [
    # bench.py's zdia band, span 512: 2 x (2 x 5 x 516 x 4 + (518 + 514) x 8)
    # + 512 x 8 + 8 x 8
    (5, 2, 2, 508, 61_952),
    # the ragged band, span 509: 2 x (2 x 4 x 512 x 4 + (576 + 510) x 8)
    # + 510 x 8 + 8 x 4
    (4, 60, 5, 444, 54_256),
    (1, 0, 0, 512, 28_832),   # 2 x (2 x 516 x 4 + (514 + 514) x 8) + 512 x 8 + 32
])
def test_zpair_stage_bytes(nd, lo, hi, T, nbytes):
    """The staged complex pair's shared memory (csrc/zdia.cu: ZPairLayout):
    ZPAIR_STAGES stages of 2 nd plane rows (span + 3 floats rounded up to
    4), win (span + lo + hi + 1 complex64 rounded up to 2) and y (span + 1,
    rounded up to 2); u for the span and two ints a diagonal."""
    assert spmv.ZPAIR_STAGES == 2
    assert spmv.zpair_stage_bytes(nd, lo, hi, T) == nbytes


@pytest.mark.parametrize("nd,lo,hi,tile", [
    (5, 2, 2, 508),         # span 512, three blocks an SM
    (4, 60, 5, 444),        # the ragged band
    (5, 300, 200, 524),     # T >= lo + hi: span 1024, one block
    (25, 2, 2, 508),        # the most diagonals the rule takes
    (26, 2, 2, 0),          # more: two launches
    (3, 1024, 1024, 0),     # a halo at PAIR_MAX_HALO: no span's stages fit
])
def test_zpair_tile(nd, lo, hi, tile):
    """The staged complex pair's tile on the H100: T = span - (lo + hi
    rounded up to 4) for the first span of 512, 1024, 2048, 4096 with
    T >= lo + hi whose two stages fit two blocks an SM, else one; 0 (two
    launches) where none fits."""
    assert spmv.zpair_tile(nd, lo, hi, *H100_SMEM) == tile
    if tile:
        assert spmv.zpair_stage_bytes(nd, lo, hi, tile) <= H100_SMEM[1]


def _banded_problem(rng, m=400, n=400, dtype=np.complex128):
    """tests/test_zdia.py:132-140: offsets (-2, 0, 1), 8 on the diagonal."""
    offsets = (-2, 0, 1)
    data, A = _dense_from_offsets(rng, m, n, offsets, dtype)
    data[1] += 8.0
    i = np.arange(min(m, n))
    A[i, i] += 8.0
    return offsets, data, A


@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "cgls", "craig"])
def test_complex_pair_solves_match_jax(rng, solver):
    """Each solver's pair path on ZDIA in the port against the JAX
    package's (tests/test_zdia.py:143-163), and against its own COO solve."""
    offsets, data, A = _banded_problem(rng)
    m, n = A.shape
    Aj = j_zdia_operator(m, n, offsets, data)
    At = _carry(Aj)
    rows, cols = np.nonzero(A)
    coo = lt.coo_operator(m, n, A[rows, cols], rows, cols, device=DEV)
    if solver == "craig":
        b = A @ _zvec(rng, n)  # a consistent system
        kw = dict(atol=1e-12, btol=1e-12)
        args = ()
    else:
        b = _zvec(rng, m)
        kw = dict(atol=1e-12, btol=1e-12)
        args = (0.1,)
    ref = getattr(lj, solver)(Aj, b, *args, pair=True, **kw)
    res = getattr(lt, solver)(At, _t(b), *args, pair=True, **kw)
    res_coo = getattr(lt, solver)(coo, _t(b), *args, **kw)
    for other in (ref, res_coo):
        assert int(res.istop) == int(other.istop)
        assert abs(int(res.itn) - int(other.itn)) <= 1
        np.testing.assert_allclose(to_np(res.x), np.asarray(other.x), rtol=1e-8, atol=1e-9)
    assert res.x.dtype == torch.complex128


def test_routing_validation_and_pair_rejection(rng):
    """tests/test_zdia.py:166-208 in both packages."""
    offsets, data, A = _banded_problem(rng)
    m, n = A.shape
    rows, cols = np.nonzero(A)
    op = lt.auto_operator(m, n, A[rows, cols], rows, cols, device=DEV)
    assert type(op).__name__ == type(lj.auto_operator(m, n, A[rows, cols], rows, cols)
                                     ).__name__ == "ZDIAOperator"
    assert op.offsets == offsets
    x = _zvec(rng, n)
    np.testing.assert_allclose(to_np(op.matvec(_t(x))), A @ x, rtol=1e-12, atol=1e-12)
    r2, c2 = rng.integers(0, m, 2000), rng.integers(0, n, 2000)
    v2 = _zvec(rng, 2000)
    assert isinstance(lt.auto_operator(m, n, v2, r2, c2, device=DEV), lt.COOOperator)
    assert type(lj.auto_operator(m, n, v2, r2, c2)).__name__ == "COOOperator"
    # dia_operator dispatches complex stripes; bf16 storage is real-only
    m2, n2, offs2 = 120, 100, (-1, 0, 2)
    data2, A2 = _dense_from_offsets(rng, m2, n2, offs2)
    assert isinstance(lt.dia_operator(m2, n2, offs2, data2, device=DEV), lt.ZDIAOperator)
    assert isinstance(lt.dia_operator_device(m2, n2, offs2, _t(data2)), lt.ZDIAOperator)
    for build in (lambda: lt.dia_operator(m2, n2, offs2, data2, storage_dtype="bfloat16",
                                          device=DEV),
                  lambda: lt.dia_operator_device(m2, n2, offs2, _t(data2),
                                                 storage_dtype=torch.bfloat16),
                  lambda: lj.dia_operator(m2, n2, offs2, data2, storage_dtype="bfloat16")):
        with pytest.raises(ValueError, match="real"):
            build()
    for pkg, kw in ((lt, dict(device=DEV)), (lj, {})):
        with pytest.raises(ValueError, match="shape"):
            pkg.zdia_operator(10, 10, (0, 1), np.zeros((2, 9), np.complex64), **kw)
    # the real-f32 pairs refuse complex vectors (tests/test_zdia.py:166-175)
    r3, c3 = rng.integers(0, 60, 300), rng.integers(0, 40, 300)
    v3, b3 = _zvec(rng, 300), _zvec(rng, 60)
    for pkg, Acoo in ((lt, lt.coo_operator(60, 40, v3, r3, c3, device=DEV)),
                      (lj, lj.coo_operator(60, 40, v3, r3, c3))):
        with pytest.raises(ValueError, match="pair"):
            pkg.lsqr(Acoo, b3, 0.1, pair=True)
    # an operator with a real pair kernel and complex vectors: the solvers'
    # guard (the JAX message)
    Ar = lt.dia_operator(60, 60, (0,), np.ones((1, 60)), device=DEV)
    for fn, msg in ((lambda: lt.lsqr(Ar, _t(b3), pair=True), "real-f32 only"),
                    (lambda: lt.lsmr(Ar, _t(b3), pair=True), "real-f32 only"),
                    (lambda: lt.cgls(Ar, _t(b3), pair=True), "real-f32 only"),
                    (lambda: lt.craig(Ar, _t(b3), pair=True), "real-f32 only")):
        with pytest.raises(ValueError, match=msg):
            fn()


def _zjdia_pattern(rng, m=600, n=500):
    """tests/test_zdia.py:211-231: a full-rank jittered band, 8 added on the
    diagonal, duplicates removed."""
    drows = np.arange(n)
    jrows = np.repeat(np.arange(m), 2)
    jcols = jrows + np.tile([-1, 1], m) + rng.integers(-2, 3, jrows.size)
    keep = (jcols >= 0) & (jcols < n) & (jcols != jrows)
    rows = np.concatenate([drows, jrows[keep]])
    cols = np.concatenate([drows, jcols[keep]])
    _, idx = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = rng.standard_normal(rows.size) + 1j * rng.standard_normal(rows.size)
    vals[rows == cols] += 8.0
    return vals, rows, cols


JDIA_ARRAYS = ("data", "eoff", "base", "tdata", "teoff", "tbase", "rem_vals", "rem_rows",
               "rem_cols")


def test_zjdia_products_solve_and_carry(rng):
    m, n = 600, 500
    vals, rows, cols = _zjdia_pattern(rng, m, n)
    Aj = j_zjdia_operator(m, n, vals, rows, cols)
    At = lt.zjdia_operator(m, n, vals, rows, cols, device=DEV)
    for plane in ("re", "im"):  # byte-equal packings
        for k in JDIA_ARRAYS:
            np.testing.assert_array_equal(to_np(getattr(getattr(At, plane), k)),
                                          np.asarray(getattr(getattr(Aj, plane), k)))
    meta = {k: getattr(Aj.re, k) for k in ("m", "n", "p_lo", "win", "tp_lo", "twin", "tm",
                                           "nnz")}
    arrays = {f"{p}_{k}": np.asarray(getattr(getattr(Aj, p), k))
              for p in ("re", "im") for k in JDIA_ARRAYS}
    Ac = lt.operator_from_arrays("zjdia", arrays, meta, device=DEV)
    dense = np.zeros((m, n), complex)
    dense[rows, cols] = vals
    assert At.dtype == Ac.dtype == torch.complex128 and At.fit_fraction == Aj.fit_fraction
    x, y = _zvec(rng, n), _zvec(rng, m)
    for op in (At, Ac):
        np.testing.assert_allclose(to_np(op.matvec(_t(x))), dense @ x, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(to_np(op.rmatvec(_t(y))), dense.conj().T @ y, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(to_np(op.todense()), dense, rtol=1e-12)
    assert int(lt.acheck(At).inform) == int(lj.acheck(Aj).inform) == 0
    Aa = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert type(Aa).__name__ == type(lj.auto_operator(m, n, vals, rows, cols)).__name__
    x_true = _zvec(rng, n)
    b = dense @ x_true
    res = lt.lsqr(At, _t(b), atol=1e-6, btol=1e-6)
    ref = lj.lsqr(Aj, b, atol=1e-6, btol=1e-6)
    assert int(res.istop) == int(ref.istop) and int(res.istop) in (1, 2)
    assert abs(int(res.itn) - int(ref.itn)) <= 1
    assert np.abs(to_np(res.x) - x_true).max() < 1e-3
    np.testing.assert_allclose(to_np(res.x), np.asarray(ref.x), rtol=1e-8, atol=1e-9)


def test_zdia_stripes_generator(rng):
    """The complex banded generator: numpy's draws (real plane, then the
    imaginary one) as a JAX-side construction makes them, masked, with the
    diagonal boost; the torch generator gives the same pattern."""
    m, n = 1000, 900
    s = lt.zdia_stripes(m, n, seed=3, diag=12.0, device=DEV)
    g = np.random.default_rng(3)
    re, im = (g.standard_normal((5, m)).astype(np.float32) for _ in range(2))
    re[2] += np.float32(12.0)
    i = np.arange(m)
    mask = np.stack([(i + k >= 0) & (i + k < n) for k in range(-2, 3)])
    np.testing.assert_array_equal(to_np(s), (re + 1j * im) * mask)
    st = lt.zdia_stripes(m, n, seed=3, diag=12.0, device=DEV, generator="torch")
    assert st.dtype == torch.complex64 and bool((st[torch.from_numpy(~mask)] == 0).all())
    assert abs(float(st[2, :n].real.mean()) - 12.0) < 0.2
    op = lt.dia_operator_device(m, n, lt.models.synthetic.ZDIA_OFFSETS, s)
    np.testing.assert_array_equal(to_np(op.dr), (re * mask).astype(np.float32))
