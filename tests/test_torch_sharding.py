"""The port's sharded solvers (``lsqr_tpu_torch.parallel``) against the JAX
package's, on the CPU.

The port runs in a module-wide pool of four spawned ranks joined over gloo
(``_torch_ranks``); 2-rank meshes are the first two of them. JAX runs its
sharded solve in this process on a mesh of the same shape over its eight
virtual CPU devices (tests/conftest.py), in x64. Every case also holds the
port's sharded solve to its own unsharded solve, and all ranks' x to each
other, bit for bit: a rank that drifted would stop at another iteration and
hang the others.

Tolerances are those of ``tests/test_sharding.py``: at a fixed itn (zero
tolerances) itn is equal, x within rtol 1e-7 / atol 1e-10 and rnorm within
rtol 1e-11; at convergence istop is equal, itn within 3 and x within atol
1e-7 (COO) or 1e-5 (DIA). The WCOO family runs in f32 and is held to JAX's
plain (``use_pallas=False``) products, as ``test_torch_wcoo.py`` holds it,
since JAX's interpret-mode WCOO kernels are too slow here; its packings
equal JAX's shard packings byte for byte.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 - one CPU thread, as the ranks have
import _torch_ranks as ranks
import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.parallel import sharding as js

FIXED = dict(atol=0.0, btol=0.0, conlim=0.0)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = ranks.RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def members(results):
    """The results of the mesh's ranks (the others return None); all equal
    bit for bit, field for field."""
    got = [r for r in results if r is not None]
    assert got
    for other in got[1:]:
        assert sorted(other) == sorted(got[0])
        for name in got[0]:
            np.testing.assert_array_equal(other[name], got[0][name], err_msg=name)
    return got[0]


def run(pool, entry, spec, b, shape, *args, **kwargs):
    return members(pool.run(ranks.solve, entry, spec, b, shape, args, kwargs))


def jmesh(shape):
    return js.make_mesh(shape) if isinstance(shape, int) else js.make_mesh_2d(shape)


# ---------------------------------------------------------------------------
# problems: numpy specs for the ranks, the same operator in each package
# ---------------------------------------------------------------------------


def coo_spec(rng, m, n, nnz, complex_=False, boost=0.0):
    """Random triplets, with ``boost`` on the diagonal where it is nonzero.
    The fixed-itn cases take a boosted diagonal: on the plain random
    matrices the sums' rounding differences grow some tenfold an iteration
    once the Krylov basis loses orthogonality (the port's own 4-rank and
    1-rank solves of a 197 x 120 one part by 1e-15 at itn 10, 3e-10 at 20
    and 1e-4 at 30), which no tolerance of a fixed-itn comparison survives."""
    vals = rng.standard_normal(nnz)
    if complex_:
        vals = vals + 1j * rng.standard_normal(nnz)
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    if boost:
        k = np.arange(min(m, n))
        vals, rows, cols = np.concatenate([vals, np.full(k.size, boost)]), np.concatenate(
            [rows, k]), np.concatenate([cols, k])
    return ("coo", m, n, vals, rows, cols)


def dense_spec(rng, m, n):
    """A dense random matrix as COO (every entry), its triplets."""
    dense = rng.standard_normal((m, n))
    r, c = np.nonzero(dense)
    return ("coo", m, n, dense[r, c], r, c), dense


def band_spec(rng, m, n, offsets, kind="dia", boost=0.0, complex_=False):
    data = rng.standard_normal((len(offsets), m))
    if complex_:
        data = data + 1j * rng.standard_normal((len(offsets), m))
    data[list(offsets).index(0)] += boost
    return (kind, m, n, tuple(offsets), data)


def jax_op(spec):
    kind, m, n, *rest = spec
    if kind == "coo":
        return lj.coo_operator(m, n, *rest)
    from lsqr_tpu.ops.structured import dia_operator, dia_shared_operator

    offsets, data = rest
    if np.iscomplexobj(data):
        from lsqr_tpu.ops.zdia import zdia_operator

        return zdia_operator(m, n, offsets, data)
    make = dia_shared_operator if kind == "dia_shared" else dia_operator
    return make(m, n, offsets, data, use_pallas=False)


def port_op(spec):
    return ranks.build(spec)


def assert_fixed(res, ref, x_rtol=1e-7, x_atol=1e-10):
    """A fixed-itn run against its reference."""
    assert int(res["itn"]) == int(ref.itn)
    np.testing.assert_allclose(res["x"], np.asarray(ref.x), rtol=x_rtol, atol=x_atol)
    if hasattr(ref, "rnorm"):
        np.testing.assert_allclose(res["rnorm"], float(ref.rnorm), rtol=1e-11)


def assert_converged(res, ref, atol):
    assert int(res["istop"]) == int(ref.istop)
    assert abs(int(res["itn"]) - int(ref.itn)) <= 3
    np.testing.assert_allclose(res["x"], np.asarray(ref.x), atol=atol)


# ---------------------------------------------------------------------------
# mesh and partition
# ---------------------------------------------------------------------------


def test_parallel_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys, lsqr_tpu_torch.parallel as p; "
            "assert 'jax' not in sys.modules and not any(k.startswith('lsqr_tpu.') "
            "or k == 'lsqr_tpu' for k in sys.modules); print(len(p.__all__))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == str(len(lj.parallel.__all__))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_shard_coo_matches_jax_byte_for_byte(rng, ndev):
    from lsqr_tpu_torch.parallel import shard_coo

    spec = coo_spec(rng, 197, 60, 700)
    got, ref = shard_coo(port_op(spec), ndev), js.shard_coo(jax_op(spec), ndev)
    for name in ("vals", "rows", "cols"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert (got.m, got.n, got.m_pad, got.ndev, got.rows_per_dev) == (
        ref.m, ref.n, ref.m_pad, ref.ndev, ref.rows_per_dev)


# ---------------------------------------------------------------------------
# COO rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("shape", [(200, 120), (97, 211)])
def test_sharded_coo_converged(pool, rng, ndev, shape):
    m, n = shape
    spec = coo_spec(rng, m, n, 5 * m, boost=4.0)
    b = rng.standard_normal(m)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=400)
    res = run(pool, "lsqr_sharded", spec, b, ndev, 0.05, **kw)
    ref = js.lsqr_sharded(jax_op(spec), b, 0.05, mesh=jmesh(ndev), **kw)
    assert_converged(res, ref, 1e-7)
    own = lt.lsqr(port_op(spec), torch.from_numpy(b), 0.05, **kw)
    assert_converged(res, own, 1e-7)


def test_sharded_coo_fixed_itn_wantse(pool, rng):
    m, n = 197, 120  # ragged over 4 ranks
    spec = coo_spec(rng, m, n, 6 * m, boost=8.0)
    b = rng.standard_normal(m)
    kw = dict(FIXED, wantse=True, itnlim=30)
    res = run(pool, "lsqr_sharded", spec, b, 4, 0.1, **kw)
    ref = js.lsqr_sharded(jax_op(spec), b, 0.1, mesh=jmesh(4), **kw)
    assert_fixed(res, ref)
    np.testing.assert_allclose(res["se"], np.asarray(ref.se), rtol=1e-7, atol=1e-11)
    own = lt.lsqr(port_op(spec), torch.from_numpy(b), 0.1, **kw)
    assert_fixed(res, own)


def test_sharded_wantse_and_damped(pool, rng):
    m, n = 160, 80
    spec = coo_spec(rng, m, n, 800, boost=8.0)
    b = rng.standard_normal(m)
    kw = dict(wantse=True, atol=1e-9, btol=1e-9, itnlim=300)
    res = run(pool, "lsqr_sharded", spec, b, 4, 0.2, **kw)
    ref = js.lsqr_sharded(jax_op(spec), b, 0.2, mesh=jmesh(4), **kw)
    assert int(res["istop"]) == 3 == int(ref.istop)
    np.testing.assert_allclose(res["se"], np.asarray(ref.se), rtol=1e-2)


def test_sharded_complex_coo(pool, rng):
    """Complex values: the conjugated partial sums are summed as complex
    values, the scalars stay real (JAX's tests/test_complex.py:204)."""
    m, n = 96, 40
    spec = coo_spec(rng, m, n, 500, complex_=True, boost=8.0)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    kw = dict(FIXED, itnlim=25)
    res = run(pool, "lsqr_sharded", spec, b, 4, 0.1, **kw)
    ref = js.lsqr_sharded(jax_op(spec), b, 0.1, mesh=jmesh(4), **kw)
    assert res["x"].dtype == np.complex128 and res["rnorm"].dtype == np.float64
    assert_fixed(res, ref, x_atol=1e-9)


def test_sharded_rejects_bad_b(pool, rng):
    spec = coo_spec(rng, 64, 32, 200)
    errors = pool.run(ranks.solve_error, "lsqr_sharded", spec, np.zeros(63), 4)
    assert all(e is not None and e[0] == "ValueError" and "shape (64,)" in e[1]
               for e in errors)
    errors = pool.run(ranks.solve_error, "lsqr_sharded_2d", spec, np.zeros(63), (2, 2))
    assert all(e is not None and e[0] == "ValueError" for e in errors)


@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_sibling_sharded_coo(pool, rng, solver):
    """LSMR, CRAIG and CGLS over the row partition at a fixed itn."""
    if solver == "lsmr":
        spec = coo_spec(rng, 200, 120, 1400, boost=8.0)
        b = rng.standard_normal(200)
        args, kw = (0.1,), dict(atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    elif solver == "craig":
        spec, dense = dense_spec(rng, 60, 150)
        b = dense @ rng.standard_normal(150)
        args, kw = (), dict(atol=0.0, btol=0.0, itnlim=30)
    else:
        spec, _ = dense_spec(rng, 150, 60)
        b = rng.standard_normal(150)
        args, kw = (0.1,), dict(atol=0.0, btol=0.0, itnlim=25)
    res = run(pool, f"{solver}_sharded", spec, b, 4, *args, **kw)
    ref = getattr(js, f"{solver}_sharded")(jax_op(spec), b, *args, mesh=jmesh(4), **kw)
    assert int(res["itn"]) == int(ref.itn)
    np.testing.assert_allclose(res["x"], np.asarray(ref.x), rtol=1e-7, atol=1e-10)
    own = getattr(lt, solver)(port_op(spec), torch.from_numpy(b), *args, **kw)
    np.testing.assert_allclose(res["x"], own.x.numpy(), rtol=1e-7, atol=1e-10)


# ---------------------------------------------------------------------------
# banded rows: DIA and ZDIA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dia", "dia_shared"])
@pytest.mark.parametrize("m,n", [(260, 260), (202, 150), (150, 202)])
def test_sharded_dia_ragged_fixed_itn(pool, rng, kind, m, n):
    """Ragged rows (m % 4 != 0): the last shard runs past m."""
    spec = band_spec(rng, m, n, (-7, -1, 0, 1, 6), kind)
    b = rng.standard_normal(m)
    kw = dict(FIXED, itnlim=25)
    res = run(pool, "lsqr_sharded_dia", spec, b, 4, 0.05, **kw)
    ref = js.lsqr_sharded_dia(jax_op(spec), b, 0.05, mesh=jmesh(4), **kw)
    assert_fixed(res, ref)
    np.testing.assert_allclose(res["xnorm"], float(ref.xnorm), rtol=1e-9)
    own = lt.lsqr(port_op(spec), torch.from_numpy(b), 0.05, **kw)
    assert_fixed(res, own)


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_dia_converged(pool, rng, ndev):
    spec = band_spec(rng, 262, 262, (-4, -1, 0, 2, 5), boost=4.0)
    b = rng.standard_normal(262)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=400)
    res = run(pool, "lsqr_sharded_dia", spec, b, ndev, 0.05, **kw)
    ref = js.lsqr_sharded_dia(jax_op(spec), b, 0.05, mesh=jmesh(ndev), **kw)
    assert_converged(res, ref, 1e-5)


def test_sharded_dia_pair(pool, rng):
    """pair=True: both products from one local stripe pass and one sum."""
    spec = band_spec(rng, 260, 210, (-4, -1, 0, 2, 5), "dia_shared")
    b = rng.standard_normal(260)
    kw = dict(FIXED, itnlim=25)
    res = run(pool, "lsqr_sharded_dia", spec, b, 4, 0.05, pair=True, **kw)
    ref = js.lsqr_sharded_dia(jax_op(spec), b, 0.05, mesh=jmesh(4), pair=True, **kw)
    assert_fixed(res, ref)
    own = lt.lsqr(port_op(spec), torch.from_numpy(b), 0.05, pair=True, **kw)
    assert_fixed(res, own)


def test_sharded_dia_accepts_both_layouts(pool, rng):
    """The packed and the shared operator give the same shards, bit for bit."""
    spec = band_spec(rng, 260, 260, (-4, -1, 0, 2, 5), "dia")
    b = rng.standard_normal(260)
    kw = dict(FIXED, itnlim=25)
    rp = run(pool, "lsqr_sharded_dia", spec, b, 4, 0.05, **kw)
    rs = run(pool, "lsqr_sharded_dia", ("dia_shared",) + spec[1:], b, 4, 0.05, **kw)
    np.testing.assert_array_equal(rp["x"], rs["x"])
    assert int(rp["itn"]) == int(rs["itn"])


@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_sibling_sharded_dia(pool, rng, solver):
    """LSMR, CRAIG and CGLS over the banded rows, ragged, at a fixed itn
    (the plain products) and converged (pair=True)."""
    m = n = 262
    spec = band_spec(rng, m, n, (-4, -1, 0, 2, 5), boost=5.0)
    A = port_op(spec)
    b = rng.standard_normal(m)
    if solver == "craig":
        b = A.matvec(torch.from_numpy(rng.standard_normal(n))).numpy()
        args, kw = (), dict(atol=0.0, btol=0.0, itnlim=25)
    else:
        args = (0.05,)
        kw = dict(atol=0.0, btol=0.0, itnlim=25, **({"conlim": 0.0} if solver == "lsmr"
                                                    else {}))
    res = run(pool, f"{solver}_sharded_dia", spec, b, 4, *args, **kw)
    ref = getattr(js, f"{solver}_sharded_dia")(jax_op(spec), b, *args, mesh=jmesh(4), **kw)
    assert int(res["itn"]) == int(ref.itn)
    np.testing.assert_allclose(res["x"], np.asarray(ref.x), rtol=1e-7, atol=1e-10)
    tol = dict(atol=1e-9, btol=1e-9)
    res = run(pool, f"{solver}_sharded_dia", spec, b, 4, *args, pair=True, **tol)
    ref = getattr(js, f"{solver}_sharded_dia")(jax_op(spec), b, *args, mesh=jmesh(4),
                                              pair=True, **tol)
    assert_converged(res, ref, 1e-5)
    own = getattr(lt, solver)(A, torch.from_numpy(b), *args, pair=True, **tol)
    assert_converged(res, own, 1e-5)


@pytest.mark.parametrize("m,n,pair", [(202, 150, False), (150, 202, False),
                                      (260, 210, True)])
def test_sharded_zdia_fixed_itn(pool, rng, m, n, pair):
    """Complex bands: the plane-split shards, conjugation as a sign."""
    spec = band_spec(rng, m, n, (-7, -1, 0, 1, 6), complex_=True)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    kw = dict(FIXED, itnlim=25, pair=pair)
    res = run(pool, "lsqr_sharded_zdia", spec, b, 4, 0.05, **kw)
    ref = js.lsqr_sharded_zdia(jax_op(spec), b, 0.05, mesh=jmesh(4), **kw)
    x_rtol, x_atol = (1e-6, 1e-9) if pair else (1e-7, 1e-10)  # JAX's pair band
    assert_fixed(res, ref, x_rtol, x_atol)
    own = lt.lsqr(port_op(spec), torch.from_numpy(b), 0.05, **kw)
    assert_fixed(res, own, x_rtol, x_atol)


def test_sharded_zdia_converged(pool, rng):
    spec = band_spec(rng, 262, 262, (-4, -1, 0, 2, 5), complex_=True, boost=4.0)
    b = rng.standard_normal(262) + 1j * rng.standard_normal(262)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=400)
    res = run(pool, "lsqr_sharded_zdia", spec, b, 4, 0.05, **kw)
    ref = js.lsqr_sharded_zdia(jax_op(spec), b, 0.05, mesh=jmesh(4), **kw)
    assert_converged(res, ref, 1e-5)


# ---------------------------------------------------------------------------
# multi-damp sweeps over the rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,pair", [("coo", False), ("dia", False), ("dia", True)])
def test_multidamp_sharded(pool, rng, kind, pair):
    m, n = 262, 150
    if kind == "coo":
        spec = coo_spec(rng, m, n, 1500, boost=8.0)
    else:
        spec = band_spec(rng, m, n, (-1, 0, 2), boost=8.0)
    b = rng.standard_normal(m)
    damps = np.array([0.0, 1e-3, 0.7])
    kw = dict(FIXED, itnlim=20, wantse=True, pair=pair)
    res = run(pool, "lsqr_multidamp_sharded", spec, b, 4, damps, **kw)
    ref = js.lsqr_multidamp_sharded(jax_op(spec), b, damps, mesh=jmesh(4), **kw)
    np.testing.assert_array_equal(res["itn"], np.asarray(ref.itn))
    np.testing.assert_allclose(res["x"], np.asarray(ref.x), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(res["rnorm"], np.asarray(ref.rnorm), rtol=1e-11)
    own = lt.lsqr_multidamp(port_op(spec), torch.from_numpy(b), damps, **kw)
    np.testing.assert_allclose(res["x"], own.x.numpy(), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("entry", ["lsqr_sharded", "lsqr_multidamp_sharded"])
def test_sharded_solves_run_whole_segments(pool, rng, entry):
    """Ranks must leave the loop at the same iteration, and a stop flag read
    without blocking lands at another step on each rank: a sharded solve,
    even on a world of one, ends a segment only on the segment's blocking
    read, where the same solve unsharded ends it at the stop."""
    from lsqr_tpu_torch import tracing

    spec = coo_spec(rng, 262, 150, 1500, boost=8.0)
    b = rng.standard_normal(262)
    args = (np.array([0.0, 0.1]),) if entry == "lsqr_multidamp_sharded" else (0.1,)
    kw = dict(atol=1e-8, btol=1e-8, loop_segment=8)
    out = pool.run(ranks.counted_segments, entry, spec, b, 1, args, kw)
    (res, c), = [o for o in out if o is not None]
    itn = int(res["itn"].max())
    assert itn % 8 != 0 and c["iterations_needed"] == itn
    assert c["iterations_launched"] == 8 * -(-itn // 8) and c["segments_cut"] == 0
    tracing.clear()
    solve = lt.lsqr_multidamp if entry == "lsqr_multidamp_sharded" else lt.lsqr
    own = solve(port_op(spec), torch.from_numpy(b), *args, **kw)
    assert int(own.itn.max()) == itn
    assert tracing.counts()["segments_cut"] == 1


# ---------------------------------------------------------------------------
# 2-D blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_sharded_2d_fixed_itn(pool, rng, shape):
    m, n = 150, 262  # ragged on both axes
    spec = coo_spec(rng, m, n, 6 * m, boost=8.0)
    b = rng.standard_normal(m)
    kw = dict(FIXED, itnlim=25, wantse=True)
    res = run(pool, "lsqr_sharded_2d", spec, b, shape, 0.1, **kw)
    assert res["x"].shape == (n,) and res["se"].shape == (n,)
    ref = js.lsqr_sharded_2d(jax_op(spec), b, 0.1, mesh=jmesh(shape), **kw)
    assert_fixed(res, ref)
    np.testing.assert_allclose(res["se"], np.asarray(ref.se), rtol=1e-7, atol=1e-11)
    own = lt.lsqr(port_op(spec), torch.from_numpy(b), 0.1, **kw)
    assert_fixed(res, own)


def test_sharded_2d_converged_and_complex(pool, rng):
    spec = coo_spec(rng, 200, 120, 1000, boost=4.0)
    b = rng.standard_normal(200)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=400)
    res = run(pool, "lsqr_sharded_2d", spec, b, (2, 2), 0.05, **kw)
    ref = js.lsqr_sharded_2d(jax_op(spec), b, 0.05, mesh=jmesh((2, 2)), **kw)
    assert_converged(res, ref, 1e-7)
    # complex blocks (JAX's tests/test_complex.py:300): se stays real
    spec = coo_spec(rng, 96, 64, 600, complex_=True, boost=8.0)
    b = rng.standard_normal(96) + 1j * rng.standard_normal(96)
    kw = dict(FIXED, itnlim=25, wantse=True)
    res = run(pool, "lsqr_sharded_2d", spec, b, (2, 2), 0.1, **kw)
    ref = js.lsqr_sharded_2d(jax_op(spec), b, 0.1, mesh=jmesh((2, 2)), **kw)
    assert res["se"].dtype == np.float64
    assert_fixed(res, ref, x_atol=1e-9)


def test_traced_2d_solve_gathers_only_at_finalize(pool, rng):
    """record_trace on a column-split solve takes x[0] with one scalar sum
    from its rank; x is gathered once, at the end: one all-reduce of the
    whole n-vector over the solve."""
    m, n = 96, 64
    rows = np.concatenate([rng.integers(0, m, 4 * m), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, 4 * m), np.arange(n)])
    vals = np.concatenate([rng.standard_normal(4 * m), np.full(n, 8.0)])
    spec = ("coo", m, n, vals, rows, cols)
    b = rng.standard_normal(m)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=30, record_trace=True)
    out = pool.run(ranks.counted_solve, "lsqr_sharded_2d", spec, b, (2, 2), (0.05,), kw)
    res = members([o[0] for o in out])
    for _, lengths in out:
        assert lengths.count(n) == 1           # the gather of x
        assert max(lengths) == n and lengths[-1] == n
    ref = js.lsqr_sharded_2d(jax_op(spec), b, 0.05, mesh=jmesh((2, 4)), **kw)
    itn = int(res["itn"])
    assert itn == int(ref.itn)
    np.testing.assert_allclose(res["trace"][1:itn + 1], np.asarray(ref.trace)[1:itn + 1],
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("solver", ["lsmr", "craig", "cgls"])
def test_sibling_sharded_2d(pool, rng, shape, solver):
    spec, dense = dense_spec(rng, 90, 140)
    b = dense @ rng.standard_normal(140)  # consistent (CRAIG needs it)
    args = () if solver == "craig" else ((0.01,) if solver == "lsmr" else (0.05,))
    kw = dict(atol=0.0, btol=0.0, itnlim=20, **({"conlim": 0.0} if solver == "lsmr" else {}))
    res = run(pool, f"{solver}_sharded_2d", spec, b, shape, *args, **kw)
    ref = getattr(js, f"{solver}_sharded_2d")(jax_op(spec), b, *args, mesh=jmesh(shape), **kw)
    assert int(res["itn"]) == int(ref.itn)
    np.testing.assert_allclose(res["x"], np.asarray(ref.x), rtol=1e-7, atol=1e-10)


# ---------------------------------------------------------------------------
# WCOO, RWCOO and WWCOO shards (f32)
# ---------------------------------------------------------------------------


def boosted(kind, m, n, vals, rows, cols, boost):
    """The triplets with ``boost`` at (k mod m, k) for every column k."""
    if boost:
        k = np.arange(n)
        vals = np.concatenate([vals, np.full(n, boost, vals.dtype)])
        rows, cols = np.concatenate([rows, k % m]), np.concatenate([cols, k])
    return (kind, m, n, vals, rows, cols)


def zipf_spec(rng, kind, m, n, nnz, a=1.1, boost=0.0):
    """bench.py's Zipf(1.1) columns at this size, f32."""
    cols = rng.zipf(a, size=6 * nnz) - 1
    cols = cols[cols < n][:nnz].astype(np.int64)
    rows = rng.integers(0, m, len(cols)).astype(np.int64)
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    return boosted(kind, m, n, vals, rows, cols, boost)


def jax_fields(packed):
    arrays, meta = {}, {}
    for f in dataclasses.fields(packed):
        value = getattr(packed, f.name)
        if f.metadata.get("static"):
            meta[f.name] = value
        else:
            arrays[f.name] = np.asarray(value)
    return arrays, meta


def assert_same_pack(got, ref_packed):
    arrays, meta = got
    ref, ref_meta = jax_fields(ref_packed)
    assert sorted(arrays) == sorted(ref)
    for name in ref:
        assert arrays[name].tobytes() == ref[name].tobytes(), name
    assert meta == ref_meta


def consistent(spec, rng):
    """b = A x for a random x, in f32."""
    import scipy.sparse

    _, m, n, vals, rows, cols = spec
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    return (S @ rng.standard_normal(n).astype(np.float32)).astype(np.float32)


def uniform_spec(rng, m, n, nnz, boost=0.0):
    """Uniform f32 triplets: dense enough a row that every WCOO subtile
    spans few rows (a sparse Zipf block of a 2-D grid exceeds the WCOO
    packer's u-window, as in JAX)."""
    return boosted("coo", m, n, rng.standard_normal(nnz).astype(np.float32),
                   rng.integers(0, m, nnz), rng.integers(0, n, nnz), boost)


def jax_plain(spec, b, *args, solver="lsqr", **kw):
    """JAX's unsharded solve on the COO products (the WCOO family's plain
    products), in the triplets' f32."""
    _, m, n, vals, rows, cols = spec
    return getattr(lj, solver)(lj.coo_operator(m, n, vals, rows, cols), b, *args, **kw)


def test_wcoo_shards_pack_as_jax(pool, rng):
    spec = zipf_spec(rng, "wcoo", 3 * 16384 + 100, 384, 60000)
    out = pool.run(ranks.packings, "wcoo", spec, 4)
    stacked = js._prep_wcoo_shards(jax_op(("coo",) + spec[1:]), np.zeros(spec[1]),
                                   jmesh(4), "rows")[0]
    for calls, packs, (r,) in out:
        assert calls == ["wcoo"]  # this rank's shard, once
        assert_same_pack(packs[0], jax.tree_util.tree_map(lambda a: a[r], stacked))


def test_rwcoo_shards_pack_as_jax(pool, rng):
    spec = zipf_spec(rng, "rwcoo", 4 * 4096 + 50, 12000, 30000)
    out = pool.run(ranks.packings, "rwcoo", spec, 4)
    _, m, n, vals, rows, cols = spec
    from lsqr_tpu.ops.rwcoo import rwcoo_operator

    jh, jc, hotmap, _, _ = js._prep_rwcoo_shards(rwcoo_operator(m, n, vals, rows, cols),
                                                 np.zeros(m), jmesh(4), "rows")
    for calls, packs, (r,) in out:
        assert calls == ["wcoo", "wwcoo"]
        assert_same_pack(packs[0], jax.tree_util.tree_map(lambda a: a[r], jh))
        assert_same_pack(packs[1], jax.tree_util.tree_map(lambda a: a[r], jc))


@pytest.mark.parametrize("wide,shape", [(False, (2, 2)), (True, (2, 2)), (True, (1, 4))])
def test_2d_blocks_pack_once_as_jax(pool, rng, wide, shape):
    """Each block is planned on every rank and packed once, by its rank, to
    the shape JAX's forced second packing gives it."""
    n = 24000 if wide else 6000
    spec = (zipf_spec(rng, "coo", 2 * 8192 + 30, n, 30000) if wide
            else uniform_spec(rng, 2 * 8192 + 30, n, 200000))
    out = pool.run(ranks.packings, "wwcoo_2d" if wide else "wcoo_2d", spec, shape)
    A = jax_op(spec)
    grid = (js._shard_wwcoo_2d if wide else js._shard_wcoo_2d)(A, *shape)[0]
    for calls, packs, (r, c) in out:
        assert calls == ["wwcoo" if wide else "wcoo"]
        assert_same_pack(packs[0], jax.tree_util.tree_map(lambda a: a[r, c], grid))


SOLVERS = (("lsqr", (0.3,)), ("lsmr", (0.3,)), ("cgls", (0.3,)), ("craig", ()))


def fixed_kw(solver, itnlim):
    return dict(atol=0.0, btol=0.0, itnlim=itnlim,
                **({"conlim": 0.0} if solver in ("lsqr", "lsmr") else {}))


def assert_f32_x(got, ref, rtol=1e-5):
    """f32 iterates at a fixed itn: max |got - ref| / max |ref|."""
    ref = np.asarray(ref, np.float64)
    assert np.abs(np.asarray(got, np.float64) - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["wcoo", "rwcoo"])
def test_sharded_packed_rows_solves(pool, rng, kind):
    """The four solvers on WCOO and RWCOO row shards (the pair route, as on
    the card) at a fixed itn, against JAX's and the port's unsharded solves.
    The Zipf columns carry a boosted diagonal: on the plain Zipf pattern the
    f32 iterates part by percents between any two product roundings (the
    port's own unsharded solves with and without the pair included), so
    only a well-conditioned problem holds x."""
    m, n, nnz = {"wcoo": (3 * 16384 + 100, 384, 60000),
                 "rwcoo": (4 * 4096 + 50, 12000, 30000)}[kind]
    spec = zipf_spec(rng, kind, m, n, nnz, boost=100.0)
    b = consistent(spec, rng)  # CRAIG's systems are consistent
    for solver, args in SOLVERS:
        kw = fixed_kw(solver, 8)
        res = run(pool, f"{solver}_sharded_{kind}", spec, b, 4, *args, **kw)
        ref = jax_plain(spec, b, *args, solver=solver, **kw)
        own = getattr(lt, solver)(port_op(spec), torch.from_numpy(b), *args, pair=True, **kw)
        assert int(res["itn"]) == int(ref.itn) == int(own.itn), solver
        assert_f32_x(res["x"], ref.x)
        assert_f32_x(res["x"], own.x.numpy())


def test_sharded_rwcoo_names_the_shard_it_cannot_pack(pool, rng):
    """A shard whose hot panel spans too many rows in one subtile (rows far
    apart) is refused by the WCOO packer: every rank raises, naming it (the
    JAX package let the error escape from the middle of its packing)."""
    m, n = 4 * 16384, 5000
    dense_rows = np.repeat(np.arange(0, 16384), 4)           # shard 0: packed tight
    sparse_rows = 3 * 16384 + 16 * np.arange(1024)           # shard 3: one row in 16
    rows = np.concatenate([dense_rows, sparse_rows])
    cols = np.concatenate([rng.integers(0, 100, dense_rows.size),
                           rng.integers(0, 100, sparse_rows.size)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    spec = ("coo", m, n, vals, rows, cols)
    errors = pool.run(ranks.solve_error, "lsqr_sharded_rwcoo", spec,
                      np.ones(m, np.float32), 4)
    for e in errors:
        assert e is not None and e[0] == "WCOOPackError", e
        assert "shard" in e[1] and "lsqr_sharded" in e[1]


@pytest.mark.parametrize("wide,shape", [(False, (2, 2)), (True, (1, 4))])
def test_sharded_packed_2d_solves(pool, rng, wide, shape):
    n = 24000 if wide else 6000
    spec = (zipf_spec(rng, "coo", 2 * 8192 + 30, n, 30000, boost=100.0) if wide
            else uniform_spec(rng, 2 * 8192 + 30, n, 200000, boost=100.0))
    b = consistent(spec, rng)
    kw = dict(FIXED, itnlim=8)
    entry = "lsqr_sharded_wwcoo_2d" if wide else "lsqr_sharded_wcoo_2d"
    res = run(pool, entry, spec, b, shape, 0.3, **kw)
    assert res["x"].shape == (n,)
    ref = jax_plain(spec, b, 0.3, **kw)
    assert int(res["itn"]) == int(ref.itn)
    assert_f32_x(res["x"], ref.x)
    np.testing.assert_allclose(res["rnorm"], float(ref.rnorm), rtol=1e-4)


# ---------------------------------------------------------------------------
# the restored WWCOO knobs and the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("force", [
    dict(force_kb=3, force_js_extra=8, force_w_extra=5),
    dict(force_emax_extra=1024, force_w_extra=64),
])
def test_wwcoo_forced_pack_matches_jax_byte_for_byte(rng, force):
    from lsqr_tpu.ops.wwcoo import wwcoo_pack as j_wwcoo_pack
    from lsqr_tpu_torch.ops.wwcoo import wwcoo_pack_arrays, wwcoo_plan

    _, m, n, vals, rows, cols = zipf_spec(rng, "coo", 40000, 20000, 120000)
    plan = wwcoo_plan(m, n, rows, cols)
    kw = dict(force_emax=plan["emax"] + force.get("force_emax_extra", 0),
              force_js=plan["js"] + force.get("force_js_extra", 0),
              force_w=plan["w"] + force["force_w_extra"])
    if "force_kb" in force:
        kw["force_kb"] = force["force_kb"]
    assert_same_pack(wwcoo_pack_arrays(m, n, vals, rows, cols, **kw),
                     j_wwcoo_pack(m, n, vals, rows, cols, **kw))


def test_packers_refuse_below_their_plan(rng):
    from lsqr_tpu_torch.ops.wwcoo import WWCOOPackError, wwcoo_pack_arrays, wwcoo_plan

    _, m, n, vals, rows, cols = zipf_spec(rng, "coo", 40000, 20000, 120000)
    plan = wwcoo_plan(m, n, rows, cols)
    for knob, value in (("force_emax", plan["emax"] - 1024), ("force_js", plan["js"] - 1),
                        ("force_w", plan["w"] - 1)):
        with pytest.raises(WWCOOPackError, match="forced"):
            wwcoo_pack_arrays(m, n, vals, rows, cols, **{knob: value})


@pytest.mark.parametrize("pattern", ["uniform", "zipf", "one_entry", "ragged"])
def test_plans_equal_the_packings_statics(rng, pattern):
    from lsqr_tpu_torch.ops.wcoo import wcoo_pack_arrays, wcoo_plan
    from lsqr_tpu_torch.ops.wwcoo import wwcoo_pack_arrays, wwcoo_plan

    m, n = {"uniform": (40000, 3000), "zipf": (70000, 3000), "one_entry": (16384, 3000),
            "ragged": (5000, 4000)}[pattern]
    if pattern == "zipf":
        _, m, n, vals, rows, cols = zipf_spec(rng, "coo", m, n, 300000)
    else:
        nnz = {"uniform": 200000, "one_entry": 1, "ragged": 40000}[pattern]
        rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
        vals = rng.standard_normal(nnz).astype(np.float32)
    _, meta = wcoo_pack_arrays(m, n, vals, rows, cols)
    assert wcoo_plan(m, n, rows, cols) == dict(emax=meta["eb"] * 1024, kb=meta["kb"],
                                               ku=meta["ku"])
    _, meta = wwcoo_pack_arrays(m, n, vals, rows, cols)
    assert wwcoo_plan(m, n, rows, cols) == dict(
        emax=meta["eb"] * 1024, kb=meta["kb"], js=meta["js"],
        w=max(meta[k] for k in ("wc", "wf", "wu", "wm", "wz")))


def test_unsharded_solves_take_no_collective(rng, monkeypatch):
    """With no process group on the operator nothing is all-reduced."""
    import torch.distributed as dist

    def refuse(*a, **kw):
        raise AssertionError("an unsharded solve ran a collective")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    spec = coo_spec(rng, 60, 30, 300)
    b = torch.from_numpy(rng.standard_normal(60))
    A = port_op(spec)
    for fn in (lt.lsqr, lt.lsmr, lt.cgls):
        fn(A, b, 0.1, itnlim=5)
    lt.craig(A, b, itnlim=5)
    lt.lsqr_multidamp(A, b, [0.0, 0.1], itnlim=5)
    assert A.axis_name_m is None and A.axis_name_n is None
