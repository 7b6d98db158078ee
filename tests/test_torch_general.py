"""The port's general-sparsity path against the JAX package: the default
device, ELL, HYB, ``SumOperator``, ``csr_operator``, ``from_scipy``'s "ell"
and "block", ``auto_operator``'s routes, the reordering planner and the
host packer.

Inputs come from numpy seeds and go through both packages. JAX runs on the
CPU in x64, the port on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import lsqr_tpu as lj
import lsqr_tpu.native as jnative
import lsqr_tpu_torch as lt
import lsqr_tpu_torch.native as tnative
from lsqr_tpu.ops.reorder import plan_general as j_plan_general
from lsqr_tpu.ops.reorder import solve_general as j_solve_general
from lsqr_tpu.ops.structured import hyb_operator as j_hyb_operator
from lsqr_tpu_torch.models.synthetic import jittered_band_coo, random_block_coo, zipf_coo
from lsqr_tpu_torch.ops.interop import _block_fill_ratio

from _torch_parity import DEV, banded, banded_triplets, rel_err, to_np


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _uniform(rng, m, n, nnz, dtype=np.float64):
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return rng.standard_normal(first.size).astype(dtype), rows[first], cols[first]


def _products_match(At, Aj, rng, tol=1e-13):
    x = rng.standard_normal(At.n)
    y = rng.standard_normal(At.m)
    assert rel_err(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) < tol
    assert rel_err(At.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y))) < tol


# ---------------------------------------------------------------------------
# The default device
# ---------------------------------------------------------------------------


def test_resolve_device_defaults_to_the_card():
    assert lt.resolve_device(None) == torch.device("cuda")
    assert lt.resolve_device("cpu") == torch.device("cpu")
    assert lt.resolve_device(torch.device("cuda", 0)) == torch.device("cuda", 0)


BUILDERS = {
    "coo_operator": lambda v, r, c: lt.coo_operator(40, 30, v, r, c),
    "auto_operator": lambda v, r, c: lt.auto_operator(40, 30, v, r, c),
    "jdia_operator": lambda v, r, c: lt.jdia_operator(40, 30, v, r, c),
    "ell_operator": lambda v, r, c: lt.ell_operator(40, 30, v, r, c),
    "block_ell_operator": lambda v, r, c: lt.block_ell_operator(40, 30, v, r, c,
                                                                block=(8, 8)),
    "csr_operator": lambda v, r, c: lt.csr_operator(
        40, 30, *(lambda s: (s.indptr, s.indices, s.data))(
            scipy.sparse.csr_matrix((v, (r, c)), shape=(40, 30)))),
    "from_scipy": lambda v, r, c: lt.from_scipy(
        scipy.sparse.coo_matrix((v, (r, c)), shape=(40, 30))),
    "dia_operator": lambda v, r, c: lt.dia_operator(40, 30, (0,), np.ones((1, 40))),
    "LSQRSolver": lambda v, r, c: lt.LSQRSolver(40, 30, v, r, c),
    "lstp": lambda v, r, c: lt.lstp(40, 30, 2, 2, 0.0),
    "banded_problem": lambda v, r, c: lt.banded_problem(40, 30, 1),
    "as_operator": lambda v, r, c: lt.as_operator(np.eye(3)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_default_to_the_card(rng, name):
    """device=None builds on the card: with one, the operator lands there;
    on a CPU-only host the build raises instead of falling back."""
    vals, rows, cols = _uniform(rng, 40, 30, 120)
    if torch.cuda.is_available():
        built = BUILDERS[name](vals, rows, cols)
        op = built[0] if isinstance(built, tuple) else getattr(built, "op", built)
        op = getattr(op, "A", op)
        assert op.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            BUILDERS[name](vals, rows, cols)


def test_placed_tensors_stay_where_they_are(rng):
    vals, rows, cols = _uniform(rng, 40, 30, 120)
    A = lt.coo_operator(40, 30, _t(vals), rows, cols)
    assert A.device == torch.device("cpu")
    assert lt.auto_operator(40, 30, _t(vals), rows, cols).device == torch.device("cpu")
    assert lt.as_operator(torch.eye(3)).device == torch.device("cpu")


def test_block_banded_coo_stays_numpy_without_device():
    vals, rows, cols = lt.block_banded_coo(64, 64, 16, 1)
    assert all(isinstance(a, np.ndarray) for a in (vals, rows, cols))


# ---------------------------------------------------------------------------
# ELL, HYB, SumOperator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_ell_pack_and_products_match_jax(rng, monkeypatch, impl):
    if impl == "numpy":
        monkeypatch.setattr(jnative, "_LIB", False)
        monkeypatch.setattr(tnative, "_LIB", False)
    m, n = 300, 250
    vals, rows, cols = _uniform(rng, m, n, 1500)
    for a, b in zip(jnative.ell_pack(rows, cols, vals, m), tnative.ell_pack(rows, cols, vals, m)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    Aj = lj.ops.structured.ell_operator(m, n, vals, rows, cols)
    At = lt.ell_operator(m, n, vals, rows, cols, device=DEV)
    assert At.nnz == Aj.nnz and At.dtype == torch.float64
    _products_match(At, Aj, rng)
    np.testing.assert_array_equal(to_np(At.todense()), np.asarray(Aj.todense()))


@pytest.mark.parametrize("kind", ["zipf", "uniform", "one_dense_row"])
def test_hyb_picks_jax_width_and_products(rng, kind):
    m, n = 3000, 2500
    if kind == "zipf":
        vals, rows, cols = zipf_coo(m, n, dtype=np.float64, seed=2)
    elif kind == "uniform":
        vals, rows, cols = _uniform(rng, m, n, 4000)
    else:
        vals, rows, cols = _uniform(rng, m, n, 2000)
        rows = np.concatenate([rows, np.zeros(n, np.int64)])
        cols = np.concatenate([cols, np.arange(n)])
        rows, cols, vals = tnative.coo_dedup(rows, cols, np.concatenate(
            [vals, rng.standard_normal(n)]))
    Aj = j_hyb_operator(m, n, vals, rows, cols)
    At = lt.hyb_operator(m, n, vals, rows, cols, device=DEV)
    assert type(At).__name__ == type(Aj).__name__
    ell_j = Aj.ops[0] if hasattr(Aj, "ops") else Aj
    ell_t = At.ops[0] if hasattr(At, "ops") else At
    assert ell_t.vals.shape == tuple(ell_j.vals.shape)   # the same width
    if hasattr(Aj, "ops"):
        assert isinstance(At, lt.SumOperator) and At.ops[1].nnz == Aj.ops[1].nnz
    _products_match(At, Aj, rng)
    np.testing.assert_allclose(to_np(At.todense()), np.asarray(Aj.todense()), atol=1e-14)


def test_sum_operator_matches_jax(rng):
    m, n = 200, 150
    parts = [_uniform(rng, m, n, 500), _uniform(rng, m, n, 300)]
    Aj = lj.ops.compose.add_operators([lj.coo_operator(m, n, *p) for p in parts])
    At = lt.add_operators([lt.coo_operator(m, n, *p, device=DEV) for p in parts])
    assert isinstance(At, lt.SumOperator) and At.nnz == Aj.nnz and At.device == DEV
    _products_match(At, Aj, rng)
    with pytest.raises(ValueError, match="share"):
        lt.add_operators([lt.coo_operator(m, n, *parts[0], device=DEV),
                          lt.coo_operator(m, n + 1, *parts[1], device=DEV)])
    with pytest.raises(ValueError, match="at least one"):
        lt.add_operators([])


def test_hyb_from_arrays_matches_jax(rng):
    m, n = 3000, 2500
    vals, rows, cols = zipf_coo(m, n, dtype=np.float64, seed=5)
    Aj = j_hyb_operator(m, n, vals, rows, cols)
    E, C = Aj.ops
    arrays = {k: np.asarray(getattr(E, k)) for k in ("vals", "cols", "tvals", "trows")}
    At_ell = lt.operator_from_arrays("ell", arrays, {"m": m, "n": n}, device=DEV)
    _products_match(At_ell, E, rng)
    arrays.update(coo_vals=np.asarray(C.vals), coo_rows=np.asarray(C.rows),
                  coo_cols=np.asarray(C.cols))
    At = lt.operator_from_arrays("hyb", arrays, {"m": m, "n": n}, device=DEV)
    assert isinstance(At, lt.SumOperator)
    _products_match(At, Aj, rng)


# ---------------------------------------------------------------------------
# csr_operator, from_scipy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["ell", "coo", "block"])
def test_csr_operator_matches_jax(rng, fmt):
    m, n = 512, 384
    vals, rows, cols = random_block_coo(m, n, block=32, per_row=2, dtype=np.float64)
    S = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(m, n))
    kw = dict(format=fmt)
    Aj = lj.csr_operator(m, n, S.indptr, S.indices, S.data, **kw)
    At = lt.csr_operator(m, n, S.indptr, S.indices, S.data, device=DEV, **kw)
    assert type(At).__name__ == type(Aj).__name__
    _products_match(At, Aj, rng)
    with pytest.raises(ValueError, match="unknown format"):
        lt.csr_operator(m, n, S.indptr, S.indices, S.data, format="dia", device=DEV)


@pytest.mark.parametrize("fmt", ["ell", "block"])
def test_from_scipy_ell_and_block_match_jax(rng, fmt):
    vals, rows, cols = random_block_coo(700, 600, block=64, per_row=2, dtype=np.float64)
    S = scipy.sparse.csc_matrix((vals, (rows, cols)), shape=(700, 600))
    Aj = lj.from_scipy(S, format=fmt)
    At = lt.from_scipy(S, format=fmt, device=DEV)
    assert type(At).__name__ == type(Aj).__name__ == {"ell": "ELLOperator",
                                                      "block": "BlockELLOperator"}[fmt]
    _products_match(At, Aj, rng)
    assert rel_err(At.matvec(_t(np.ones(600))), S @ np.ones(600)) < 1e-13


# ---------------------------------------------------------------------------
# auto_operator's routes
# ---------------------------------------------------------------------------


def _routes():
    """(name, m, n, vals, rows, cols) of patterns the JAX package sends to
    each of its routes."""
    rng = np.random.default_rng(7)
    data, _ = banded(rng, 900, 800, (-3, 0, 4), np.float64, dense=False)
    yield ("banded", 900, 800, *banded_triplets(data, (-3, 0, 4), 800))
    yield ("jittered", 3000, 2600, *jittered_band_coo(3000, 2600, seed=1, dtype=np.float64))
    yield ("jittered_f32", 3000, 3000, *jittered_band_coo(3000, 3000, seed=2))
    yield ("blocky", 1024, 896, *random_block_coo(1024, 896, block=128, per_row=2,
                                                   dtype=np.float64))
    yield ("power_law", 3000, 3000, *zipf_coo(3000, 3000, dtype=np.float64, seed=3))
    yield ("uniform_f32_small", 2000, 2000, *_uniform(rng, 2000, 2000, 5000, np.float32))


@pytest.mark.parametrize("case", list(_routes()), ids=lambda c: c[0])
def test_auto_operator_picks_jax_format(rng, case):
    name, m, n, vals, rows, cols = case
    Aj = lj.auto_operator(m, n, vals, rows, cols)
    At = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert type(At).__name__ == type(Aj).__name__
    assert type(At).__name__ == {"banded": "DIAOperator", "jittered": "JDIAOperator",
                                 "jittered_f32": "JDIAOperator",
                                 "blocky": "BlockELLOperator", "power_law": "SumOperator",
                                 "uniform_f32_small": "SumOperator"}[name]
    if isinstance(At, lt.JDIAOperator):
        assert At.fit_fraction == Aj.fit_fraction >= 0.95
    tol = 1e-13 if vals.dtype == np.float64 else 2e-6
    _products_match(At, Aj, rng, tol)


def test_auto_operator_raises_device_faults_of_the_jdia_step(monkeypatch):
    """Step 2 passes on only the packer's refusals: a fault while the JDIA
    arrays move to the device (here an out-of-memory error) reaches the
    caller instead of turning into another format."""
    from lsqr_tpu_torch.ops import interop

    def out_of_memory(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (simulated)")

    vals, rows, cols = jittered_band_coo(3000, 3000, seed=2)
    assert isinstance(lt.auto_operator(3000, 3000, vals, rows, cols, device=DEV),
                      lt.JDIAOperator)
    monkeypatch.setattr(interop, "from_packing", out_of_memory)
    with pytest.raises(torch.OutOfMemoryError):
        lt.auto_operator(3000, 3000, vals, rows, cols, device=DEV)


def test_auto_operator_raises_where_jax_picks_wcoo_or_rwcoo(rng):
    """Step 3 is ported: where JAX picks WCOO or RWCOO, so does the port."""
    from lsqr_tpu.ops.rwcoo import RWCOOOperator
    from lsqr_tpu.ops.wcoo import WCOOOperator

    m = 16384
    for n, nnz, expected in ((2048, 40000, WCOOOperator), (8192, 60000, RWCOOOperator)):
        vals, rows, cols = _uniform(rng, m, n, nnz, np.float32)
        assert _block_fill_ratio(rows, cols, m, n) > 4.0
        assert isinstance(lj.auto_operator(m, n, vals, rows, cols), expected)
        At = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
        assert type(At).__name__ == expected.__name__
        x = rng.standard_normal(n).astype(np.float32)
        assert rel_err(At.matvec(_t(x)), scipy.sparse.coo_matrix(
            (vals, (rows, cols)), shape=(m, n)) @ x) < 1e-5
    # the same tall pattern in f64 is no step-3 case: HYB in both packages
    vals, rows, cols = _uniform(rng, m, 2048, 40000)
    assert type(lt.auto_operator(m, 2048, vals, rows, cols, device=DEV)).__name__ == \
        type(lj.auto_operator(m, 2048, vals, rows, cols)).__name__


# ---------------------------------------------------------------------------
# The reordering planner
# ---------------------------------------------------------------------------


def _scrambled(m, n, seed, dtype=np.float64):
    vals, rows, cols = jittered_band_coo(m, n, seed=seed, dtype=dtype, diag=12.0)
    rng = np.random.default_rng(seed)
    rp, cp = rng.permutation(m), rng.permutation(n)
    return vals, rp[rows], cp[cols], rp, cp


@pytest.mark.parametrize("reorder", [None, True, False])
def test_plan_general_matches_jax(reorder):
    m, n = 16384, 15000
    vals, rows, cols, _, _ = _scrambled(m, n, 4)
    pj = j_plan_general(m, n, vals, rows, cols, reorder=reorder)
    pt = lt.plan_general(m, n, vals, rows, cols, reorder=reorder, device=DEV)
    assert type(pt.op).__name__ == type(pj.op).__name__
    np.testing.assert_array_equal(pt.row_order, pj.row_order)
    np.testing.assert_array_equal(pt.col_order, pj.col_order)
    if reorder is None:  # the scrambled pattern is worth reordering
        assert not np.array_equal(pt.row_order, np.arange(m))
        assert isinstance(pt.op, lt.JDIAOperator) and pt.op.fit_fraction >= 0.95


def test_plan_general_reorders_past_the_unported_route():
    """f32 at n <= 262,144: the scrambled order takes RWCOO in both packages
    (scored 0 by the planner); the reordered JDIA wins in both."""
    m = n = 16384
    vals, rows, cols, _, _ = _scrambled(m, n, 4, np.float32)
    assert type(lt.auto_operator(m, n, vals, rows, cols, device=DEV)).__name__ == \
        type(lj.auto_operator(m, n, vals, rows, cols)).__name__ == "RWCOOOperator"
    pj = j_plan_general(m, n, vals, rows, cols)
    pt = lt.plan_general(m, n, vals, rows, cols, device=DEV)
    assert type(pt.op).__name__ == type(pj.op).__name__ == "JDIAOperator"
    np.testing.assert_array_equal(pt.row_order, pj.row_order)
    # reorder=False keeps the scrambled order's RWCOO, as in JAX
    pt = lt.plan_general(m, n, vals, rows, cols, reorder=False, device=DEV)
    assert type(pt.op).__name__ == type(j_plan_general(m, n, vals, rows, cols,
                                                       reorder=False).op).__name__


def test_bandwidth_orders_match_jax():
    from lsqr_tpu.ops.reorder import bandwidth_orders as j_orders

    vals, rows, cols, _, _ = _scrambled(800, 700, 6)
    for a, b in zip(lt.bandwidth_orders(800, 700, rows, cols),
                    j_orders(800, 700, rows, cols)):
        np.testing.assert_array_equal(a, b)
    ro, co = lt.bandwidth_orders(5, 4, [], [])
    np.testing.assert_array_equal(ro, np.arange(5))


def test_solve_general_matches_jax_and_unscrambled(rng):
    m, n = 1100, 900
    vals, rows, cols, rp, cp = _scrambled(m, n, 8)
    b = rng.standard_normal(m)
    kw = dict(atol=1e-10, btol=1e-10)
    rj = j_solve_general(m, n, vals, rows, cols, b, 0.01, **kw)
    rt = lt.solve_general(m, n, vals, rows, cols, _t(b), 0.01, device=DEV, **kw)
    assert int(rt.istop) == int(rj.istop) and abs(int(rt.itn) - int(rj.itn)) <= 2
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-8, atol=1e-8)
    # the unscrambled problem's solution, mapped back, is the same x
    plain = lt.lsqr(lt.auto_operator(m, n, vals, np.argsort(rp)[rows], np.argsort(cp)[cols],
                                     device=DEV), _t(b[rp]), 0.01, **kw)
    np.testing.assert_allclose(to_np(rt.x), to_np(plain.x)[np.argsort(cp)], rtol=1e-8,
                               atol=1e-8)
    plan = lt.plan_general(m, n, vals, rows, cols, device=DEV)
    assert plan.permute_b(b).device == plan.op.device
    assert plan.unpermute_x(plan.permute_b(np.arange(m, dtype=np.float64))[:n]).device == DEV


# ---------------------------------------------------------------------------
# The host packer
# ---------------------------------------------------------------------------


def test_native_packer_builds_into_the_build_dir():
    assert tnative.available()
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "lsqr_tpu_torch"
    assert path.parent.parent.name == "build"


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_native_dedup_and_csr_match_jax(rng, monkeypatch, impl):
    if impl == "numpy":
        monkeypatch.setattr(jnative, "_LIB", False)
        monkeypatch.setattr(tnative, "_LIB", False)
    rows, cols = rng.integers(0, 50, 400), rng.integers(0, 40, 400)
    vals = rng.standard_normal(400).astype(np.float32)
    for a, b in zip(jnative.coo_dedup(rows, cols, vals), tnative.coo_dedup(rows, cols, vals)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(jnative.csr_from_coo(rows, cols, vals, 50),
                    tnative.csr_from_coo(rows, cols, vals, 50)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
