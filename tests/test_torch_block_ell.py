"""The port's BlockELL path against the JAX package: the block packing byte
for byte (native and numpy), the three kernel twins against the Pallas
kernels in interpret mode (block_ell_matvec, block_ell_matvec_windowed with
tr in {1, 8}, block_ell_pair_windowed), the operator's products and pair,
``operator_from_arrays("block_ell")`` and solves with the pair off and on.

Inputs come from numpy seeds and go through both packages. JAX runs on the
CPU in x64, the port on the CPU through its plain twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu.native as jnative
import lsqr_tpu_torch as lt
import lsqr_tpu_torch.native as tnative
from lsqr_tpu.ops.pallas_spmv import (block_ell_matvec as j_matvec,
                                      block_ell_matvec_windowed as j_windowed,
                                      block_ell_pair_windowed as j_pair)
from lsqr_tpu.ops.structured import block_ell_operator as j_block_ell_operator
from lsqr_tpu_torch.models.synthetic import random_block_coo
from lsqr_tpu_torch.ops import spmv_sparse

from _torch_parity import DEV, rel_err, to_np

# f32 twins against the interpreted kernels: summation order only
TOL = dict(rtol=2e-5, atol=2e-5)
# (m, n, block, blocks per block row): square, ragged and rectangular
SHAPES = [(512, 512, 32, 3), (500, 380, 32, 3), (300, 700, 16, 4)]


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_LIB", False)
        monkeypatch.setattr(tnative, "_LIB", False)
    else:
        assert tnative.available() and jnative.available()
    return request.param


def _pattern(m, n, block, per_row, dtype=np.float32, seed=0, diag=0.0):
    return random_block_coo(m, n, block=block, per_row=per_row, dtype=dtype, seed=seed,
                            diag=diag)


@pytest.mark.parametrize("m,n,block,per_row", SHAPES)
def test_block_pack_equals_jax(packer, m, n, block, per_row):
    vals, rows, cols = _pattern(m, n, block, per_row, seed=m)
    mb, nb = -(-m // block), -(-n // block)
    for args in ((rows, cols, vals, mb, block, block, max(mb, nb)),
                 (cols, rows, vals, nb, block, block, max(mb, nb))):
        bj, cj = jnative.block_pack(*args)
        bt, ct = tnative.block_pack(*args)
        assert bj.dtype == bt.dtype and bj.shape == bt.shape
        assert bj.tobytes() == bt.tobytes() and cj.tobytes() == ct.tobytes()


def test_block_pack_refuses_what_jax_refuses():
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 2048, 500), rng.integers(0, 2048, 500)
    vals = rng.standard_normal(500)
    with pytest.raises(ValueError, match="not blocky"):
        jnative.block_pack(rows, cols, vals, 16, 128, 128, 16)
    with pytest.raises(ValueError, match="not blocky"):
        tnative.block_pack(rows, cols, vals, 16, 128, 128, 16)


def _jax_operator(m, n, block, per_row, dtype=np.float32, seed=0, diag=0.0):
    vals, rows, cols = _pattern(m, n, block, per_row, dtype, seed, diag)
    return (vals, rows, cols), j_block_ell_operator(m, n, vals, rows, cols,
                                                    block=(block, block))


@pytest.mark.parametrize("m,n,block,per_row", SHAPES)
def test_block_ell_twins_match_jax_kernels(rng, m, n, block, per_row):
    """Rows 12-14: each twin against its Pallas kernel in interpret mode, on
    JAX's own packing, forward (blocks) and adjoint (tblocks)."""
    _, A = _jax_operator(m, n, block, per_row, seed=n)
    mb, kb = A.bcols.shape
    nb = A.tblocks.shape[0]
    x = rng.standard_normal(nb * block).astype(np.float32)
    y = rng.standard_normal(mb * block).astype(np.float32)
    for blocks, bcols, vec in ((A.blocks, A.bcols, x), (A.tblocks, A.tbrows, y)):
        tb, tc, tv = _t(np.asarray(blocks)), _t(np.asarray(bcols)), _t(vec)
        got = spmv_sparse.block_ell_matvec(tb, tc, tv)
        ref = np.asarray(j_matvec(blocks, bcols, jnp.asarray(vec), interpret=True))
        np.testing.assert_allclose(to_np(got), ref, **TOL)
        for tr in (1, 8):
            ref = np.asarray(j_windowed(blocks, bcols, jnp.asarray(vec), interpret=True,
                                        tr=tr))
            got = spmv_sparse.block_ell_matvec_windowed(tb, tc, tv, tr=tr)
            np.testing.assert_allclose(to_np(got), ref, **TOL)
    u_j, zp_j = j_pair(A.blocks, A.bcols, jnp.asarray(x), jnp.asarray(y), 0.7, -1.3,
                       interpret=True)
    u_t, zp_t = spmv_sparse.block_ell_pair_windowed(
        _t(np.asarray(A.blocks)), _t(np.asarray(A.bcols)), _t(x), _t(y), 0.7, -1.3)
    assert zp_t.shape == (mb, kb, block)
    np.testing.assert_allclose(to_np(u_t), np.asarray(u_j), **TOL)
    np.testing.assert_allclose(to_np(zp_t), np.asarray(zp_j), **TOL)


@pytest.mark.parametrize("m,n,block,per_row", SHAPES)
def test_block_ell_f64_operator_matches_jax(rng, m, n, block, per_row):
    (vals, rows, cols), Aj = _jax_operator(m, n, block, per_row, np.float64, seed=3)
    At = lt.block_ell_operator(m, n, vals, rows, cols, block=(block, block), device=DEV)
    assert At.dtype == torch.float64 and (At.kb, At.kt) == (Aj.bcols.shape[1],
                                                            Aj.tbrows.shape[1])
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    assert rel_err(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) < 1e-13
    assert rel_err(At.rmatvec(_t(y)), Aj.rmatvec(jnp.asarray(y))) < 1e-13
    u_t, z_t = At.fused_pair(y=_t(y), win=_t(x), c1=0.5, c2=2.0)
    u_j, z_j = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=0.5, c2=2.0)
    assert rel_err(u_t, u_j) < 1e-13 and rel_err(z_t, z_j) < 1e-13
    np.testing.assert_array_equal(to_np(At.todense()), np.asarray(Aj.todense()))
    assert not At.prefers_pair


def test_block_ell_f32_operator_and_from_arrays_match_jax(rng):
    m, n, block = 600, 520, 32
    _, Aj = _jax_operator(m, n, block, 3, seed=4)
    At = lt.operator_from_arrays(
        "block_ell", {k: np.asarray(getattr(Aj, k)) for k in ("blocks", "bcols", "tblocks",
                                                              "tbrows")},
        {"m": m, "n": n}, device=DEV)
    assert isinstance(At, lt.BlockELLOperator) and At.dtype == torch.float32
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(to_np(At.matvec(_t(x))), np.asarray(Aj.matvec(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(to_np(At.rmatvec(_t(y))),
                               np.asarray(Aj.rmatvec(jnp.asarray(y))), **TOL)
    u_t, z_t = At.fused_pair(y=_t(y), win=_t(x), c1=0.5, c2=2.0)
    u_j, z_j = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=0.5, c2=2.0)
    np.testing.assert_allclose(to_np(u_t), np.asarray(u_j), **TOL)
    np.testing.assert_allclose(to_np(z_t), np.asarray(z_j), **TOL)


@pytest.mark.parametrize("m,n,block,per_row", [(600, 130, 16, 3), (512, 512, 32, 3)])
def test_block_ell_pair_block_column_sums_match_jax(rng, m, n, block, per_row):
    """The pair's z, the per-block partials summed by block column in the
    order built with the operator (a tall pattern puts many blocks in each
    block column), against JAX's pair and the transpose product."""
    (vals, rows, cols), Aj = _jax_operator(m, n, block, per_row, np.float32, seed=4)
    At = lt.block_ell_operator(m, n, vals, rows, cols, block=(block, block), device=DEV)
    kb = At.kb
    bcols = to_np(At.bcols).ravel()
    order = to_np(At.zorder)
    np.testing.assert_array_equal(order, np.argsort(bcols, kind="stable"))
    np.testing.assert_array_equal(np.diff(to_np(At.zoffsets)),
                                  np.bincount(bcols, minlength=At.tblocks.shape[0]))
    assert At.kt > kb
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    u_t, z_t = At.fused_pair(y=_t(y), win=_t(x), c1=0.5, c2=2.0)
    u_j, z_j = Aj.fused_pair(y=jnp.asarray(y), win=jnp.asarray(x), c1=0.5, c2=2.0)
    np.testing.assert_allclose(to_np(z_t), np.asarray(z_j), **TOL)
    np.testing.assert_allclose(to_np(z_t), to_np(At.rmatvec(u_t)), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pair", [False, True])
def test_block_ell_solve_matches_jax(rng, dtype, pair):
    m, n, block = 640, 512, 32
    (vals, rows, cols), Aj = _jax_operator(m, n, block, 3, dtype, seed=9, diag=2.0)
    At = lt.block_ell_operator(m, n, vals, rows, cols, block=(block, block), device=DEV)
    b = rng.standard_normal(m).astype(dtype)
    kw = dict(atol=1e-6, btol=1e-6) if dtype == np.float32 else dict(atol=1e-10, btol=1e-10)
    rj = lj.lsqr(Aj, jnp.asarray(b), 0.01, pair=pair, **kw)
    rt = lt.lsqr(At, _t(b), 0.01, pair=pair, **kw)
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= 2
    if dtype == np.float32:
        np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-8, atol=1e-8)


def test_windowed_tile_rule():
    # JAX's default (8, or 1 below 8 block rows), lowered until it divides mb
    assert spmv_sparse.windowed_rows_per_tile(64, 3, 128) == 8
    assert spmv_sparse.windowed_rows_per_tile(6, 3, 128) == 1
    assert spmv_sparse.windowed_rows_per_tile(12, 3, 128) == 6
    # and until the two x-segment buffers fit the shared-memory window
    assert spmv_sparse.windowed_rows_per_tile(64, 24, 128) == 4
    assert spmv_sparse.windowed_rows_per_tile(64, 200, 128) == 0
    assert spmv_sparse.pair_keeps_blocks(3, 128, 128)
    assert not spmv_sparse.pair_keeps_blocks(4, 128, 128)


def test_block_ell_routes_each_packing_by_its_window(rng, monkeypatch):
    """On the card each packing takes the windowed kernel where one block
    row's x segments fit its window, else block_ell_matvec: the transpose
    of a tall pattern (kt = 100 > 96 at 128-wide blocks) takes the latter.
    Here the kernels' routing runs with the twins in their place."""
    from lsqr_tpu_torch.ops import structured

    m, n = 12_700, 100
    vals, rows, cols = _pattern(m, n, 128, 1, dtype=np.float64, seed=3)
    At = lt.block_ell_operator(m, n, vals, rows, cols, device=DEV)
    assert (At.kb, At.kt) == (1, 100)
    took = []
    for name in ("block_ell_matvec", "block_ell_matvec_windowed"):
        monkeypatch.setattr(structured, name, lambda *a, name=name: (
            took.append(name), spmv_sparse.block_ell_matvec_plain(*a))[1])
    monkeypatch.setattr(lt.BlockELLOperator, "_kernels", lambda self: True)
    dense = to_np(At.todense())
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    np.testing.assert_allclose(to_np(At.matvec(_t(x))), dense @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(At.rmatvec(_t(y))), dense.T @ y, rtol=1e-12,
                               atol=1e-12)
    assert took == ["block_ell_matvec_windowed", "block_ell_matvec"]
