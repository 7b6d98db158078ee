"""The port's BlockELL path against the JAX package: the block packing byte
for byte (native and numpy), the three kernel twins against the Pallas
kernels in interpret mode (block_ell_matvec, block_ell_matvec_windowed with
tr in {1, 8}, block_ell_pair_windowed), the products' work plan (long
block rows split into slices whose partial rows are added in order, held
against JAX's kernel), the operator's products and pair,
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
    # the pair's ranks keep their blocks in shared memory where they fit
    assert spmv_sparse.block_ell_pair_plan(3, 128, 128).keep
    assert not spmv_sparse.block_ell_pair_plan(4, 256, 256).keep


@pytest.mark.parametrize("mb,kb,bh,sms,slices", [
    (12, 164, 128, 132, 44),     # the tall transpose: 528 units for 132 SMs
    (600, 3, 128, 132, 1),       # the tall forward packing fills the card
    (2048, 10, 128, 132, 1),     # the 2^18 transpose
    (3, 40, 128, 132, 40),       # at most one slice a block
    (1, 7, 24, 4, 7),
    (5, 9, 16, 2, 2),            # uneven slices
    (7, 1, 32, 132, 1),          # one block a row: nothing to split
])
def test_block_ell_plan(mb, kb, bh, sms, slices):
    """The products' work plan: S slices of a block row's blocks, in order,
    without gaps or empty slices, S = 1 where mb already gives
    UNITS_PER_SM CTAs an SM, and mb*S*bh floats of scratch where S > 1."""
    plan = spmv_sparse.block_ell_plan(mb, kb, bh, sms)
    assert plan.slices == slices == len(plan.bounds)
    assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == kb
    assert all(a[1] == b[0] for a, b in zip(plan.bounds, plan.bounds[1:]))
    assert all(j1 - j0 >= kb // slices >= 1 for j0, j1 in plan.bounds)
    assert (slices == 1) == (mb >= spmv_sparse.UNITS_PER_SM * sms or kb <= 1)
    if slices > 1:
        assert mb * slices >= spmv_sparse.UNITS_PER_SM * sms or slices == kb
    assert plan.scratch == (mb * slices * bh if slices > 1 else 0)


@pytest.mark.parametrize("kb,bh,bw,smem,ranks,keep", [
    (3, 128, 128, spmv_sparse.PAIR_SMEM_BYTES, 3, True),   # the 2^18 packing: 67,072 bytes
    (1, 128, 128, spmv_sparse.PAIR_SMEM_BYTES, 1, True),   # one block a row: no partner
    (0, 16, 16, spmv_sparse.PAIR_SMEM_BYTES, 1, True),     # no blocks: u = -c2 y
    (10, 128, 128, spmv_sparse.PAIR_SMEM_BYTES, 8, True),  # groups of 1 and 2 blocks
    (40, 128, 128, spmv_sparse.PAIR_SMEM_BYTES, 8, False),  # 5 blocks a rank: read twice
    (164, 128, 128, spmv_sparse.PAIR_SMEM_BYTES, 8, False),
    (3, 256, 256, spmv_sparse.PAIR_SMEM_BYTES, 3, False),  # one block past shared memory
    (7, 24, 30, spmv_sparse.PAIR_SMEM_BYTES, 7, True),
    (3, 128, 128, 48 * 1024, 3, False),                    # a card with less shared memory
])
def test_block_ell_pair_plan(kb, bh, bw, smem, ranks, keep):
    """The pair's plan: one rank a block up to PAIR_MAX_RANKS, contiguous
    groups above, in order and without gaps or empty ranks (sizes differ
    by at most one); a rank keeps its blocks where they, their x segments,
    its partial u row and the u row fit ``smem``."""
    plan = spmv_sparse.block_ell_pair_plan(kb, bh, bw, smem)
    assert plan.ranks == ranks == len(plan.bounds)
    assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == kb
    for (_, b0), (a1, _) in zip(plan.bounds, plan.bounds[1:]):
        assert b0 == a1
    sizes = [b - a for a, b in plan.bounds]
    assert max(sizes) - min(sizes) <= 1 and (kb == 0 or min(sizes) >= 1)
    most = max(sizes)
    assert plan.keep == keep == (4 * (most * bh * bw + most * bw + 2 * bh) <= smem)


@pytest.mark.parametrize("side", ["forward", "transpose"])
def test_block_ell_pair_rank_partials_match_jax(rng, side):
    """The pair's twin, whose u adds the ranks' partial rows in rank order
    (kb > PAIR_MAX_RANKS: ranks of one and of several blocks; the forward
    packing: one block a row, kb = 1), against JAX's block_ell_pair_windowed
    in interpret mode, within TOL (summation order only)."""
    m, n, block = 1600, 48, 16
    _, A = _jax_operator(m, n, block, 1, seed=5)
    blocks, bcols = (A.blocks, A.bcols) if side == "forward" else (A.tblocks, A.tbrows)
    mb, kb = bcols.shape
    nb = (A.tblocks if side == "forward" else A.blocks).shape[0]
    plan = spmv_sparse.block_ell_pair_plan(kb, block, block)
    assert (kb, plan.ranks) == (1, 1) if side == "forward" else (
        kb > spmv_sparse.PAIR_MAX_RANKS and plan.ranks == spmv_sparse.PAIR_MAX_RANKS)
    x = rng.standard_normal(nb * block).astype(np.float32)
    y = rng.standard_normal(mb * block).astype(np.float32)
    u_j, zp_j = j_pair(blocks, bcols, jnp.asarray(x), jnp.asarray(y), 0.7, -1.3,
                       interpret=True)
    u_t, zp_t = spmv_sparse.block_ell_pair_plain(
        _t(np.asarray(blocks)), _t(np.asarray(bcols)), _t(x), _t(y), torch.tensor(0.7),
        torch.tensor(-1.3))
    np.testing.assert_allclose(to_np(u_t), np.asarray(u_j), **TOL)
    np.testing.assert_allclose(to_np(zp_t), np.asarray(zp_j), **TOL)


@pytest.mark.parametrize("sms", [132, 4])
def test_block_ell_slices_summed_in_order_match_jax(rng, sms):
    """A tall pattern's transpose packing (3 block rows of many blocks), as
    the kernels take it on a card of ``sms`` SMs: each slice's partial rows
    (the twin on the slice's blocks) laid out as the scratch, (block row,
    slice, row), and added in slice order as the sum pass adds them,
    against JAX's block_ell_matvec in interpret mode. The layout and the
    order are built here, in Python: this holds block_ell_plan's bounds and
    the twin's arithmetic, not the kernel's scratch indexing or
    sum_slices_kernel, which only the card tests reach
    (test_cuda_block_ell_kernels_match_twins at split shapes)."""
    m, n, block = 1600, 48, 16
    _, A = _jax_operator(m, n, block, 1, seed=5)
    tb, tc = _t(np.asarray(A.tblocks)), _t(np.asarray(A.tbrows))
    nb, kt = tc.shape
    assert nb == 3 and kt >= 30
    y = rng.standard_normal(A.bcols.shape[0] * block).astype(np.float32)
    plan = spmv_sparse.block_ell_plan(nb, kt, block, sms)
    assert plan.slices > 1
    parts = torch.stack([spmv_sparse.block_ell_matvec_plain(tb[:, j0:j1], tc[:, j0:j1], _t(y))
                         .reshape(nb, block) for j0, j1 in plan.bounds], dim=1)
    scratch = parts.reshape(-1)
    assert scratch.numel() == plan.scratch
    got = scratch.reshape(nb, plan.slices, block)[:, 0].clone()
    for s in range(1, plan.slices):
        got += scratch.reshape(nb, plan.slices, block)[:, s]
    ref = np.asarray(j_matvec(A.tblocks, A.tbrows, jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(to_np(got.reshape(-1)), ref, **TOL)


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
