"""The hand-written CUDA kernels of lsqr_tpu_torch against their plain
PyTorch twins, and the solve through them. Every test needs a CUDA device
and skips without one.

This file imports no JAX, so it also runs where JAX is absent. On the GPU
machine, without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import lsqr_tpu_torch as lt
from lsqr_tpu_torch.ops import spmv

from _torch_parity import DEV, banded, cuda_device, rel_err, wide_band_triplets  # noqa: F401

# f32, relative to the max: kernel and twin differ in rounding only (the
# kernel contracts multiply-adds)
TOL = 1e-5
CASES = [
    (300, 300, (-2, -1, 0, 1, 2)),
    (200, 330, (-3, 0, 7, 60)),
    (330, 200, (-60, -3, 0, 5)),
    (257, 129, (0,)),
    (300_001, 200_003, (-60, -3, 0, 5)),
    (70_000, 90_000, (0, 1, 7)),
]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


#: bands whose halo exceeds spmv.PAIR_MAX_HALO: the pairs take two launches
WIDE = [
    (5000, 4000, (-1500, -2, 0, 3, 1100)),
    (2048, 2048, (-1500, 0, 1500)),
]


def _operator(rng, m, n, ks, dtype=np.float32):
    data, _ = banded(rng, m, n, ks, dtype, dense=False)
    return lt.dia_shared_operator(m, n, ks, data, device=DEV)


def _only(**launched):
    """launch_counts() when exactly these wrappers launched, so often."""
    return {**dict.fromkeys(spmv.launch_counts(), 0), **launched}


def _vectors(rng, m, n):
    return (torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(m).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,ks", CASES)
def test_cuda_kernels_match_twins(rng, cuda_device, m, n, ks):
    Ah = _operator(rng, m, n, ks)
    A = lt.DIASharedOperator(dp=Ah.dp.to(cuda_device), m=m, n=n, offsets=ks, H=Ah.H)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    kw = dict(offsets=ks, m=m, n=n)
    spmv.reset_launch_counts()
    for adjoint, vec, out in ((False, v, y), (True, y, v)):
        dvec, dout = vec.to(cuda_device), out.to(cuda_device)
        got = spmv.dia_product_shared(A.dp, dvec, adjoint=adjoint,
                                      offsets_t=A.offsets_t, **kw)
        ref = spmv.dia_product_shared_plain(Ah.dp, vec, adjoint=adjoint, **kw)
        assert rel_err(got, ref) < TOL
        got = spmv.dia_product_shared_axpy(A.dp, dvec, dout, 0.7, 1.3,
                                           adjoint=adjoint, **kw)
        ref = spmv.dia_product_shared_axpy_plain(Ah.dp, vec, out, 0.7, 1.3,
                                                 adjoint=adjoint, **kw)
        assert rel_err(got, ref) < TOL
    c1 = torch.tensor(0.8, device=cuda_device)  # a device scalar, as in the solver
    u, z = spmv.dia_pair_shared(A.dp, v.to(cuda_device), y.to(cuda_device), c1, 1.1, **kw)
    ur, zr = spmv.dia_pair_shared_plain(Ah.dp, v, y, 0.8, 1.1, **kw)
    torch.cuda.synchronize()
    assert rel_err(u, ur) < TOL and rel_err(z, zr) < TOL
    assert spmv.launch_counts() == _only(dia_pair_shared=1, dia_product_shared=2,
                                         dia_product_shared_axpy=2)


@pytest.mark.cuda
def test_cuda_f64_product_and_wide_halo_pair(rng, cuda_device):
    m, n, ks = 5000, 4000, (-1500, -2, 0, 3, 1100)
    Ah = _operator(rng, m, n, ks, np.float64)
    x = torch.from_numpy(rng.standard_normal(n))
    got = spmv.dia_product_shared(Ah.dp.to(cuda_device), x.to(cuda_device),
                                  offsets=ks, m=m, n=n, adjoint=False)
    ref = spmv.dia_product_shared_plain(Ah.dp, x, offsets=ks, m=m, n=n, adjoint=False)
    assert got.dtype == torch.float64 and rel_err(got, ref) < 1e-13
    # H = 1500 > PAIR_MAX_HALO: the pair is the axpy kernel, then the product
    dp32 = Ah.dp.float()
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    spmv.reset_launch_counts()
    u, z = spmv.dia_pair_shared(dp32.to(cuda_device), v.to(cuda_device),
                                y.to(cuda_device), 0.5, 2.0, offsets=ks, m=m, n=n)
    ur, zr = spmv.dia_pair_shared_plain(dp32, v, y, 0.5, 2.0, offsets=ks, m=m, n=n)
    assert rel_err(u, ur) < TOL and rel_err(z, zr) < TOL
    assert spmv.launch_counts() == _only(dia_product_shared=1, dia_product_shared_axpy=1)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(rng, cuda_device):
    m, n, ks = 300, 300, (-1, 0, 1)
    data = rng.standard_normal((3, m)).astype(np.float32)
    kw = dict(offsets=ks, m=m, n=n)
    # bf16 stripes on the card take the pair (and the plain products), not
    # the fused half-step, as in the JAX package
    for build in (lt.dia_shared_operator, lt.dia_operator):
        Ab = build(m, n, ks, data, storage_dtype=torch.bfloat16, device=cuda_device)
        assert Ab.is_bf16_storage and Ab.prefers_pair and not Ab.prefers_fused
    wrong = torch.zeros(n, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):  # bf16 stripes take f32 vectors
        spmv.dia_pair(Ab.data, torch.zeros(m, device=cuda_device), wrong, 1.0, 1.0, **kw)
    Ab = lt.dia_shared_operator(m, n, ks, data, storage_dtype=torch.bfloat16,
                                device=cuda_device)
    with pytest.raises(TypeError):
        spmv.dia_product_shared(Ab.dp, wrong, adjoint=False, **kw)
    A = lt.dia_shared_operator(m, n, ks, data, device=cuda_device)
    assert A.prefers_pair and A.prefers_fused
    with pytest.raises(TypeError):
        spmv.dia_product_shared(A.dp, torch.zeros(n, dtype=torch.float64, device=cuda_device),
                                adjoint=False, **kw)
    with pytest.raises(ValueError):
        spmv.dia_product_shared(A.dp, torch.zeros(n + 1, device=cuda_device),
                                adjoint=False, **kw)
    with pytest.raises(ValueError):
        spmv.dia_pair_shared(A.dp, torch.zeros(2 * n, device=cuda_device)[::2],
                             torch.zeros(m, device=cuda_device), 1.0, 1.0, **kw)


@pytest.mark.cuda
def test_cuda_solve_runs_through_kernels(rng, cuda_device):
    m = n = 200_000
    ks = tuple(range(-5, 6))
    data, _ = banded(rng, m, n, ks, np.float32, boost=12.0, dense=False)
    b = rng.standard_normal(m).astype(np.float32)
    Ac = lt.dia_shared_operator(m, n, ks, data, device=cuda_device)
    Ah = lt.dia_shared_operator(m, n, ks, data, device=DEV)
    ref = lt.lsqr(Ah, b, 0.01, atol=1e-6, btol=1e-6, pair=True)
    for kw, kernel in ((dict(), "dia_pair_shared"),
                       (dict(pair=False), "dia_product_shared_axpy"),
                       (dict(fused=False), "dia_product_shared")):
        spmv.reset_launch_counts()
        res = lt.lsqr(Ac, b, 0.01, atol=1e-6, btol=1e-6, **kw)
        assert spmv.launch_counts()[kernel] > 0
        assert res.x.is_cuda and int(res.istop) == int(ref.istop)
        assert abs(int(res.itn) - int(ref.itn)) <= 2
        assert rel_err(res.x, ref.x) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,ks", CASES[:4] + CASES[-1:])
def test_cuda_bf16_shared_kernels_match_twins(rng, cuda_device, m, n, ks):
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    Ah = lt.dia_shared_operator(m, n, ks, data, storage_dtype=torch.bfloat16, device=DEV)
    dp = Ah.dp.to(cuda_device)
    v, y = _vectors(rng, m, n)
    kw = dict(offsets=ks, m=m, n=n)
    spmv.reset_launch_counts()
    for adjoint, vec, out in ((False, v, y), (True, y, v)):
        dvec, dout = vec.to(cuda_device), out.to(cuda_device)
        got = spmv.dia_product_shared(dp, dvec, adjoint=adjoint, **kw)
        assert got.dtype == torch.float32
        assert rel_err(got, spmv.dia_product_shared_plain(
            Ah.dp, vec, adjoint=adjoint, **kw)) < TOL
        got = spmv.dia_product_shared_axpy(dp, dvec, dout, 0.7, 1.3, adjoint=adjoint, **kw)
        assert rel_err(got, spmv.dia_product_shared_axpy_plain(
            Ah.dp, vec, out, 0.7, 1.3, adjoint=adjoint, **kw)) < TOL
    u, z = spmv.dia_pair_shared(dp, v.to(cuda_device), y.to(cuda_device), 0.8, 1.1, **kw)
    ur, zr = spmv.dia_pair_shared_plain(Ah.dp, v, y, 0.8, 1.1, **kw)
    torch.cuda.synchronize()
    assert rel_err(u, ur) < TOL and rel_err(z, zr) < TOL
    counts = spmv.launch_counts(by_variant=True)
    assert counts["dia_pair_shared[bf16]"] == 1 and counts["dia_product_shared[bf16]"] == 2
    assert counts["dia_product_shared_axpy[bf16]"] == 2 and counts["dia_pair_shared"] == 0


#: the staged dia_pair's edges: m not a multiple of 4 (or 8), so stripe
#: rows start off the 16-byte grid, with ragged m and n; halos that stage at
#: T = 2048 (one block an SM); and halos no tile's stages fit, so the pair
#: takes two launches though no halo exceeds PAIR_MAX_HALO
PAIR_CASES = [
    (4099, 2053, (-7, -1, 0, 2, 9)),
    (1027, 9001, (-3, 0, 5)),
    (2051, 6001, (-1000, 0, 1000)),
    (3001, 3001, (-1000, -800, -500, -200, 0, 200, 400, 700, 1000)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", CASES + WIDE + PAIR_CASES)
def test_cuda_packed_kernels_match_twins(rng, cuda_device, m, n, ks, storage):
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    Ah = lt.dia_operator(m, n, ks, data, storage_dtype=storage, device=DEV)
    A = lt.DIAOperator(data=Ah.data.to(cuda_device), tdata=Ah.tdata.to(cuda_device),
                       m=m, n=n, offsets=ks)
    v, y = _vectors(rng, m, n)
    dv, dy = v.to(cuda_device), y.to(cuda_device)
    kw = dict(offsets=ks, m=m, n=n)
    tkw = dict(offsets=Ah.toffsets, m=n, n=m)
    c1 = torch.tensor(0.8, device=cuda_device)  # a device scalar, as in the solver
    spmv.reset_launch_counts()
    checks = [
        (spmv.dia_matvec(A.data, dv, offsets_t=A.offsets_t, **kw),
         spmv.dia_matvec_plain(Ah.data, v, **kw)),
        (spmv.dia_matvec(A.tdata, dy, offsets_t=A.toffsets_t, **tkw),
         spmv.dia_matvec_plain(Ah.tdata, y, **tkw)),
        (spmv.dia_matvec(A.data, dy, adjoint=True, **kw),  # the column side
         spmv.dia_matvec_plain(Ah.data, y, adjoint=True, **kw)),
        (spmv.dia_matvec_axpy(A.data, dy, dv, c1, 1.3, **kw),
         spmv.dia_matvec_axpy_plain(Ah.data, y, v, 0.8, 1.3, **kw)),
        (spmv.dia_matvec_axpy(A.tdata, dv, dy, 0.6, c1, **tkw),
         spmv.dia_matvec_axpy_plain(Ah.tdata, v, y, 0.6, 0.8, **tkw)),
        *zip(spmv.dia_pair(A.data, dy, dv, c1, 1.1, **kw),
             spmv.dia_pair_plain(Ah.data, y, v, 0.8, 1.1, **kw)),
    ]
    if storage == "bfloat16":  # the axpy's f32 result, as the operators take it
        f32 = dict(out_dtype=torch.float32)
        checks.append((spmv.dia_matvec_axpy(A.data, dy, dv, c1, 1.3, **kw, **f32),
                       spmv.dia_matvec_axpy_plain(Ah.data, y, v, 0.8, 1.3, **kw, **f32)))
    if storage == "float32":
        out, ssq = spmv.dia_fused_halfstep(A.data, dy, dv, c1, 1.3, **kw)
        out_r, ssq_r = spmv.dia_fused_halfstep_plain(Ah.data, y, v, 0.8, 1.3, **kw)
        checks.append((out, out_r))
        assert ssq.shape == () and ssq.is_cuda
        np.testing.assert_allclose(float(ssq), float(ssq_r), rtol=1e-5)
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(checks):
        # the axpy returns the stripes' dtype, as the JAX kernel does: bf16
        # results may round one bf16 ulp (2^-8 relative) apart
        bf16_out = storage == "bfloat16" and i in (3, 4)
        assert got.dtype == ref.dtype == (torch.bfloat16 if bf16_out else torch.float32)
        assert got.shape == ref.shape
        assert rel_err(got, ref) < (1e-2 if bf16_out else TOL)
    # the pair's two-launch route: a halo past PAIR_MAX_HALO, or no tile fits
    wide = spmv.pair_tile(A.data.device, A.data.dtype, len(ks), *spmv._halos(ks)) == 0
    assert wide == (ks in (WIDE[0][2], WIDE[1][2], PAIR_CASES[-1][2]))
    bf16 = storage == "bfloat16"
    expect = dict(dia_pair=0 if wide else 1, dia_matvec_axpy=(3 if wide else 2) + bf16,
                  dia_matvec=4 if wide else 3,
                  dia_fused_halfstep=int(storage == "float32"))
    assert spmv.launch_counts() == _only(**expect)
    suffix = "" if storage == "float32" else "[bf16]"
    assert spmv.launch_counts(by_variant=True)["dia_matvec" + suffix] == expect["dia_matvec"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "packed"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", [(300_001, 200_003, (-60, -3, 0, 5)),
                                    (2 ** 18 + 3, 2 ** 18 + 3, tuple(range(-5, 6)))])
def test_cuda_staged_pair_is_bit_stable_and_takes_any_vectors(rng, cuda_device, m, n, ks,
                                                              storage, layout):
    """Each u and z element of the staged pair (either stripe layout) comes
    from one tile in a fixed order: two calls give the same bits, as do
    vectors that are views off the 16-byte grid (the wrapper copies them)."""
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    v, y = (t.to(cuda_device) for t in _vectors(rng, m, n))
    kw = dict(offsets=ks, m=m, n=n)
    c1 = torch.tensor(0.8, device=cuda_device)
    if layout == "packed":
        d = lt.dia_operator(m, n, ks, data, storage_dtype=storage, device=DEV).data.to(
            cuda_device)
        name = "dia_pair"

        def pair(v, y, kernel=spmv.dia_pair):
            return kernel(d, y, v, c1, 1.1, **kw)
        plain = functools.partial(pair, kernel=spmv.dia_pair_plain)
    else:
        d = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage, device=DEV).dp.to(
            cuda_device)
        name = "dia_pair_shared"

        def pair(v, y, kernel=spmv.dia_pair_shared):
            return kernel(d, v, y, c1, 1.1, **kw)
        plain = functools.partial(pair, kernel=spmv.dia_pair_shared_plain)
    assert spmv.pair_tile(d.device, d.dtype, len(ks), *spmv._halos(ks)) > 0
    spmv.reset_launch_counts()
    (u1, z1), (u2, z2) = (pair(v, y) for _ in range(2))
    vo, yo = (torch.cat([t.new_zeros(1), t])[1:] for t in (v, y))
    assert vo.data_ptr() % 16 and yo.data_ptr() % 16
    u3, z3 = pair(vo, yo)
    u_ref, z_ref = plain(v, y)
    torch.cuda.synchronize()
    assert torch.equal(u1, u2) and torch.equal(z1, z2)
    assert torch.equal(u1, u3) and torch.equal(z1, z3)
    assert rel_err(u1, u_ref) < TOL and rel_err(z1, z_ref) < TOL
    assert spmv.launch_counts() == _only(**{name: 3})
    suffix = "" if storage == "float32" else "[bf16]"
    assert spmv.launch_counts(by_variant=True)[name + suffix] == 3


#: the shared pair's staged and unstaged routes on the same inputs: CASES and
#: PAIR_CASES, one-sided bands (lower and upper), odd halos (stripe windows
#: and x windows off the 16-byte grid), m != n both ways
ROUTE_CASES = CASES + PAIR_CASES + [
    (5003, 3001, (-17, -4, 0)),
    (3001, 5003, (0, 2, 9, 17)),
    (4097, 4097, (-7, 0, 3)),
    (2 ** 16 + 1, 2 ** 16 - 3, (-5, -3, 0, 1, 5)),
    # the ring kernel's own route (81 diagonals), and halos at and near
    # PAIR_MAX_HALO (the ring wraps inside a chunk), m != n both ways
    (3001, 2001, tuple(range(-40, 41))),
    (2001, 3001, (-1000, -3, 0, 1000)),
    (5000, 4000, (-1024, 0, 1024)),
    (70_001, 90_003, (-1024, -1, 2, 700)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", ROUTE_CASES)
def test_cuda_shared_pair_routes_give_the_same_bits(rng, cuda_device, m, n, ks, storage):
    """The staged shared pair sums in the unstaged kernel's order with its
    expressions: u and z are bit-equal, and within TOL of the twin."""
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    Ah = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage, device=DEV)
    dp = Ah.dp.to(cuda_device)
    v, y = _vectors(rng, m, n)
    dv, dy = v.to(cuda_device), y.to(cuda_device)
    kw = dict(offsets=ks, m=m, n=n)
    tile = spmv.pair_tile(dp.device, dp.dtype, len(ks), *spmv._halos(ks))
    spmv.reset_launch_counts()
    u1, z1 = spmv.dia_pair_shared(dp, dv, dy, 0.8, 1.1, **kw)
    u2, z2 = spmv._dia_pair_shared_launch(dp, dv, dy, 0.8, 1.1, tile=0, **kw)
    ur, zr = spmv.dia_pair_shared_plain(Ah.dp, v, y, 0.8, 1.1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(u1, u2) and torch.equal(z1, z2)
    assert rel_err(u1, ur) < TOL and rel_err(z1, zr) < TOL
    suffix = "" if storage == "float32" else "[bf16]"
    unstaged = f"dia_pair_shared[{spmv.UNSTAGED[dp.dtype]}]"
    counts = spmv.launch_counts(by_variant=True)
    assert counts["dia_pair_shared" + suffix] == int(tile > 0)
    assert counts[unstaged] == 2 - int(tile > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_shared_pair_routes_are_counted(rng, cuda_device, storage):
    """Each route where it is stated: staged where a tile fits, unstaged
    (the ring kernel) where none fits (81 diagonals) though H <=
    PAIR_MAX_HALO, two launches above it or where neither kernel's shared
    memory fits; each bit-equal to itself over two calls."""
    suffix = "" if storage == "float32" else "[bf16]"
    unstaged = f"dia_pair_shared[{spmv.UNSTAGED[getattr(torch, storage)]}]"
    for (m, n, ks), route, expect in (
            ((4099, 2053, (-7, -1, 0, 2, 9)), "staged", {"dia_pair_shared" + suffix: 1}),
            ((3001, 3001, (-1000, 0, 1000)), "staged", {"dia_pair_shared" + suffix: 1}),
            ((3001, 2001, tuple(range(-40, 41))), "unstaged", {unstaged: 1}),
            ((2001, 3001, tuple(range(-40, 41))), "unstaged", {unstaged: 1}),
            (PAIR_CASES[-1], "unstaged", {unstaged: 1}),
            # 81 diagonals over a halo of 1000: neither kernel's shared memory fits
            ((3001, 3001, tuple(range(-1000, 1001, 25))), "two launches",
             {"dia_product_shared_axpy" + suffix: 1, "dia_product_shared" + suffix: 1}),
            (WIDE[1], "two launches", {"dia_product_shared_axpy" + suffix: 1,
                                       "dia_product_shared" + suffix: 1})):
        data, _ = banded(rng, m, n, ks, np.float32, dense=False)
        Ah = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage, device=DEV)
        dp = Ah.dp.to(cuda_device)
        v, y = _vectors(rng, m, n)
        kw = dict(offsets=ks, m=m, n=n)
        tile = spmv.pair_tile(dp.device, dp.dtype, len(ks), *spmv._halos(ks))
        ring = spmv._ring_fits(dp.device, dp.dtype, len(ks), *spmv._halos(ks))
        assert spmv.pair_shared_route(Ah.H, tile, ring) == route
        spmv.reset_launch_counts()
        u, z = spmv.dia_pair_shared(dp, v.to(cuda_device), y.to(cuda_device), 0.8, 1.1, **kw)
        ur, zr = spmv.dia_pair_shared_plain(Ah.dp, v, y, 0.8, 1.1, **kw)
        torch.cuda.synchronize()
        assert rel_err(u, ur) < TOL and rel_err(z, zr) < TOL
        counts = spmv.launch_counts(by_variant=True)
        assert {k: c for k, c in counts.items() if c} == expect, (m, n, len(ks))
        assert sum(spmv.launch_counts().values()) == (2 if route == "two launches" else 1)
        # each route is bit-equal to itself over two calls (no atomics)
        u2, z2 = spmv.dia_pair_shared(dp, v.to(cuda_device), y.to(cuda_device), 0.8, 1.1,
                                      **kw)
        assert torch.equal(u, u2) and torch.equal(z, z2)


@pytest.mark.cuda
def test_cuda_packed_f64_matvec(rng, cuda_device):
    m, n, ks = 5000, 4000, (-1500, -2, 0, 3, 1100)
    data, _ = banded(rng, m, n, ks, np.float64, dense=False)
    Ah = lt.dia_operator(m, n, ks, data, device=DEV)
    A = lt.dia_operator(m, n, ks, data, device=cuda_device)
    x, y = torch.from_numpy(rng.standard_normal(n)), torch.from_numpy(rng.standard_normal(m))
    assert rel_err(A.matvec(x.to(cuda_device)), Ah.matvec(x)) < 1e-13
    assert rel_err(A.rmatvec(y.to(cuda_device)), Ah.rmatvec(y)) < 1e-13
    got = spmv.dia_matvec(A.data, y.to(cuda_device), offsets=ks, m=m, n=n, adjoint=True)
    assert got.dtype == torch.float64
    assert rel_err(got, spmv.dia_matvec_plain(Ah.data, y, offsets=ks, m=m, n=n,
                                              adjoint=True)) < 1e-13
    assert not A.prefers_pair and not A.prefers_fused


@pytest.mark.cuda
def test_cuda_packed_solve_runs_through_kernels(rng, cuda_device):
    m = n = 200_000
    ks = tuple(range(-5, 6))
    data, _ = banded(rng, m, n, ks, np.float32, boost=12.0, dense=False)
    b = rng.standard_normal(m).astype(np.float32)
    Ac = lt.dia_operator(m, n, ks, data, device=cuda_device)
    Ah = lt.dia_operator(m, n, ks, data, device=DEV)
    ref = lt.lsqr(Ah, b, 0.01, atol=1e-6, btol=1e-6, pair=True)
    for kw, kernel in ((dict(), "dia_pair"),
                       (dict(pair=False), "dia_fused_halfstep"),
                       (dict(fused=False), "dia_matvec")):
        spmv.reset_launch_counts()
        res = lt.lsqr(Ac, b, 0.01, atol=1e-6, btol=1e-6, **kw)
        assert spmv.launch_counts()[kernel] > 0
        assert res.x.is_cuda and int(res.istop) == int(ref.istop)
        assert abs(int(res.itn) - int(ref.itn)) <= 2
        assert rel_err(res.x, ref.x) < 1e-4


@pytest.mark.cuda
def test_cuda_bf16_solves_take_the_pair(rng, cuda_device):
    m = n = 200_000
    ks = tuple(range(-5, 6))
    data, _ = banded(rng, m, n, ks, np.float32, boost=12.0, dense=False)
    b = rng.standard_normal(m).astype(np.float32)
    for build, kernel in ((lt.dia_operator, "dia_pair[bf16]"),
                          (lt.dia_shared_operator, "dia_pair_shared[bf16]")):
        ref = lt.lsqr(build(m, n, ks, data, storage_dtype=torch.bfloat16), b, 0.01,
                      atol=1e-6, btol=1e-6, pair=True)
        spmv.reset_launch_counts()
        res = lt.lsqr(build(m, n, ks, data, storage_dtype=torch.bfloat16,
                            device=cuda_device), b, 0.01, atol=1e-6, btol=1e-6)
        assert spmv.launch_counts(by_variant=True)[kernel] > 0
        assert int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 2
        assert rel_err(res.x, ref.x) < 1e-4


# ---------------------------------------------------------------------------
# the iteration megakernels (csrc/megakernel.cu)
# ---------------------------------------------------------------------------

#: tests/test_megakernel*.py shapes: square, over- and under-determined,
#: ragged, one-sided offsets
MK_CASES = [
    (2048, 2048, (-3, -1, 0, 2, 5)),
    (3072, 2048, (-3, -1, 0, 2, 5)),
    (2048, 3072, (-3, -1, 0, 2, 5)),
    (2500, 1800, (0, 1, 2)),
    (1800, 2500, (-2, -1, 0)),
    (300_001, 200_003, (-60, -3, 0, 5)),
]
MK_TOL = 1e-4  # kernel vs twin after 8 iterations: summation order only


def _mk_problem(rng, m, n, ks, storage, device=DEV, boost=8.0):
    data, _ = banded(rng, m, n, ks, np.float32, boost=boost, dense=False)
    return lt.dia_operator(m, n, ks, data, storage_dtype=storage, device=device)


def _mk_setup(solver, A, b):
    """(call, vectors, state) of one megakernel call from the solver's setup."""
    from lsqr_tpu_torch.ops import megakernel, megakernel_craig, megakernel_lsmr

    mod, call = {
        "lsqr": (megakernel, megakernel.lsqr_megakernel_call),
        "lsmr": (megakernel_lsmr, megakernel_lsmr.lsmr_megakernel_call),
        "craig": (megakernel_craig, megakernel_craig.craig_megakernel_call),
    }[solver]
    vectors, state = getattr(mod, f"{solver}_megakernel_prepare")(
        A, b, itnlim=1000, **({} if solver == "craig" else dict(damp=0.01)))
    return call, vectors, state


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
@pytest.mark.parametrize("m,n,ks", MK_CASES)
def test_cuda_megakernels_match_twins(rng, cuda_device, m, n, ks, solver, storage):
    Ah = _mk_problem(rng, m, n, ks, storage)
    A = lt.DIAOperator(data=Ah.data.to(cuda_device), tdata=Ah.tdata.to(cuda_device),
                       m=m, n=n, offsets=ks)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    if solver == "craig":  # a consistent system
        b = Ah.matvec(torch.from_numpy(rng.standard_normal(n).astype(np.float32)))
    call, vec_h, state_h = _mk_setup(solver, Ah, b)
    vec_d = [t.to(cuda_device) for t in vec_h]
    state_d = state_h.to(cuda_device)
    spmv.reset_launch_counts()
    call(A.data, A.tdata, *vec_d, state_d, offsets=ks, m=m, n=n, K=8)
    call(Ah.data, Ah.tdata, *vec_h, state_h, offsets=ks, m=m, n=n, K=8)
    torch.cuda.synchronize()
    name = f"{solver}_megakernel" + ("" if storage == "float32" else "[bf16]")
    assert spmv.launch_counts(by_variant=True)[name] == 1
    assert sum(spmv.launch_counts().values()) == 1
    got, ref = state_d.cpu().numpy(), state_h.numpy()
    scale = np.maximum(np.abs(ref), 1e-6)
    assert np.all(np.abs(got - ref) <= MK_TOL * scale), (got, ref)
    for g, r in zip(vec_d, vec_h):
        assert rel_err(g, r) < MK_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
def test_cuda_megakernel_carryover_bit_equal(rng, cuda_device, solver):
    """A stop in the middle of a launch masks the rest: K = 64 and K = 4
    give bit-equal results on the card, as in the JAX tests."""
    A = _mk_problem(rng, 2048, 2048, (-3, -1, 0, 2, 5), None, cuda_device)
    b = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(cuda_device)
    fn = {"lsqr": lt.lsqr_megakernel, "lsmr": lt.lsmr_megakernel,
          "craig": lt.craig_megakernel}[solver]
    if solver == "craig":
        b = A.matvec(b)
    kw = dict(atol=1e-4, btol=1e-4, itnlim=100)
    r1, r2 = fn(A, b, iters_per_call=64, **kw), fn(A, b, iters_per_call=4, **kw)
    assert int(r1.istop) == int(r2.istop) and int(r1.itn) == int(r2.itn)
    assert r1.x.is_cuda and torch.equal(r1.x, r2.x)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
def test_cuda_megakernel_solves_match_regular(rng, cuda_device, solver, storage):
    m = n = 200_000
    ks = tuple(range(-5, 6))
    A = _mk_problem(rng, m, n, ks, storage, cuda_device, boost=12.0)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    fn = {"lsqr": lt.lsqr, "lsmr": lt.lsmr, "craig": lt.craig}[solver]
    kw = dict(atol=1e-6, btol=1e-6)
    if solver == "craig":
        b = A.matvec(b)
    else:
        kw["damp"] = 0.01
    ref = fn(A, b, **kw)
    spmv.reset_launch_counts()
    res = fn(A, b, megakernel=True, **kw)
    name = f"{solver}_megakernel" + ("" if storage == "float32" else "[bf16]")
    assert spmv.launch_counts(by_variant=True)[name] > 0
    assert res.x.is_cuda and int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 1
    assert rel_err(res.x, ref.x) < 1e-3


#: the staged phases' edges: m, n not multiples of 8 under offsets at mixed
#: 16-byte phases (each diagonal's row of data and tdata at a phase of its
#: own), m != n both ways, both dims below one tile, a one-sided band; and a
#: band whose vector window fits no tile's shared memory (the direct route)
MK_EDGES = [
    (4099, 2053, (-7, -3, 0, 1, 5)),
    (2053, 4099, (-7, -3, 0, 1, 5)),
    (201, 150, (-7, -3, 0, 1, 5)),
    (150, 201, (-2, 0, 3)),
]
MK_FAR = (2 ** 16, 2 ** 16, (-2 ** 15, 0, 2 ** 15))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
@pytest.mark.parametrize("m,n,ks", MK_EDGES + [MK_FAR])
def test_cuda_megakernel_routes_match_twin_and_each_other(rng, cuda_device, m, n, ks, solver,
                                                          storage):
    """The route of spmv.mk_tile against the twin (staged at the edges,
    direct at the far band), and the direct route forced at the rule's grid
    from the same state: within MK_TOL of the staged route (a thread sums
    two outputs there, one on the direct route: the sums of squares round
    differently), the same bits where the rule took the direct route."""
    Ah = _mk_problem(rng, m, n, ks, storage)
    A = lt.DIAOperator(data=Ah.data.to(cuda_device), tdata=Ah.tdata.to(cuda_device),
                       m=m, n=n, offsets=ks)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    if solver == "craig":
        b = Ah.matvec(torch.from_numpy(rng.standard_normal(n).astype(np.float32)))
    call, vec_h, state_h = _mk_setup(solver, Ah, b)
    mine = [t.to(cuda_device) for t in (*vec_h, state_h)]
    direct = [t.clone() for t in mine]
    kw = dict(offsets=ks, m=m, n=n, K=8)
    spmv.reset_launch_counts()
    call(A.data, A.tdata, *mine, **kw)
    tile, blocks = call.tile, call.blocks
    assert tile == (0 if (m, n, ks) == MK_FAR else spmv.MK_TILE)
    assert call.stage_bytes == (spmv.mk_stage_bytes(len(ks), *spmv._halos(ks), tile,
                                                    A.data.element_size()) if tile else 0)
    call(A.data, A.tdata, *direct, _route=(0, blocks), **kw)
    call(Ah.data, Ah.tdata, *vec_h, state_h, **kw)
    torch.cuda.synchronize()
    name = f"{solver}_megakernel" + ("" if storage == "float32" else "[bf16]")
    assert spmv.launch_counts(by_variant=True)[name] == 2
    got, ref = mine[-1].cpu().numpy(), state_h.numpy()
    scale = np.maximum(np.abs(ref), 1e-6)
    assert np.all(np.abs(got - ref) <= MK_TOL * scale), (got, ref)
    for g, r in zip(mine[:-1], vec_h):
        assert rel_err(g, r) < MK_TOL
    for g, d in zip(mine[:-1], direct[:-1]):
        assert torch.equal(g, d) if tile == 0 else rel_err(d, g) < MK_TOL
    got, ref = direct[-1].cpu().numpy(), mine[-1].cpu().numpy()
    if tile == 0:
        assert np.array_equal(got, ref)
    assert np.all(np.abs(got - ref) <= MK_TOL * np.maximum(np.abs(ref), 1e-6)), (got, ref)


@pytest.mark.cuda
def test_cuda_megakernel_routes_raise(rng, cuda_device):
    m = n = 3000
    ks = (-1, 0, 1)
    data, _ = banded(rng, m, n, ks, np.float32, boost=8.0, dense=False)
    b = torch.ones(m, device=cuda_device)
    shared = lt.dia_shared_operator(m, n, ks, data, device=cuda_device)
    packed = lt.dia_operator(m, n, ks, data, device=cuda_device)
    assert lt.megakernel_supported(packed) and not lt.megakernel_supported(shared)
    for fn in (lt.lsqr, lt.lsmr, lt.craig):
        with pytest.raises(ValueError):
            fn(shared, b, megakernel=True)
    with pytest.raises(ValueError):
        lt.lsqr(packed, b, megakernel=True, wantse=True)
    with pytest.raises(ValueError):
        lt.lsmr(packed, b, megakernel=True, record_trace=True)
    with pytest.raises(ValueError):
        lt.lsqr_megakernel(packed, b, 0.1, x0=torch.zeros(n, device=cuda_device))


# ---------------------------------------------------------------------------
# General sparsity: jdia_matvec and the three BlockELL kernels
# ---------------------------------------------------------------------------

from lsqr_tpu_torch.models.synthetic import jittered_band_coo, random_block_coo  # noqa: E402
from lsqr_tpu_torch.ops import spmv_sparse  # noqa: E402
from lsqr_tpu_torch.ops.jdia import jdia_pack  # noqa: E402


def _cuda(a, device):
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,tm", [(3000, 2500, 1024), (70_001, 50_003, 8192),
                                    (65_536, 65_536, 8192)])
def test_cuda_jdia_kernel_matches_twin(rng, cuda_device, m, n, tm):
    vals, rows, cols = jittered_band_coo(m, n, outliers=0.001, seed=m)
    p = jdia_pack(m, n, vals, rows, cols, tm=tm)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    spmv.reset_launch_counts()
    for pre, vec, p_lo, m_out in (("", x, p["p_lo"], m), ("t", y, p["tp_lo"], n)):
        args = [_cuda(p[pre + k], cuda_device) for k in ("data", "eoff", "base")]
        got = spmv_sparse.jdia_matvec(*args, _cuda(vec, cuda_device), m=m_out, p_lo=p_lo,
                                      tm=tm)
        ref = spmv_sparse.jdia_matvec_plain(*args, _cuda(vec, cuda_device), m=m_out,
                                            p_lo=p_lo, tm=tm)
        torch.cuda.synchronize()
        assert got.shape == (m_out,) and rel_err(got, ref) < TOL
    assert spmv.launch_counts() == _only(jdia_matvec=2)


def _random_blocks(rng, mb, kb, bh, bw, nb, device):
    blocks = torch.from_numpy(rng.standard_normal((mb, kb, bh, bw)).astype(np.float32))
    bcols = torch.from_numpy(rng.integers(0, nb, (mb, kb)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(nb * bw).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(mb * bh).astype(np.float32))
    return [t.to(device) for t in (blocks, bcols, x, y)]


@pytest.mark.cuda
@pytest.mark.parametrize("mb,kb,bh,bw,nb", [
    (16, 3, 128, 128, 20),     # the pair keeps the blocks in shared memory
    (64, 5, 128, 128, 40),     # it reads them again from L2
    (37, 3, 24, 30, 11),       # bw not a multiple of 4: scalar loads
    (12, 2, 32, 32, 9),        # tr = 6 divides mb
    (12, 164, 128, 128, 12),   # a tall transpose: long rows split, past the window
    (3, 40, 128, 128, 50),     # few long rows, split, inside the window
    (1, 7, 24, 30, 9),         # one row split, scalar loads
    (50, 1, 128, 128, 60),     # the pair: one block a row, a cluster of one
    (33, 10, 64, 64, 40),      # ranks of one and two blocks, kept
    (5, 3, 256, 256, 7),       # a block past shared memory: read twice
    (515, 3, 128, 128, 600),   # many block rows, the 2^18 packing's blocks
])
def test_cuda_block_ell_kernels_match_twins(rng, cuda_device, mb, kb, bh, bw, nb):
    """Both products and the pair against their twins; each product and the
    pair called twice give the same bits (slices and ranks are added in a
    fixed order)."""
    blocks, bcols, x, y = _random_blocks(rng, mb, kb, bh, bw, nb, cuda_device)
    ref = spmv_sparse.block_ell_matvec_plain(blocks, bcols, x)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = spmv_sparse.block_ell_plan(mb, kb, bh, sms)
    assert (plan.slices > 1) == (kb > 1 and mb < spmv_sparse.UNITS_PER_SM * sms)
    windowed = spmv_sparse.windowed_rows_per_tile(mb, kb, bw) > 0
    spmv.reset_launch_counts()
    got = spmv_sparse.block_ell_matvec(blocks, bcols, x)
    again = spmv_sparse.block_ell_matvec(blocks, bcols, x)
    torch.cuda.synchronize()
    assert rel_err(got, ref) < TOL and torch.equal(got, again)
    for tr in (None, 1, 8) if windowed else ():
        got = spmv_sparse.block_ell_matvec_windowed(blocks, bcols, x, tr=tr)
        again = spmv_sparse.block_ell_matvec_windowed(blocks, bcols, x, tr=tr)
        torch.cuda.synchronize()
        assert rel_err(got, ref) < TOL and torch.equal(got, again)
    c1 = torch.tensor(0.7, device=cuda_device)
    u, zp = spmv_sparse.block_ell_pair_windowed(blocks, bcols, x, y, c1, -1.3)
    u2, zp2 = spmv_sparse.block_ell_pair_windowed(blocks, bcols, x, y, c1, -1.3)
    u_ref, zp_ref = spmv_sparse.block_ell_pair_plain(blocks, bcols, x, y, c1, -1.3)
    torch.cuda.synchronize()
    assert rel_err(u, u_ref) < TOL and rel_err(zp, zp_ref) < TOL
    assert torch.equal(u, u2) and torch.equal(zp, zp2)
    assert spmv.launch_counts() == _only(block_ell_matvec=2,
                                         block_ell_matvec_windowed=6 if windowed else 0,
                                         block_ell_pair_windowed=2)


@pytest.mark.cuda
def test_cuda_general_wrappers_refuse_what_the_kernels_do_not_take(rng, cuda_device):
    blocks, bcols, x, _ = _random_blocks(rng, 8, 200, 128, 128, 300, cuda_device)
    with pytest.raises(ValueError, match="window"):   # 200 segments overflow the window
        spmv_sparse.block_ell_matvec_windowed(blocks, bcols, x)
    with pytest.raises(TypeError):
        spmv_sparse.block_ell_matvec(blocks.double(), bcols, x.double())
    with pytest.raises(TypeError):
        spmv_sparse.block_ell_matvec(blocks, bcols.long(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["jdia", "block_pair_off", "block_pair_on", "block_tall"])
def test_cuda_general_solves_run_through_kernels(rng, cuda_device, kind):
    if kind == "jdia":
        m = n = 40_000
        vals, rows, cols = jittered_band_coo(m, n, seed=3, diag=12.0)
        build = lambda dev: lt.auto_operator(m, n, vals, rows, cols, device=dev)  # noqa: E731
        launched = ("jdia_matvec",)
    else:
        # block_tall: 120 block rows over 3 block columns, so the transpose
        # packing (kt = 120) overflows the windowed kernel's window
        m, n = (5000, 4100) if kind != "block_tall" else (15_355, 364)
        vals, rows, cols = random_block_coo(m, n, seed=3, diag=2.0)
        build = lambda dev: lt.block_ell_operator(  # noqa: E731
            m, n, vals, rows, cols, device=dev)
        launched = {"block_pair_on": ("block_ell_pair_windowed",),
                    "block_pair_off": ("block_ell_matvec_windowed",),
                    "block_tall": ("block_ell_matvec_windowed", "block_ell_matvec")}[kind]
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-6, btol=1e-6, pair=kind == "block_pair_on")
    host = lt.lsqr(build(DEV), torch.from_numpy(b), 0.01, **kw)
    A = build(cuda_device)
    assert type(A).__name__ == ("JDIAOperator" if kind == "jdia" else "BlockELLOperator")
    spmv.reset_launch_counts()
    res = lt.lsqr(A, torch.from_numpy(b).to(cuda_device), 0.01, **kw)
    assert all(spmv.launch_counts()[name] > 0 for name in launched)
    assert int(res.istop) == int(host.istop) and abs(int(res.itn) - int(host.itn)) <= 1
    assert rel_err(res.x, host.x) < 1e-3


@pytest.mark.cuda
def test_cuda_f64_general_operators_take_the_twins(rng, cuda_device):
    m = n = 3000
    vals, rows, cols = jittered_band_coo(m, n, seed=4, dtype=np.float64)
    A = lt.jdia_operator(m, n, vals, rows, cols, device=cuda_device)
    B = lt.block_ell_operator(m, n, *random_block_coo(m, n, seed=4, dtype=np.float64),
                              device=cuda_device)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda_device)
    spmv.reset_launch_counts()
    for op in (A, B):
        assert op.dtype == torch.float64
        assert rel_err(op.matvec(x), op.todense() @ x) < 1e-12
    assert spmv.launch_counts() == _only()


from lsqr_tpu_torch.models.synthetic import zipf_column_coo  # noqa: E402
from lsqr_tpu_torch.ops import spmv_wcoo  # noqa: E402


def _ragged_triplets(rng, m, n, nnz):
    """Zipf columns with duplicates and a band of empty rows."""
    vals, rows, cols = zipf_column_coo(m, n, nnz, seed=int(rng.integers(1 << 30)))
    rows = np.where((rows > m // 3) & (rows < m // 3 + 500), rows - 500, rows)
    rows[-200:], cols[-200:] = rows[:200], cols[:200]  # duplicates
    return vals, rows, cols


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,n,nnz", [
    ("wcoo", 40_000, 300, 150_000),         # m not a multiple of CR, n of 128
    ("wcoo", 16_384, 4096, 60_000),
    ("rwcoo", 40_000, 30_001, 120_000),     # n not a multiple of 1024
    ("rwcoo", 100_003, 12_345, 400_000),
])
def test_cuda_wcoo_kernels_match_twins(rng, cuda_device, kind, m, n, nnz):
    vals, rows, cols = _ragged_triplets(rng, m, n, nnz)
    build = lt.wcoo_operator if kind == "wcoo" else lt.rwcoo_operator
    A = build(m, n, vals, rows, cols, device=cuda_device)
    packings = [(A.packed, "wcoo")] if kind == "wcoo" else [(A.hot, "wcoo"), (A.cold, "wwcoo")]
    c1 = torch.tensor(0.7, device=cuda_device)
    spmv.reset_launch_counts()
    for p, name in packings:
        fwd, adj, pair = (getattr(spmv_wcoo, f"{name}_{s}") for s in ("forward", "adjoint",
                                                                      "pair"))
        plain = [getattr(spmv_wcoo, f"{name}_{s}_plain") for s in ("forward", "adjoint",
                                                                   "pair")]
        x = torch.randn(p.n, device=cuda_device)
        y = torch.randn(m, device=cuda_device)
        for c2 in (0.3, -1.0):
            got, ref = fwd(p, x, c1, c2, y), plain[0](p, x, c1, c2, y)
            torch.cuda.synchronize()
            assert got.shape == (m,) and rel_err(got, ref) < TOL
        got, ref = adj(p, y), plain[1](p, y)
        torch.cuda.synchronize()
        assert got.shape == (p.n,) and rel_err(got, ref) < 1e-4
        (u, z), (u_ref, z_ref) = pair(p, y, x, c1, 0.3), plain[2](p, y, x, c1, 0.3)
        torch.cuda.synchronize()
        assert rel_err(u, u_ref) < TOL and rel_err(z, z_ref) < 1e-4
    expect = {f"{name}_{s}": (2 if s == "forward" else 1) for _, name in packings
              for s in ("forward", "adjoint", "pair")}
    assert spmv.launch_counts() == _only(**expect)


def _zero_subtile(p):
    """A WCOO/WWCOO packing with one 1024-slot subtile's entries zeroed in
    both copies: a tile the kernels never ran."""
    t = p.nc // 2
    vals, vals_r = p.vals.clone(), p.vals_r.clone()
    vals[t, :1024], vals_r[t, :1024] = 0.0, 0.0
    return dataclasses.replace(p, vals=vals, vals_r=vals_r)


#: the card's solve against the CPU's, the damped objective relative: above
#: every sound reading, below a zeroed subtile's (PERF.md, Findings)
WCOO_OBJ_TOL = {"wcoo": 1e-8, "rwcoo": 3e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wcoo", "rwcoo"])
def test_cuda_wcoo_solves_run_through_kernels(rng, cuda_device, kind, record_property):
    """The pair path on the card against the separate products on the CPU.
    On Zipf columns the f32 iterates depend on the summation order once
    Golub-Kahan loses orthogonality, so x is held to the damped objective,
    within a limit that three card solves keep and the same solve on a
    planted fault exceeds; the three card solves give bit-equal x (no
    kernel of the path adds with atomics). The readings go to the test's
    properties (``--junitxml``)."""
    import scipy.sparse

    m, n = (40_000, 500) if kind == "wcoo" else (40_000, 8192)
    vals, rows, cols = zipf_column_coo(m, n, (6 if kind == "wcoo" else 3) * m, seed=5)
    b = rng.standard_normal(m).astype(np.float32)
    damp = 0.05
    kw = dict(atol=1e-6, btol=1e-6)
    host = lt.lsqr(lt.auto_operator(m, n, vals, rows, cols, device=DEV), torch.from_numpy(b),
                   damp, **kw)
    A = lt.auto_operator(m, n, vals, rows, cols, device=cuda_device)
    assert type(A).__name__ == {"wcoo": "WCOOOperator", "rwcoo": "RWCOOOperator"}[kind]
    assert A.prefers_pair
    b_card = torch.from_numpy(b).to(cuda_device)
    spmv.reset_launch_counts()
    res = lt.lsqr(A, b_card, damp, **kw)
    launched = spmv.launch_counts()
    pair = "wcoo_pair" if kind == "wcoo" else "wwcoo_pair"
    assert launched[pair] > 0
    assert int(res.istop) == int(host.istop)
    assert abs(int(res.itn) - int(host.itn)) <= max(3, int(host.itn) // 5)
    S = scipy.sparse.coo_matrix((vals.astype(np.float64), (rows, cols)), shape=(m, n))

    def objective(x):
        x = x.cpu().double().numpy()
        r = S @ x - b
        return r @ r + damp ** 2 * x @ x

    ref = objective(host.x)
    again = [lt.lsqr(A, b_card, damp, **kw).x for _ in range(2)]
    assert all(torch.equal(x, res.x) for x in again)
    sound = [abs(objective(x) - ref) / ref for x in (res.x, *again)]
    faulty = (dataclasses.replace(A, packed=_zero_subtile(A.packed)) if kind == "wcoo" else
              dataclasses.replace(A, hot=_zero_subtile(A.hot), cold=_zero_subtile(A.cold)))
    fault = abs(objective(lt.lsqr(faulty, b_card, damp, **kw).x) - ref) / ref
    record_property("objective_rel_sound", repr(sound))
    record_property("objective_rel_zeroed_subtile", repr(fault))
    assert max(sound) <= WCOO_OBJ_TOL[kind] < fault


@pytest.mark.cuda
def test_cuda_wcoo_wrappers_refuse_what_the_kernels_do_not_take(rng, cuda_device):
    vals, rows, cols = zipf_column_coo(20_000, 300, 50_000, seed=6)
    A = lt.wcoo_operator(20_000, 300, vals, rows, cols, device=cuda_device)
    x = torch.randn(300, device=cuda_device)
    with pytest.raises(TypeError):
        spmv_wcoo.wcoo_forward(A.packed, x.double(), 1.0, 0.0, x[:0])
    with pytest.raises(ValueError, match="entries"):
        spmv_wcoo.wcoo_forward(A.packed, x[:299], 1.0, 0.0, x[:0])
    with pytest.raises(ValueError):
        spmv_wcoo.wcoo_adjoint(A.packed, torch.randn(A.packed.m_pad + 1, device=cuda_device))


#: first-order precision of the card's WCOO/RWCOO products against the f64
#: triplets, max |error| / max |product|: above the f32 products' summation
#: error at this size, far below bf16-rounded values' (~2.4e-3; PERF.md,
#: Findings)
PRODUCT_TOL = 1e-5


def _bf16_values(p):
    return dataclasses.replace(p, vals=p.vals.bfloat16().float(),
                               vals_r=p.vals_r.bfloat16().float())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wcoo", "rwcoo"])
def test_cuda_wcoo_products_hold_f64_precision(rng, cuda_device, kind, record_property):
    """A check that sees the values' precision: each card product against
    the f64 triplets at three seeded vectors, and the same operator with
    its values rounded to bf16 outside the limit."""
    import scipy.sparse

    m, n = (40_000, 500) if kind == "wcoo" else (40_000, 8192)
    vals, rows, cols = zipf_column_coo(m, n, (6 if kind == "wcoo" else 3) * m, seed=5)
    S = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(m, n))
    A = lt.auto_operator(m, n, vals, rows, cols, device=cuda_device)
    fault = (dataclasses.replace(A, packed=_bf16_values(A.packed)) if kind == "wcoo" else
             dataclasses.replace(A, hot=_bf16_values(A.hot), cold=_bf16_values(A.cold)))

    def worst(op):
        g = np.random.default_rng(7)
        errs = []
        for _ in range(3):
            x, y = g.standard_normal(n), g.standard_normal(m)
            for prod, vec, ref in ((op.matvec, x, S @ x), (op.rmatvec, y, S.T @ y)):
                got = prod(torch.from_numpy(vec.astype(np.float32)).to(cuda_device))
                errs.append(np.abs(got.cpu().double().numpy() - ref).max()
                            / np.abs(ref).max())
        return max(errs)

    sound, bf16 = worst(A), worst(fault)
    record_property("product_rel_sound", repr(sound))
    record_property("product_rel_bf16", repr(bf16))
    assert sound <= PRODUCT_TOL < bf16


def _long_row_triplets(rng, m, n, nnz):
    """Zipf columns with duplicates, empty rows, 40 rows of 150 more
    entries and 3 of 1500: rows longer than the forward's 32-slot step."""
    vals, rows, cols = _ragged_triplets(rng, m, n, nnz)
    extra = np.concatenate([np.repeat(rng.choice(m, 40, replace=False), 150),
                            np.repeat(rng.choice(m, 3, replace=False), 1500)])
    return (np.concatenate([vals, rng.standard_normal(extra.size).astype(np.float32)]),
            np.concatenate([rows, extra]), np.concatenate([cols, rng.integers(0, n, extra.size)]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,n,nnz", [
    ("wcoo", 40_000, 1000, 120_000),
    ("rwcoo", 50_001, 20_000, 150_000),
])
def test_cuda_chunked_coo_forwards_match_twins_on_long_rows(rng, cuda_device, kind, m, n,
                                                            nnz):
    vals, rows, cols = _long_row_triplets(rng, m, n, nnz)
    build = lt.wcoo_operator if kind == "wcoo" else lt.rwcoo_operator
    A = build(m, n, vals, rows, cols, device=cuda_device)
    packings = [(A.packed, "wcoo")] if kind == "wcoo" else [(A.hot, "wcoo"), (A.cold, "wwcoo")]
    for p, name in packings:
        fwd = getattr(spmv_wcoo, f"{name}_forward")
        plain = getattr(spmv_wcoo, f"{name}_forward_plain")
        x = torch.randn(p.n, device=cuda_device)
        for y in (torch.randn(m, device=cuda_device), torch.randn(p.m_pad, device=cuda_device)):
            got, ref = fwd(p, x, 0.7, 0.3, y), plain(p, x, 0.7, 0.3, y)
            torch.cuda.synchronize()
            assert got.shape == (m,) and rel_err(got, ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,n,nnz", [
    ("wcoo", 40_000, 300, 150_000),
    ("wcoo", 16_384, 4096, 60_000),
    ("rwcoo", 100_003, 12_345, 400_000),
    ("rwcoo cold", 100_003, 12_345, 400_000),
    ("wwcoo", 40_000, 30_001, 120_000),
    # D_pad = 98,304 positions: past one block's shared memory, two windows
    ("wwcoo band", 32_768, 262_144, 6),
    # D_pad = 49,152: one window, one group of 8 warps a block
    ("wwcoo band", 32_768, 262_144, 3),
])
def test_cuda_wcoo_adjoint_and_pair_are_bit_stable(rng, cuda_device, kind, m, n, nnz):
    """Neither adjoint adds with float atomics: the WCOO one sums fixed
    per-block partials in a fixed order, the WWCOO one expands each chunk's
    compacted partials in chunk order. Two calls on the same inputs give the
    same bits (the RWCOO hot panel's and cold stream's too), as the forward
    does, and match the twins."""
    if kind == "wwcoo band":
        vals, rows, cols = wide_band_triplets(rng, m, nnz, {6: 8, 3: 4}[nnz])
    else:
        vals, rows, cols = _ragged_triplets(rng, m, n, nnz)
    build = {"wcoo": lt.wcoo_operator, "wwcoo": lt.wwcoo_operator}.get(kind.split()[0],
                                                                      lt.rwcoo_operator)
    A = build(m, n, vals, rows, cols, device=cuda_device)
    p = A.hot if kind == "rwcoo" else A.cold if kind == "rwcoo cold" else A.packed
    pre = "wcoo" if kind in ("wcoo", "rwcoo") else "wwcoo"
    fwd, adj, pair = (getattr(spmv_wcoo, f"{pre}_{s}") for s in ("forward", "adjoint", "pair"))
    if kind == "wwcoo band":
        groups, _, windows, _ = spmv_wcoo.wwcoo_adjoint_plan(
            p.vals.device.index, p.js * 128, p.eb, p.nc)
        assert p.js * 128 == 16384 * nnz
        assert (groups, windows > 1) == ((1, True) if nnz == 6 else (1, False))
    x = torch.randn(p.n, device=cuda_device)
    y = torch.randn(m, device=cuda_device)
    c1 = torch.tensor(0.7, device=cuda_device)
    spmv.reset_launch_counts()
    z1, z2 = adj(p, y), adj(p, y)
    (u1, w1), (u2, w2) = (pair(p, y, x, c1, 0.3) for _ in range(2))
    f1, f2 = (fwd(p, x, c1, 0.3, y) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(z1, z2) and torch.equal(w1, w2)
    assert torch.equal(u1, u2) and torch.equal(f1, f2) and torch.equal(u1, f1)
    assert rel_err(z1, getattr(spmv_wcoo, f"{pre}_adjoint_plain")(p, y)) < 1e-4
    u_ref, w_ref = getattr(spmv_wcoo, f"{pre}_pair_plain")(p, y, x, c1, 0.3)
    assert rel_err(u1, u_ref) < TOL and rel_err(w1, w_ref) < 1e-4
    assert spmv.launch_counts() == _only(**{f"{pre}_adjoint": 2, f"{pre}_pair": 2,
                                            f"{pre}_forward": 2})


#: the products whose sums by destination ran through index_add_ (float
#: atomics on the card) and now run in a fixed order; and BlockELL's two
#: products on a tall pattern, whose transpose rows are split across CTAs
#: and their slices added in a fixed order
FIXED_ORDER = ["coo", "coo complex", "jdia remainder", "block pair", "block tall"]


def _fixed_order_case(rng, kind, device):
    """(operator on ``device``, right-hand side, solve keywords)."""
    if kind.startswith("coo"):
        m, n = 40_000, 2000
        vals, rows, cols = zipf_column_coo(m, n, 8 * m, seed=21)
        if kind == "coo complex":
            vals = (vals + 1j * np.random.default_rng(21).standard_normal(vals.size)).astype(
                np.complex64)
        A = lt.coo_operator(m, n, vals, rows, cols, device=device)
        kw = {}
    elif kind == "jdia remainder":
        m = n = 40_000
        A = lt.jdia_operator(m, n, *jittered_band_coo(m, n, outliers=0.05, seed=22,
                                                      diag=12.0), device=device)
        assert A.rem_vals.shape[0] > 1000
        kw = {}
    elif kind == "block pair":
        m, n = 5000, 4100
        A = lt.block_ell_operator(m, n, *random_block_coo(m, n, seed=23, diag=2.0),
                                  device=device)
        kw = dict(pair=True)
    else:  # 120 block rows over 3 block columns: the transpose has kt = 120
        m, n = 15_355, 364
        A = lt.block_ell_operator(m, n, *random_block_coo(m, n, seed=24, diag=2.0),
                                  device=device)
        kw = {}
    b = rng.standard_normal(m).astype(np.complex64 if A.dtype.is_complex else np.float32)
    return A, torch.from_numpy(b).to(device), kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FIXED_ORDER)
def test_cuda_fixed_order_products_are_bit_stable(rng, cuda_device, kind):
    """The COO products, JDIA's remainder and BlockELL's block-column sum of
    the pair give the same bits over two calls and two solves, and agree
    with the same operator on the CPU."""
    A, b, kw = _fixed_order_case(rng, kind, cuda_device)
    H, bh, _ = _fixed_order_case(np.random.default_rng(0), kind, DEV)
    dt = A.dtype
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).to(dt).to(cuda_device)
    if kind == "block pair":
        c1 = torch.tensor(0.7, device=cuda_device)
        (u1, z1), (u2, z2) = (A.fused_pair(y=b, win=x, c1=c1, c2=0.3) for _ in range(2))
        u_h, z_h = H.fused_pair(y=b.cpu(), win=x.cpu(), c1=0.7, c2=0.3)
        torch.cuda.synchronize()
        assert torch.equal(u1, u2) and torch.equal(z1, z2)
        assert rel_err(u1, u_h) < TOL and rel_err(z1, z_h) < 1e-4
    else:
        f1, f2 = A.matvec(x), A.matvec(x)
        a1, a2 = A.rmatvec(b), A.rmatvec(b)
        torch.cuda.synchronize()
        assert torch.equal(f1, f2) and torch.equal(a1, a2)
        for got, ref in ((f1, H.matvec(x.cpu())), (a1, H.rmatvec(b.cpu()))):
            got = got.cpu()  # complex kept
            assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4
    r1, r2 = (lt.lsqr(A, b, 0.01, atol=1e-6, btol=1e-6, **kw) for _ in range(2))
    assert int(r1.itn) == int(r2.itn) and torch.equal(r1.x, r2.x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 2 ** 18), (1_000_003,), (64, 4096), (3,)])
def test_cuda_stream_copy_matches_twin_bit_for_bit(cuda_device, shape):
    from lsqr_tpu_torch.ops import roofline

    x = torch.randn(shape, device=cuda_device)
    ref = x.clone()
    spmv.reset_launch_counts()
    for _ in range(3):
        assert lt.stream_copy(x) is x
        roofline.stream_copy_plain(ref)
    torch.cuda.synchronize()
    assert torch.equal(x, ref)
    assert spmv.launch_counts() == _only(stream_copy=3)
    with pytest.raises(TypeError):
        lt.stream_copy(x.double())


@pytest.mark.cuda
def test_cuda_stream_ceiling_runs_through_the_kernel(cuda_device):
    spmv.reset_launch_counts()
    gbs = lt.stream_ceiling(cuda_device, rows=256, cols=1 << 16, k=3)
    assert spmv.launch_counts() == _only(stream_copy=4)  # a warm-up and k
    assert 0 < gbs < 1e5


ZCASES = [
    (300, 300, (-2, -1, 0, 1, 2)),
    (330, 200, (-60, -3, 0, 5)),
    (200, 330, (0, 1, 7)),
    (257, 129, (0,)),
    (70_001, 50_003, (-2, -1, 0, 1, 2)),
] + WIDE


def _crel(got, ref):
    """rel_err of complex tensors, over their (re, im) pairs."""
    return rel_err(torch.view_as_real(got), torch.view_as_real(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,ks", ZCASES)
def test_cuda_zdia_kernels_match_twins(rng, cuda_device, m, n, ks):
    """zdia_pair (one launch, or two for a halo above 1024) and the ZDIA
    products (four dia_matvec launches each) against their twins."""
    stripes = lt.zdia_stripes(m, n, ks, seed=int(rng.integers(1 << 30)), device=DEV)
    Ah = lt.dia_operator_device(m, n, ks, stripes)
    A = lt.dia_operator_device(m, n, ks, stripes.to(cuda_device))
    assert isinstance(A, lt.ZDIAOperator) and A.prefers_pair and not Ah.prefers_pair
    win = torch.randn(n, dtype=torch.complex64)
    y = torch.randn(m, dtype=torch.complex64)
    c1 = torch.tensor(0.8, device=cuda_device)  # a device scalar, as in the solver
    spmv.reset_launch_counts()
    u, z = A.fused_pair(y=y.to(cuda_device), win=win.to(cuda_device), c1=c1, c2=1.1)
    ur, zr = spmv.zdia_pair_plain(Ah.dr, Ah.di, y, win, 0.8, 1.1, offsets=ks, m=m, n=n)
    fwd, adj = A.matvec(win.to(cuda_device)), A.rmatvec(y.to(cuda_device))
    torch.cuda.synchronize()
    assert u.dtype == z.dtype == fwd.dtype == torch.complex64
    assert _crel(u, ur) < TOL and _crel(z, zr) < TOL
    assert _crel(fwd, Ah.matvec(win)) < TOL and _crel(adj, Ah.rmatvec(y)) < TOL
    wide = max(spmv._halos(ks)) > spmv.PAIR_MAX_HALO
    assert spmv.launch_counts() == _only(zdia_pair=2 if wide else 1, dia_matvec=8)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", CASES + WIDE)
def test_cuda_fused_halfstep_variants_match_twins(rng, cuda_device, m, n, ks, storage):
    """v2 (both ssq_out values) and v3 on both stripe arrays: out in the
    stripes' dtype, ssq of the unrounded sum, the same from run to run; out
    bit-equal to the direct kernel's (tile 0), ssq within 1e-5 of it."""
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    Ah = lt.dia_operator(m, n, ks, data, storage_dtype=storage, device=DEV)
    A = lt.DIAOperator(data=Ah.data.to(cuda_device), tdata=Ah.tdata.to(cuda_device),
                       m=m, n=n, offsets=ks)
    v, y = _vectors(rng, m, n)
    c1 = torch.tensor(0.8, device=cuda_device)
    spmv.reset_launch_counts()
    for stripes, hs, kw, vec, yy in (
            (A.data, Ah.data, dict(offsets=ks, m=m, n=n), v, y),
            (A.tdata, Ah.tdata, dict(offsets=Ah.toffsets, m=n, n=m), y, v)):
        ref_out, ref_ssq = spmv.dia_fused_halfstep_plain(hs, yy, vec, 0.8, 1.3, **kw)
        for fn, extra in ((spmv.dia_fused_halfstep_v2, dict(ssq_out="vmem")),
                          (spmv.dia_fused_halfstep_v2, dict(ssq_out="smem")),
                          (spmv.dia_fused_halfstep_v3, {})):
            out, ssq = fn(stripes, yy.to(cuda_device), vec.to(cuda_device), c1, 1.3, **kw,
                          **extra)
            again = fn(stripes, yy.to(cuda_device), vec.to(cuda_device), c1, 1.3, **kw,
                       **extra)[1]
            direct = spmv._halfstep_launch(fn, stripes, yy.to(cuda_device),
                                           vec.to(cuda_device), c1, 1.3, tile=0, **kw)
            torch.cuda.synchronize()
            assert out.dtype == ref_out.dtype == stripes.dtype and ssq.shape == ()
            assert rel_err(out, ref_out) < (1e-2 if storage == "bfloat16" else TOL)
            np.testing.assert_allclose(float(ssq), float(ref_ssq), rtol=1e-5)
            assert torch.equal(ssq, again)  # a fixed summation order
            assert torch.equal(out, direct[0])
            np.testing.assert_allclose(float(ssq), float(direct[1]), rtol=1e-5)
    suffix = "" if storage == "float32" else "[bf16]"
    counts = spmv.launch_counts(by_variant=True)
    assert counts["dia_fused_halfstep_v2" + suffix] == 12
    assert counts["dia_fused_halfstep_v3" + suffix] == 6


#: the staged fused half-step's edges: m, n not multiples of 8 (every packed
#: row at a 16-byte phase of its own, f32 and bf16), m != n both ways, m one
#: tile of 1024 exactly, one row past it, and below one tile, 81 diagonals
#: (bf16 tiles of 256; f32 takes the direct kernel by rule), a band past
#: PAIR_MAX_HALO, and the ragged shape of chip_smoke.py's phase 1
HALFSTEP_CASES = [
    (4099, 2053, (-7, -3, 0, 1, 5)),
    (2053, 4099, (-7, -3, 0, 1, 5)),
    (1024, 1000, (-3, 0, 2)),
    (1025, 1030, (-3, 0, 2)),
    (301, 203, (-7, -3, 0, 1, 5)),
    (3001, 2001, tuple(range(-40, 41))),
    (5000, 4000, (-1500, -2, 0, 3, 1100)),
    (65_536, 65_536, tuple(range(-5, 6))),
    (300_001, 200_003, (-60, -3, 0, 5)),
]


def _halfstep_calls(A, v, y):
    """(stripes, y, vector, keywords) of the fused half-step on both packed
    arrays: data (out has m rows) and tdata (n rows, the offsets negated)."""
    return [(A.data, y, v, dict(offsets=A.offsets, m=A.m, n=A.n, offsets_t=A.offsets_t)),
            (A.tdata, v, y, dict(offsets=A.toffsets, m=A.n, n=A.m, offsets_t=A.toffsets_t))]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", HALFSTEP_CASES)
def test_cuda_staged_fused_halfsteps_match_the_direct_kernel(rng, cuda_device, m, n, ks,
                                                            storage):
    """v2 and v3 through the route the wrappers take (the staged kernel in
    tiles of halfstep_tile; f32 at 81 diagonals the direct kernel) and the
    staged kernel forced to tiles of 256, on data and tdata: out bit-equal
    to the direct kernel's (tile 0: one thread an output, the same order and
    expression) and equal from run to run and for vectors off the 16-byte
    grid (the wrapper copies them); ssq within 1e-5 of the direct kernel's
    and the twin's, and bit-equal from run to run (one slot a tile, added in
    a fixed order)."""
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    A = lt.dia_operator(m, n, ks, data, storage_dtype=storage, device=cuda_device)
    v, y = (t.to(cuda_device) for t in _vectors(rng, m, n))
    c1 = torch.tensor(0.8, device=cuda_device)
    tile = spmv.halfstep_tile(len(ks), *spmv._halos(ks), A.data.dtype.itemsize,
                              *spmv._smem_limits(cuda_device))
    assert tile > 0 or (storage == "float32" and len(ks) == 81)
    spmv.reset_launch_counts()
    for fn in (spmv.dia_fused_halfstep_v2, spmv.dia_fused_halfstep_v3):
        for stripes, yy, vec, kw in _halfstep_calls(A, v, y):
            plain_kw = {k: a for k, a in kw.items() if k != "offsets_t"}
            (out, ssq), (out2, ssq2) = (fn(stripes, yy, vec, c1, 1.3, **kw) for _ in range(2))
            yo, vo = (torch.cat([t.new_zeros(1), t])[1:] for t in (yy, vec))
            assert yo.data_ptr() % 16 and vo.data_ptr() % 16
            off_out, off_ssq = fn(stripes, yo, vo, c1, 1.3, **kw)
            d_out, d_ssq = spmv._halfstep_launch(fn, stripes, yy, vec, c1, 1.3, tile=0, **kw)
            f_out, f_ssq = spmv._halfstep_launch(fn, stripes, yy, vec, c1, 1.3, tile=256, **kw)
            r_out, r_ssq = spmv.dia_fused_halfstep_plain(stripes.cpu(), yy.cpu(), vec.cpu(),
                                                         0.8, 1.3, **plain_kw)
            torch.cuda.synchronize()
            assert out.dtype == stripes.dtype and out.shape == r_out.shape
            assert torch.equal(out, d_out) and torch.equal(out, f_out)
            np.testing.assert_allclose(float(f_ssq), float(d_ssq), rtol=1e-5)
            assert torch.equal(out, out2) and torch.equal(out, off_out)
            assert torch.equal(ssq, ssq2) and torch.equal(ssq, off_ssq)
            np.testing.assert_allclose(float(ssq), float(d_ssq), rtol=1e-5)
            np.testing.assert_allclose(float(ssq), float(r_ssq), rtol=1e-5)
    suffix = "" if storage == "float32" else "[bf16]"
    counts = spmv.launch_counts(by_variant=True)
    assert counts["dia_fused_halfstep_v2" + suffix] == counts[
        "dia_fused_halfstep_v3" + suffix] == 10
    assert sum(spmv.launch_counts().values()) == 20


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_fused_halfsteps_take_the_staged_route_at_the_main_shape(cuda_device, storage):
    """At chip_smoke.py's main shape (m = n = 2^23, offsets -5..5) both
    variants take the staged kernel in tiles of 1024 (one slot a tile:
    8192), and out is bit-equal to the direct kernel's."""
    m, ks = 2 ** 23, tuple(range(-5, 6))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((len(ks), m), generator=g, device=cuda_device)
    y, v = (torch.randn(m, generator=g, device=cuda_device) for _ in range(2))
    A = lt.dia_operator_device(m, m, ks, data, storage_dtype=getattr(torch, storage))
    assert spmv._halfstep_rule(A.data, ks) == 1024
    kw = dict(offsets=ks, m=m, n=m, offsets_t=A.offsets_t)
    for fn in (spmv.dia_fused_halfstep_v2, spmv.dia_fused_halfstep_v3):
        out, ssq = fn(A.data, y, v, 0.8, 1.1, **kw)
        d_out, d_ssq = spmv._halfstep_launch(fn, A.data, y, v, 0.8, 1.1, tile=0, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, d_out)
        np.testing.assert_allclose(float(ssq), float(d_ssq), rtol=1e-5)


@pytest.mark.cuda
def test_cuda_staged_fused_halfsteps_refuse_unaligned_stripes(rng, cuda_device):
    """The staged half-step copies the stripes in 16-byte pieces: stripes off
    the grid are refused (the vectors are copied instead), and the direct
    kernel (tile 0) takes them."""
    m, n, ks = 300, 300, (-1, 0, 1)
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    big = torch.zeros(data.size + 1, device=cuda_device)
    big[1:] = torch.from_numpy(np.ascontiguousarray(data)).reshape(-1).to(cuda_device)
    off = big[1:].view(len(ks), m)
    v, y = (t.to(cuda_device) for t in _vectors(rng, m, n))
    kw = dict(offsets=ks, m=m, n=n)
    for fn in (spmv.dia_fused_halfstep_v2, spmv.dia_fused_halfstep_v3):
        with pytest.raises(ValueError, match="aligned"):
            fn(off, y, v, 1.0, 1.0, **kw)
        got = spmv._halfstep_launch(fn, off, y, v, 1.0, 1.0, tile=0, **kw)
        ref = fn(off.clone(), y, v, 1.0, 1.0, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0])


@pytest.mark.cuda
def test_cuda_complex_solves_run_through_zdia_pair(rng, cuda_device):
    """A complex f32 solve on the card: auto_operator routes the complex
    banded triplets to ZDIA, lsqr takes zdia_pair once per iteration run,
    and the answer agrees with the same solve on the CPU; lsmr, cgls
    (pair=True) and craig take the kernel too."""
    m = n = 100_000
    ks = (-2, -1, 0, 1, 2)
    stripes = lt.zdia_stripes(m, n, ks, seed=11, diag=12.0, device=DEV).numpy()
    i = np.arange(m)
    ok = [(i + k >= 0) & (i + k < n) for k in ks]
    vals = np.concatenate([stripes[d][ok[d]] for d in range(len(ks))])
    rows = np.concatenate([i[ok[d]] for d in range(len(ks))])
    cols = np.concatenate([i[ok[d]] + k for d, k in enumerate(ks)])
    A = lt.auto_operator(m, n, vals, rows, cols, device=cuda_device)
    Ah = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert isinstance(A, lt.ZDIAOperator) and A.prefers_pair and A.offsets == ks
    b = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    kw = dict(atol=1e-6, btol=1e-6)
    ref = lt.lsqr(Ah, b, 0.01, **kw)
    spmv.reset_launch_counts()
    res = lt.lsqr(A, torch.from_numpy(b).to(cuda_device), 0.01, **kw)
    seg = lt.LSQROptions().loop_segment
    assert spmv.launch_counts() == _only(zdia_pair=-(-int(res.itn) // seg) * seg,
                                         dia_matvec=4)
    assert res.x.dtype == torch.complex64 and res.rnorm.dtype == torch.float32
    assert int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 2
    assert _crel(res.x.cpu(), ref.x) < 1e-4
    bc = torch.from_numpy(b).to(cuda_device)
    for solve in (lambda: lt.lsmr(A, bc, 0.01, **kw),
                  lambda: lt.cgls(A, bc, 0.01, pair=True, **kw),
                  lambda: lt.craig(A, A.matvec(res.x), **kw)):
        spmv.reset_launch_counts()
        out = solve()
        assert spmv.launch_counts()["zdia_pair"] > 0 and int(out.istop) in (1, 2, 3)
        assert bool(torch.isfinite(torch.view_as_real(out.x)).all())


#: the staged half-step's edges: offsets with mixed odd phases (each
#: diagonal's adjoint piece at a 16-byte phase of its own) on m, n not
#: multiples of 8, m != n both ways, dim_out below one tile, 81 diagonals
#: (one block an SM in f32), halos past PAIR_MAX_HALO (the half-step takes
#: any), one-sided bands
AXPY_CASES = [
    (4099, 2053, (-7, -3, 0, 1, 5)),
    (2053, 4099, (-7, -3, 0, 1, 5)),
    (301, 203, (-7, -3, 0, 1, 5)),
    (3001, 2001, tuple(range(-40, 41))),
    (5000, 4000, (-1500, -2, 0, 3, 1100)),
    (70_001, 90_003, (-1024, -1, 2, 700)),
    (3001, 2003, (-9, -4, 0)),
    (2003, 3001, (0, 3, 11)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("m,n,ks", AXPY_CASES)
def test_cuda_staged_halfstep_matches_twin_and_is_bit_stable(rng, cuda_device, m, n, ks,
                                                            adjoint, storage):
    """The staged half-step against its twin; two calls, vectors that are
    views off the 16-byte grid (the wrapper copies them) and the direct
    kernel (one thread an output, the same order) give the same bits."""
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    Ah = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage, device=DEV)
    dp = Ah.dp.to(cuda_device)
    v, y = _vectors(rng, m, n)
    vec, out = (y, v) if adjoint else (v, y)
    dvec, dout = vec.to(cuda_device), out.to(cuda_device)
    kw = dict(offsets=ks, m=m, n=n, adjoint=adjoint)
    c1 = torch.tensor(0.8, device=cuda_device)
    tile = spmv.axpy_tile(len(ks), *spmv._halos(ks), dp.dtype.itemsize,
                          *spmv._smem_limits(cuda_device))
    assert tile > 0
    spmv.reset_launch_counts()
    first, again = (spmv.dia_product_shared_axpy(dp, dvec, dout, c1, 1.3, **kw)
                    for _ in range(2))
    vo, yo = (torch.cat([t.new_zeros(1), t])[1:] for t in (dvec, dout))
    assert vo.data_ptr() % 16 and yo.data_ptr() % 16
    off_grid = spmv.dia_product_shared_axpy(dp, vo, yo, c1, 1.3, **kw)
    direct = spmv._axpy_launch(dp, dvec, dout, c1, 1.3, tile=0, **kw)
    ref = spmv.dia_product_shared_axpy_plain(Ah.dp, vec, out, 0.8, 1.3, **kw)
    torch.cuda.synchronize()
    assert rel_err(first, ref) < TOL
    assert torch.equal(first, again) and torch.equal(first, off_grid)
    assert torch.equal(first, direct)
    suffix = "" if storage == "float32" else "[bf16]"
    assert spmv.launch_counts(by_variant=True)["dia_product_shared_axpy" + suffix] == 4
    assert spmv.launch_counts() == _only(dia_product_shared_axpy=4)


@pytest.mark.cuda
def test_cuda_staged_halfstep_refuses_unaligned_stripes(rng, cuda_device):
    """The staged kernels copy dp in 16-byte pieces: a dp off the grid is
    refused (the vectors are copied instead)."""
    m, n, ks = 300, 300, (-1, 0, 1)
    Ah = _operator(rng, m, n, ks)
    big = torch.zeros(Ah.dp.numel() + 1, device=cuda_device)
    big[1:] = Ah.dp.to(cuda_device)
    v, y = (t.to(cuda_device) for t in _vectors(rng, m, n))
    with pytest.raises(ValueError, match="aligned"):
        spmv.dia_product_shared_axpy(big[1:], v, y, 1.0, 1.0, offsets=ks, m=m, n=n,
                                     adjoint=False)


#: the staged products' edges: m, n not multiples of 8 (every packed row at
#: a 16-byte phase of its own, f32 and bf16), m != n both ways, dim_out below
#: one tile, 81 diagonals (tiles of 256), one-sided bands (the column side's
#: first and last diagonals past the stripes), bands past PAIR_MAX_HALO (a
#: +-1500 band), m a multiple of 8 (every row at one phase) and the ragged
#: shape of chip_smoke.py's phase 1
PRODUCT_CASES = [
    (4099, 2053, (-7, -3, 0, 1, 5)),
    (2053, 4099, (-7, -3, 0, 1, 5)),
    (301, 203, (-7, -3, 0, 1, 5)),
    (3001, 2001, tuple(range(-40, 41))),
    (3001, 2003, (-9, -4, 0)),
    (2003, 3001, (0, 3, 11)),
    (5000, 4000, (-1500, -2, 0, 3, 1100)),
    (2048, 2048, (-1500, 0, 1500)),
    (65_536, 65_536, tuple(range(-5, 6))),
    (300_001, 200_003, (-60, -3, 0, 5)),
]


def _product_calls(As, Ap, v, y):
    """(wrapper, stripes, vector, keywords) of every call of the two
    products: the shared forward and adjoint, the packed data forward, tdata
    forward (the operator's adjoint) and data's column side."""
    kw = dict(offsets=As.offsets, m=As.m, n=As.n)
    return [
        (spmv.dia_product_shared, As.dp, v, dict(kw, adjoint=False, offsets_t=As.offsets_t)),
        (spmv.dia_product_shared, As.dp, y, dict(kw, adjoint=True, offsets_t=As.offsets_t)),
        (spmv.dia_matvec, Ap.data, v, dict(kw, adjoint=False, offsets_t=Ap.offsets_t)),
        (spmv.dia_matvec, Ap.tdata, y, dict(offsets=Ap.toffsets, m=Ap.n, n=Ap.m,
                                            adjoint=False, offsets_t=Ap.toffsets_t)),
        (spmv.dia_matvec, Ap.data, y, dict(kw, adjoint=True, offsets_t=Ap.offsets_t)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", PRODUCT_CASES)
def test_cuda_staged_products_match_twins_and_the_direct_kernel(rng, cuda_device, m, n, ks,
                                                                storage):
    """Every call of the two products through the staged kernel against
    its twin; two calls, a vector off the 16-byte grid (the wrapper copies
    it) and the direct kernel (tile 0: one thread an output, the same
    order) give the same bits."""
    data, _ = banded(rng, m, n, ks, np.float32, dense=False)
    As = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage, device=cuda_device)
    Ap = lt.dia_operator(m, n, ks, data, storage_dtype=storage, device=cuda_device)
    v, y = (t.to(cuda_device) for t in _vectors(rng, m, n))
    tile = spmv.product_tile(len(ks), *spmv._halos(ks), Ap.data.dtype.itemsize,
                             *spmv._smem_limits(cuda_device))
    assert tile > 0
    spmv.reset_launch_counts()
    for wrapper, stripes, vec, kw in _product_calls(As, Ap, v, y):
        plain = (spmv.dia_product_shared_plain if wrapper is spmv.dia_product_shared
                 else spmv.dia_matvec_plain)
        first, again = (wrapper(stripes, vec, **kw) for _ in range(2))
        off = torch.cat([vec.new_zeros(1), vec])[1:]
        assert off.data_ptr() % 16
        off_grid = wrapper(stripes, off, **kw)
        direct = spmv._product_launch(wrapper, stripes, vec, tile=0, **kw)
        ref = plain(stripes.cpu(), vec.cpu(), **{k: a for k, a in kw.items() if k != "offsets_t"})
        torch.cuda.synchronize()
        assert first.dtype == torch.float32 and first.shape == ref.shape
        assert rel_err(first, ref) < TOL
        assert torch.equal(first, again) and torch.equal(first, off_grid)
        assert torch.equal(first, direct)
    assert spmv.launch_counts() == _only(dia_product_shared=8, dia_matvec=12)
    suffix = "" if storage == "float32" else "[bf16]"
    assert spmv.launch_counts(by_variant=True)["dia_matvec" + suffix] == 12


@pytest.mark.cuda
def test_cuda_staged_products_refuse_unaligned_stripes(rng, cuda_device):
    """The staged products copy the stripes in 16-byte pieces: stripes off
    the grid are refused (the vector is copied instead), and the direct
    kernel (tile 0) takes them; the operators copy such stripes once."""
    m, n, ks = 300, 300, (-1, 0, 1)
    Ah = _operator(rng, m, n, ks)
    v = _vectors(rng, m, n)[0].to(cuda_device)
    kw = dict(offsets=ks, m=m, n=n, adjoint=False)
    for wrapper, stripes in ((spmv.dia_product_shared, Ah.dp),
                             (spmv.dia_matvec, Ah.data.contiguous())):
        big = torch.zeros(stripes.numel() + 1, device=cuda_device)
        big[1:] = stripes.reshape(-1).to(cuda_device)
        off = big[1:].view(stripes.shape)
        with pytest.raises(ValueError, match="aligned"):
            wrapper(off, v, **kw)
        got = spmv._product_launch(wrapper, off, v, tile=0, **kw)
        ref = wrapper(stripes.to(cuda_device), v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    A = lt.DIAOperator(data=off, tdata=off, m=m, n=n, offsets=ks)
    assert A.data.data_ptr() % 16 == 0 and torch.equal(A.data, off)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "packed"])
def test_cuda_product_solves_are_bit_stable(rng, cuda_device, layout):
    """Solves whose products take the staged kernel each iteration (cgls,
    lsmr with pair=False, lsqr with fused=False) stop where a second run
    stops, with bit-equal x."""
    m = n = 200_003
    ks = tuple(range(-5, 6))
    data, _ = banded(rng, m, n, ks, np.float32, boost=12.0, dense=False)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    build = lt.dia_shared_operator if layout == "shared" else lt.dia_operator
    A = build(m, n, ks, data, device=cuda_device)
    wrapper = "dia_product_shared" if layout == "shared" else "dia_matvec"
    for solve, kw in ((lt.cgls, {}), (lt.lsmr, dict(pair=False)), (lt.lsqr, dict(fused=False))):
        spmv.reset_launch_counts()
        first = solve(A, b, 0.01, atol=1e-6, btol=1e-6, **kw)
        assert spmv.launch_counts()[wrapper] >= 2 * int(first.itn)
        again = solve(A, b, 0.01, atol=1e-6, btol=1e-6, **kw)
        assert int(first.istop) == int(again.istop) and int(first.itn) == int(again.itn)
        assert torch.equal(first.x, again.x)


#: the staged complex pair's edges: one-sided bands (lower, upper), ragged
#: m != n both ways, m below one tile, a halo whose span takes a larger tile
ZPAIR_CASES = [
    (3001, 2003, (-9, -4, 0)),
    (2003, 3001, (0, 3, 11)),
    (300_001, 200_003, (-60, -3, 0, 5)),
    (200_003, 300_001, (-5, 0, 3, 60)),
    (301, 203, (-2, 0, 1)),
    (257, 129, (0,)),
    (5003, 4001, (-300, -1, 0, 2, 200)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,ks", ZPAIR_CASES)
def test_cuda_staged_zdia_pair_matches_twin_and_is_bit_stable(rng, cuda_device, m, n, ks):
    """The staged complex pair (one launch) against its twin; two calls,
    vectors off the 16-byte grid and the two-launch route (u, then z from
    u: the same order) give the same bits."""
    stripes = lt.zdia_stripes(m, n, ks, seed=int(rng.integers(1 << 30)), device=DEV)
    Ah = lt.dia_operator_device(m, n, ks, stripes)
    A = lt.dia_operator_device(m, n, ks, stripes.to(cuda_device))
    win = torch.randn(n, dtype=torch.complex64)
    y = torch.randn(m, dtype=torch.complex64)
    dwin, dy = win.to(cuda_device), y.to(cuda_device)
    kw = dict(offsets=ks, m=m, n=n, offsets_t=A.offsets_t)
    c1 = torch.tensor(0.8, device=cuda_device)
    lo, hi = spmv._halos(ks)
    tile = spmv.zpair_tile(len(ks), lo, hi, *spmv._smem_limits(cuda_device))
    assert tile > 0
    spmv.reset_launch_counts()
    (u1, z1), (u2, z2) = (spmv.zdia_pair(A.dr, A.di, dy, dwin, c1, 1.1, **kw)
                          for _ in range(2))
    assert spmv.launch_counts() == _only(zdia_pair=2)
    yo, wo = (torch.cat([t.new_zeros(1), t])[1:] for t in (dy, dwin))
    assert torch.view_as_real(yo).data_ptr() % 16 and torch.view_as_real(wo).data_ptr() % 16
    u3, z3 = spmv.zdia_pair(A.dr, A.di, yo, wo, c1, 1.1, **kw)
    u4, z4 = spmv._zdia_pair_launch(A.dr, A.di, dy, dwin, c1, 1.1, tile=0, **kw)
    ur, zr = spmv.zdia_pair_plain(Ah.dr, Ah.di, y, win, 0.8, 1.1, offsets=ks, m=m, n=n)
    torch.cuda.synchronize()
    assert _crel(u1, ur) < TOL and _crel(z1, zr) < TOL
    for u, z in ((u2, z2), (u3, z3), (u4, z4)):
        assert torch.equal(u1, u) and torch.equal(z1, z)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_halfstep_solve_is_bit_stable(rng, cuda_device, storage):
    """The pair=False solve (two staged half-steps an iteration; bf16
    stripes: fused=True, as chip_smoke.py's phase 8 forces them) gives
    bit-equal x on a second run."""
    m = n = 200_003
    ks = tuple(range(-5, 6))
    data, _ = banded(rng, m, n, ks, np.float32, boost=12.0, dense=False)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    A = lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage, device=cuda_device)
    kw = dict(atol=1e-6, btol=1e-6, pair=False, fused=True)
    spmv.reset_launch_counts()
    first = lt.lsqr(A, b, 0.01, **kw)
    suffix = "" if storage == "float32" else "[bf16]"
    assert spmv.launch_counts(by_variant=True)["dia_product_shared_axpy" + suffix] > 0
    again = lt.lsqr(A, b, 0.01, **kw)
    assert int(first.istop) in (1, 2, 3) and int(first.istop) == int(again.istop)
    assert int(first.itn) == int(again.itn) and torch.equal(first.x, again.x)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "cgls"])
def test_cuda_damped_warm_start_and_checkpoint_are_bit_stable(rng, cuda_device, tmp_path,
                                                              solver):
    """A damped warm start (the stacked [A; damp I], two dia_product_shared
    launches an iteration) and a checkpointed LSQR solve, saved and resumed
    from disk between segments, on a shared-stripe operator: the same bits
    over two runs, the checkpointed one equal to the uninterrupted solve on
    its route (two products), and both within 1e-4 of the CPU twins'."""
    m = n = 20_000
    ks = (-3, 0, 1, 5)
    data, _ = banded(rng, m, n, ks, np.float32, boost=6.0, dense=False)
    A = lt.dia_shared_operator(m, n, ks, data, device=cuda_device)
    H = lt.dia_shared_operator(m, n, ks, data, device=DEV)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    x0 = 0.01 * torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    fn = getattr(lt, solver)
    kw = dict(atol=1e-6, btol=1e-6)
    spmv.reset_launch_counts()
    r1, r2 = (fn(A, b.to(cuda_device), 0.05, x0=x0.to(cuda_device), **kw) for _ in range(2))
    counts = spmv.launch_counts()
    assert counts["dia_product_shared"] > 0 and counts["dia_pair_shared"] == 0
    assert int(r1.itn) == int(r2.itn) and torch.equal(r1.x, r2.x)
    assert rel_err(r1.x.cpu(), fn(H, b, 0.05, x0=x0, **kw).x) < 1e-4
    if solver != "lsqr":
        return
    path = str(tmp_path / "state.npz")

    def stop(seg, carry):
        if seg >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        lt.lsqr_checkpointed(A, b.to(cuda_device), 0.05, segment_iters=4,
                             checkpoint_path=path, on_segment=stop, **kw)
    runs = [lt.lsqr_checkpointed(A, b.to(cuda_device), 0.05, segment_iters=4,
                                 resume_from=path, **kw) for _ in range(2)]
    whole = lt.lsqr_checkpointed(A, b.to(cuda_device), 0.05, segment_iters=4, **kw)
    plain = lt.lsqr(A, b.to(cuda_device), 0.05, pair=False, fused=False, **kw)
    for res in (runs[1], whole, plain):
        assert int(res.itn) == int(runs[0].itn) and int(res.istop) == int(runs[0].istop)
        assert torch.equal(res.x, runs[0].x)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [100_000, 100_003], ids=["aligned", "ragged"])
def test_cuda_multidamp_and_batch_are_their_standalone_solves(rng, cuda_device, m):
    """lsqr_multidamp / lsmr_multidamp (one pair launch an iteration for all
    damps) and lsqr_batch / lsmr_batch / cgls_batch (the kernels once a row)
    on a shared f32 band, and lsqr_batch on its f64 copy: each damp and
    each column bit for bit its standalone solve on the same route, rows on
    and off the 64-byte grid."""
    ks = tuple(range(-5, 6))
    data, _ = banded(rng, m, m, ks, np.float32, boost=12.0, dense=False)
    A = lt.dia_shared_operator(m, m, ks, data, device=cuda_device)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    damps = [0.0, 0.01, 1.0]
    tol = dict(atol=1e-6, btol=1e-6)
    for solver, routes in (("lsqr", ({}, dict(pair=False, fused=False))),
                           ("lsmr", ({}, dict(pair=False)))):
        for kw in routes:
            spmv.reset_launch_counts()
            res = getattr(lt, solver + "_multidamp")(A, b, damps, **tol, **kw)
            counts = spmv.launch_counts()
            for j, damp in enumerate(damps):
                ref = getattr(lt, solver)(A, b, damp, **tol, **kw)
                assert int(res.istop[j]) == int(ref.istop) and int(res.itn[j]) == int(ref.itn)
                assert torch.equal(res.x[j], ref.x), (solver, kw, damp)
            if kw:  # the plain products
                assert counts["dia_pair_shared"] == 0 and counts["dia_product_shared"] > 0
            else:  # one pair launch an iteration for every damp
                assert 0 < counts["dia_pair_shared"] <= int(res.itn.max()) + 64, counts
    B = torch.stack([b, -2 * b, b.flip(0)])
    for solver, kw in (("lsqr", {}), ("lsqr", dict(pair=False)), ("lsmr", {}),
                       ("cgls", dict(pair=True))):
        spmv.reset_launch_counts()
        res = getattr(lt, solver + "_batch")(A, B, damps, **tol, **kw)
        counts = spmv.launch_counts()
        for j, damp in enumerate(damps):
            ref = getattr(lt, solver)(A, B[j], damp, **tol, **kw)
            assert int(res.istop[j]) == int(ref.istop) and int(res.itn[j]) == int(ref.itn)
            assert torch.equal(res.x[j], ref.x), (solver, kw, j)
        kernel = "dia_product_shared_axpy" if kw == dict(pair=False) else "dia_pair_shared"
        assert counts[kernel] > 0, counts
    # f64 rows (the plain f64 products), whose reduction wants 32-byte rows
    A64 = lt.dia_shared_operator(m, m, ks, data.astype(np.float64), device=cuda_device)
    B64 = B.double()
    res = lt.lsqr_batch(A64, B64, damps, **tol)
    for j, damp in enumerate(damps):
        ref = lt.lsqr(A64, B64[j], damp, **tol)
        assert int(res.itn[j]) == int(ref.itn) and torch.equal(res.x[j], ref.x), ("f64", j)


@pytest.mark.cuda
def test_cuda_regpath_and_gradient(rng, cuda_device):
    """reg_sweep with the computed residual (dia_product_shared a damp) and
    lsqr_grad on an f64 shared band (normal_cg's two products an
    iteration) against the same on the CPU twins: the f32 residual norms
    within 1e-6 of ||b|| (the undamped one is below 1e-5 of ||b||, so its f32
    solves part in its leading digits), the f64 gradients within 1e-7."""
    m = 20_000
    ks = (-3, 0, 1, 5)
    data, _ = banded(rng, m, m, ks, np.float64, boost=6.0, dense=False)
    b = rng.standard_normal(m)
    runs = []
    for dev in (DEV, cuda_device):
        A32 = lt.dia_shared_operator(m, m, ks, data.astype(np.float32), device=dev)
        path = lt.reg_sweep(A32, b.astype(np.float32), [0.0, 0.01, 0.1], exact_residual=True,
                            atol=1e-6, btol=1e-6)
        stripes = torch.tensor(data, device=dev, requires_grad=True)
        vec = torch.tensor(b, device=dev, requires_grad=True)
        spmv.reset_launch_counts()
        x = lt.lsqr_grad(lt.dia_shared_operator(m, m, ks, stripes), vec, 0.05)
        torch.sum(x * x).backward()
        runs.append((path.residual_norm.cpu(), stripes.grad.cpu(), vec.grad.cpu()))
        if dev == cuda_device:
            assert spmv.launch_counts(by_variant=True)["dia_product_shared[f64]"] > 0
    (res_cpu, *grads_cpu), (res_card, *grads_card) = runs
    assert float((res_card - res_cpu).abs().max()) <= 1e-6 * np.linalg.norm(b)
    for got, want in zip(grads_card, grads_cpu):
        assert rel_err(got, want) < 1e-7


@pytest.mark.cuda
def test_cuda_complex_sweep_and_batch_are_their_standalone_solves(rng, cuda_device):
    """Complex rows on the card (ZDIA, complex64, the complex pair kernel
    once an iteration for the sweep and once a row for the batch): each
    damp and each column bit for bit its standalone solve, rows off the
    64-byte grid (m odd)."""
    m = 100_003
    Z = lt.dia_operator_device(m, m, range(-2, 3),
                               lt.zdia_stripes(m, m, diag=12.0, device=cuda_device))
    B = torch.from_numpy((rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m)))
                         .astype(np.complex64)).to(cuda_device)
    damps = [0.0, 0.01, 1.0]
    tol = dict(atol=1e-6, btol=1e-6)
    spmv.reset_launch_counts()
    sweep = lt.lsqr_multidamp(Z, B[0], damps, **tol)
    batch = lt.lsqr_batch(Z, B, damps, **tol)
    assert spmv.launch_counts()["zdia_pair"] > 0
    for j, damp in enumerate(damps):
        for res, b in ((sweep, B[0]), (batch, B[j])):
            ref = lt.lsqr(Z, b, damp, **tol)
            assert int(res.istop[j]) == int(ref.istop) and int(res.itn[j]) == int(ref.itn)
            assert torch.equal(res.x[j], ref.x), j


# ---------------------------------------------------------------------------
# The sharded solvers on the card (chip_smoke.py phase 21 at a small size)
# ---------------------------------------------------------------------------

#: sharded against unsharded x on the card, relative to the max (PERF.md
#: section 2's band for another route)
SHARD_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_cuda_sharded_solves_match_unsharded(cuda_device, tmp_path, world, backend):
    """One rank on NCCL, and two gloo ranks sharing the card: the banded,
    WCOO, 2-D and ZDIA sharded solves run their kernels on every rank and
    match the unsharded solves; all ranks' x are bit-equal."""
    import _torch_ranks as ranks

    pool = ranks.RankPool(world, tmp_path, backend=backend)
    try:
        results = pool.run(ranks.card_cases)
    finally:
        pool.close()
    kernels = {"dia": "dia_pair_shared", "wcoo": "wcoo_pair", "zdia": "zdia_pair"}
    for label, first in results[0].items():
        istop, itn, ref_itn, err, sha, launches, ref_istop = first
        assert itn == ref_itn == 24 and istop == ref_istop, (label, first)
        assert err <= SHARD_TOL, (label, err)
        for other in results[1:]:
            assert other[label][4] == sha, label
        if label in kernels:
            assert all(r[label][5].get(kernels[label], 0) > 0 for r in results), label


# ---------------------------------------------------------------------------
# Gradients to the operators' values on the card (chip_smoke.py phase 22 at
# a small size), and the port's examples
# ---------------------------------------------------------------------------

#: a leaf's gradient on the card against the CPU's, relative to its max:
#: f32 solves whose products sum in other orders, stopped on their own
GRAD_TOL = 1e-3


def _grad_layouts():
    from lsqr_tpu_torch.models.synthetic import jittered_band_coo, random_block_coo
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo as zipf

    return {
        "jdia": (lambda d, t: lt.jdia_operator(8192, 8192, *t, device=d),
                 jittered_band_coo(8192, 8192, diag=12.0, seed=3), ("data", "tdata"),
                 "jdia_matvec", 2.0),
        "block_ell": (lambda d, t: lt.block_ell_operator(2048, 2048, *t, device=d),
                      random_block_coo(2048, 2048, diag=2.0, seed=3), ("blocks", "tblocks"),
                      "block_ell_matvec", 2.0),
        "wcoo": (lambda d, t: lt.wcoo_operator(32768, 1024, *t, device=d),
                 zipf(32768, 1024, 100_000, seed=3), ("coo.vals",), "wcoo_adjoint", 30.0),
        "rwcoo": (lambda d, t: lt.rwcoo_operator(32768, 16384, *t, device=d),
                  zipf(32768, 16384, 100_000, seed=3), ("coo.vals",), "wwcoo_adjoint",
                  30.0),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["jdia", "block_ell", "wcoo", "rwcoo"])
def test_cuda_value_gradients_match_the_cpu(cuda_device, layout):
    """lsqr_grad's gradient to each stored value tensor of the layout on the
    card (the backward's CG through the product kernels) against the same
    on the CPU (the twins), damped so that both solves stop on their own."""
    build, trip, paths, kernel, damp = _grad_layouts()[layout]
    grads = {}
    for dev in (torch.device("cpu"), cuda_device):
        A = build(dev, trip)
        leaves = [functools.reduce(getattr, p.split("."), A) for p in paths]
        for t in leaves:
            t.requires_grad_(True)
        g = torch.Generator().manual_seed(5)
        b = torch.randn(A.m, generator=g).to(dev)
        w = torch.randn(A.n, generator=g).to(dev)
        info = {}
        x = lt.lsqr_grad(A, b, damp, atol=1e-6, btol=1e-6, itnlim=64, info=info)
        spmv.reset_launch_counts()
        got = torch.autograd.grad(torch.dot(x, w), leaves)
        if dev.type == "cuda":  # block_ell_matvec: either entry point's counter
            assert sum(v for k, v in spmv.launch_counts().items() if k.startswith(kernel)) > 0
        grads[dev.type] = [t.cpu() for t in got]
        assert info["istop"] in (1, 2, 3) and info["cg_itn"] < 100, info
    for path, cpu, card in zip(paths, grads["cpu"], grads["cuda"]):
        assert rel_err(card, cpu) < GRAD_TOL, path


EXAMPLES = sorted((__import__("pathlib").Path(__file__).resolve().parents[1]
                   / "examples_torch").glob("[0-9]*.py"))


@pytest.mark.cuda
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_cuda_examples_run(cuda_device, path):
    """Every example of examples_torch/ on the card (its default device)."""
    import os
    import subprocess
    import sys

    root = str(path.parents[1])
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run([sys.executable, str(path)], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip(), path.name
