"""The hand-written CUDA kernels of lsqr_tpu_torch against their plain
PyTorch twins, and the solve through them. Every test needs a CUDA device
and skips without one.

This file imports no JAX, so it also runs where JAX is absent. On the GPU
machine, without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import lsqr_tpu_torch as lt
from lsqr_tpu_torch.ops import spmv

from _torch_parity import DEV, banded, cuda_device, rel_err  # noqa: F401

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


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,ks", CASES + WIDE)
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
    wide = max(spmv._halos(ks)) > spmv.PAIR_MAX_HALO
    bf16 = storage == "bfloat16"
    expect = dict(dia_pair=0 if wide else 1, dia_matvec_axpy=(3 if wide else 2) + bf16,
                  dia_matvec=4 if wide else 3,
                  dia_fused_halfstep=int(storage == "float32"))
    assert spmv.launch_counts() == _only(**expect)
    suffix = "" if storage == "float32" else "[bf16]"
    assert spmv.launch_counts(by_variant=True)["dia_matvec" + suffix] == expect["dia_matvec"]


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
])
def test_cuda_block_ell_kernels_match_twins(rng, cuda_device, mb, kb, bh, bw, nb):
    blocks, bcols, x, y = _random_blocks(rng, mb, kb, bh, bw, nb, cuda_device)
    ref = spmv_sparse.block_ell_matvec_plain(blocks, bcols, x)
    spmv.reset_launch_counts()
    got = spmv_sparse.block_ell_matvec(blocks, bcols, x)
    torch.cuda.synchronize()
    assert rel_err(got, ref) < TOL
    for tr in (None, 1, 8):
        got = spmv_sparse.block_ell_matvec_windowed(blocks, bcols, x, tr=tr)
        torch.cuda.synchronize()
        assert rel_err(got, ref) < TOL
    c1 = torch.tensor(0.7, device=cuda_device)
    u, zp = spmv_sparse.block_ell_pair_windowed(blocks, bcols, x, y, c1, -1.3)
    u_ref, zp_ref = spmv_sparse.block_ell_pair_plain(blocks, bcols, x, y, c1, -1.3)
    torch.cuda.synchronize()
    assert rel_err(u, u_ref) < TOL and rel_err(zp, zp_ref) < TOL
    assert spmv.launch_counts() == _only(block_ell_matvec=1, block_ell_matvec_windowed=3,
                                         block_ell_pair_windowed=1)


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
