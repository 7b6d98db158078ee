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

from _torch_parity import banded, cuda_device, rel_err  # noqa: F401

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


def _operator(rng, m, n, ks, dtype=np.float32):
    data, _ = banded(rng, m, n, ks, dtype, dense=False)
    return lt.dia_shared_operator(m, n, ks, data)


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
    assert spmv.launch_counts() == {"dia_pair_shared": 1, "dia_product_shared": 2,
                                    "dia_product_shared_axpy": 2}


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
    assert spmv.launch_counts() == {"dia_pair_shared": 0, "dia_product_shared": 1,
                                    "dia_product_shared_axpy": 1}


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(rng, cuda_device):
    m, n, ks = 300, 300, (-1, 0, 1)
    data = rng.standard_normal((3, m)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="bf16"):
        lt.dia_shared_operator(m, n, ks, data, storage_dtype=torch.bfloat16,
                               device=cuda_device)
    A = lt.dia_shared_operator(m, n, ks, data, device=cuda_device)
    assert A.prefers_pair and A.prefers_fused
    kw = dict(offsets=ks, m=m, n=n)
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
    Ah = lt.dia_shared_operator(m, n, ks, data)
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
