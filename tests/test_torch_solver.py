"""The LSQR core of the PyTorch port against the JAX package: the
18-problem Paige–Saunders suite, the EZ tests, every istop path, wantse and
the trace, forced pair/fused modes and the banded slice end to end.

Both packages get the same numpy inputs; the port runs in float64 on the
CPU where JAX runs in x64, and in float32 where JAX runs f32 operators."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.models.paige_saunders import lstp as j_lstp
from lsqr_tpu_torch.models.paige_saunders import PaigeSaundersOperator

from _torch_parity import DEV, banded, banded_triplets, rel_err, shared_to_torch, to_np

CONFIGS = list(lt.suite_configs())


def _same_result(rj, rt, *, itn_band=0, rtol=1e-8, fields=("rnorm", "xnorm", "bnorm")):
    """istop equal, itn within the band, the estimates to rtol (and to 1e-12
    absolute, for residuals at rounding level on consistent systems)."""
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= itn_band, (int(rt.itn), int(rj.itn))
    for f in fields:
        np.testing.assert_allclose(float(getattr(rt, f)), float(getattr(rj, f)),
                                   rtol=rtol, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("m,n,nduplc,npower,damp", CONFIGS,
                         ids=[f"P_{m}x{n}_p{p}" for m, n, _, p, _ in CONFIGS])
def test_paige_saunders_suite_matches_jax(m, n, nduplc, npower, damp):
    """The reference stress suite (tests/test_suite.py) on the same stored
    operator in both packages.

    The iteration count is compared within a band: each problem has only
    min(m, n)/nduplc = 25 distinct singular values, so the Krylov space is
    spent by iteration ~25 and every later iteration runs on rounding
    error. A one-ulp change of one entry of b moves JAX's own count from
    158 to 141 (1000x1000, npower 3) and from 706 to 644 (npower 7), and
    the two packages sum their reductions in different orders."""
    eps = np.finfo(np.float64).eps
    prob = j_lstp(m, n, nduplc, npower, damp)
    At = PaigeSaundersOperator(*(torch.tensor(np.asarray(a))
                                 for a in (prob.A.hy, prob.A.hz, prob.A.d)))
    b = np.asarray(prob.b)
    assert int(lt.acheck(At).inform) == 0
    kw = dict(atol=eps**0.99, btol=eps**0.99, conlim=1000.0 * float(prob.acond),
              itnlim=4 * (m + n + 50))
    rj = lj.lsqr(prob.A, prob.b, damp, **kw)
    rt = lt.lsqr(At, b, damp, **kw)
    _same_result(rj, rt, itn_band=max(3, int(0.2 * int(rj.itn))), rtol=1e-6)
    xj = lj.xcheck(prob.A, b=prob.b, x=rj.x, damp=damp, anorm=rj.anorm)
    xt = lt.xcheck(At, b=b, x=rt.x, damp=damp, anorm=rt.anorm)
    assert int(xt.inform) == int(xj.inform)
    # the suite's accuracy criterion (lsqrtest_module.f90:236-241), with its
    # two documented failures (over-determined, npower 6 and 7)
    xtrue = np.asarray(prob.x_true)
    enorm = np.linalg.norm(to_np(rt.x) - xtrue) / (1.0 + np.linalg.norm(xtrue))
    assert enorm <= (0.2 if (m > n and npower >= 6) else 1e-3)


@pytest.mark.parametrize("m,n", [(80, 60), (40, 70)])
def test_lstp_generator_matches_jax(m, n):
    pj = j_lstp(m, n, 10, 3, 1e-3)
    pt = lt.lstp(m, n, 10, 3, 1e-3, dtype=torch.float64, device=DEV)
    for f in ("b", "x_true", "acond", "rnorm"):
        np.testing.assert_allclose(to_np(getattr(pt, f)), np.asarray(getattr(pj, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    for f in ("hy", "hz", "d"):
        np.testing.assert_allclose(to_np(getattr(pt.A, f)), np.asarray(getattr(pj.A, f)),
                                   rtol=1e-13, atol=1e-15, err_msg=f)


A3 = ([1.0, 4.0, 7.0, 2.0, 5.0, 88.0, 3.0, 66.0, 9.0],
      [0, 1, 2, 0, 1, 2, 0, 1, 2], [0, 0, 0, 1, 1, 1, 2, 2, 2])
A34 = ([4.1, 1.1, 11.1, 5.1, -3.1, 3.1, 66.1, 8.1, -87.1, 0.1, -9.1, 2.1],
       [0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2], [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3])


@pytest.mark.parametrize("m,n,coo", [(3, 3, A3), (3, 4, A34)], ids=["3x3", "3x4"])
def test_ez_solver_matches_jax(m, n, coo):
    rj = lj.LSQRSolver(m, n, *coo).solve([1.0, 2.0, 3.0])
    solver = lt.LSQRSolver(m, n, *coo, device=DEV)
    rt = solver.solve([1.0, 2.0, 3.0])
    assert int(rt.istop) == 1
    _same_result(rj, rt)
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-10, atol=1e-13)
    a = np.zeros((m, n))
    a[coo[1], coo[2]] = coo[0]
    assert np.abs(a @ to_np(rt.x) - [1.0, 2.0, 3.0]).max() <= 1e-12
    if m == n:
        np.testing.assert_allclose(to_np(rt.x), [1.242424, -6.060606e-2, -4.040404e-2],
                                   rtol=1e-5)
    assert int(solver.acheck().inform) == 0
    assert int(solver.xcheck([1.0, 2.0, 3.0], rt.x, anorm=rt.anorm).inform) == 1


def test_ez_zero_rhs_and_validation():
    rt = lt.LSQRSolver(3, 3, *A3, device=DEV).solve([0.0, 0.0, 0.0])
    assert int(rt.istop) == 0 and int(rt.itn) == 0 and not to_np(rt.x).any()
    assert rt.istop_message == lt.ISTOP_MESSAGES[0]
    with pytest.raises(ValueError):
        lt.LSQRSolver(m=2, n=3, a=[1.0], irow=[2], icol=[0], device=DEV)


def _diag(v):
    n = len(v)
    return np.asarray(v, float), np.arange(n), np.arange(n)


def _istop_cases(rng):
    dense40 = rng.standard_normal((40, 10))
    b40 = rng.standard_normal(40)
    dense60 = rng.standard_normal((60, 30))
    cond = np.logspace(0, 8, 50)
    return {
        # tests/test_istop_paths.py: one case per termination path
        "0_zero_rhs": (("coo", _diag([1.0, 2.0, 3.0])), np.zeros(3), 0.0, {}),
        "1_compatible": (("coo", _diag([2.0, 4.0, 5.0])), np.array([2.0, 8.0, 15.0]),
                         0.0, dict(atol=1e-10, btol=1e-10)),
        "2_least_squares": (("dense", dense40), b40, 0.0,
                            dict(atol=1e-9, btol=1e-9, itnlim=200)),
        "3_damped": (("dense", dense40), b40, 0.5, dict(atol=1e-9, btol=1e-9, itnlim=200)),
        "4_conlim": (("coo", _diag(cond)), cond * np.linspace(1, 2, 50), 0.0,
                     dict(conlim=100.0, itnlim=1000)),
        "5_itnlim": (("dense", dense60), rng.standard_normal(60), 0.0,
                     dict(atol=0.0, btol=0.0, itnlim=3)),
        "nconv3": (("dense", dense40), b40, 0.0, dict(atol=1e-8, btol=1e-8, nconv=3)),
        "plain_norms": (("dense", dense40), b40, 0.0,
                        dict(atol=1e-8, btol=1e-8, safe_norms=False)),
        "guards_only": (("dense", dense40[:30, :8]), b40[:30], 0.0,
                        dict(atol=0.0, btol=0.0, conlim=0.0, itnlim=10_000)),
    }


@pytest.mark.parametrize("case", list(_istop_cases(np.random.default_rng(0))))
def test_istop_paths_match_jax(case):
    (kind, a), b, damp, kw = _istop_cases(np.random.default_rng(0))[case]
    if kind == "coo":
        Aj = lj.coo_operator(len(b), len(b), *a)
        At = lt.coo_operator(len(b), len(b), *a, device=DEV)
    else:
        Aj, At = lj.DenseOperator(jnp.asarray(a)), lt.DenseOperator(torch.from_numpy(a))
    rj = lj.lsqr(Aj, b, damp, **kw)
    rt = lt.lsqr(At, b, damp, **kw)
    expect = case.split("_")[0]
    if expect.isdigit():
        assert int(rt.istop) == int(expect)
    if case == "4_conlim":
        # cond(A) = 1e8: the iterates lose orthogonality by iteration ~8 and
        # the two summation orders part (JAX rnorm 2.05e6, the port 2.31e6
        # at the same itn 12); the stop itself is the same
        _same_result(rj, rt, fields=("bnorm",))
        return
    _same_result(rj, rt, rtol=1e-6)
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-6, atol=1e-9)


def _banded_f64(rng, m=1500, n=1200, ks=(-3, -1, 0, 2, 5)):
    data, _ = banded(rng, m, n, ks, np.float64, boost=6.0)
    Aj = lj.dia_shared_operator(m, n, ks, data)
    return Aj, shared_to_torch(Aj), rng.standard_normal(m)


@pytest.mark.parametrize("damp", [0.0, 0.3])
def test_wantse_and_trace_match_jax(rng, damp):
    Aj, At, b = _banded_f64(rng)
    kw = dict(wantse=True, record_trace=True, atol=1e-6, btol=1e-6)
    rj, rt = lj.lsqr(Aj, b, damp, **kw), lt.lsqr(At, b, damp, **kw)
    _same_result(rj, rt, fields=("rnorm", "xnorm", "anorm", "acond", "arnorm", "dxmax"))
    assert int(rt.maxdx) == int(rj.maxdx)
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-8)
    np.testing.assert_allclose(to_np(rt.se), np.asarray(rj.se), rtol=1e-8)
    k = int(rj.itn)
    assert rt.trace.shape == rj.trace.shape
    np.testing.assert_allclose(to_np(rt.trace)[: k + 1], np.asarray(rj.trace)[: k + 1],
                               rtol=1e-8, atol=1e-300)
    assert not to_np(rt.trace)[k + 1:].any()


def test_warm_start_matches_jax(rng):
    Aj, At, b = _banded_f64(rng)
    x0 = rng.standard_normal(At.n)
    rj = lj.lsqr(Aj, b, x0=x0, atol=1e-8, btol=1e-8)
    rt = lt.lsqr(At, b, x0=x0, atol=1e-8, btol=1e-8)
    _same_result(rj, rt)
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-8)


def test_mixed_precision_scalars_match_jax(rng):
    m, n, ks = 1200, 1200, (-2, 0, 1, 4)
    data, _ = banded(rng, m, n, ks, np.float32, boost=5.0)
    Aj = lj.dia_shared_operator(m, n, ks, data)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-5, btol=1e-5, scalar_dtype="float64")
    rj, rt = lj.lsqr(Aj, b, 0.01, **kw), lt.lsqr(shared_to_torch(Aj), b, 0.01, **kw)
    assert rt.x.dtype == torch.float32 and rt.rnorm.dtype == torch.float64
    _same_result(rj, rt, itn_band=1, rtol=1e-5)
    with pytest.raises(ValueError, match="scalar_dtype"):
        lt.lsqr(shared_to_torch(Aj), b, fused=True, scalar_dtype="float64")


@pytest.mark.parametrize("mode", ["pair", "fused"])
def test_forced_pair_and_fused_f32_match_jax(rng, mode):
    """f32 shared operator: JAX's Pallas pair/axpy kernels (interpret mode)
    against the port's twins, each forced on."""
    m = n = 1500
    ks = (-2, -1, 0, 1, 3)
    data, _ = banded(rng, m, n, ks, np.float32, boost=6.0)
    Aj = lj.dia_shared_operator(m, n, ks, data)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-6, btol=1e-6)
    kw.update(pair=True) if mode == "pair" else kw.update(fused=True, pair=False)
    rj = lj.lsqr(Aj, b, 0.01, **kw)
    rt = lt.lsqr(shared_to_torch(Aj), b, 0.01, **kw)
    assert int(rt.istop) == int(rj.istop)
    assert abs(int(rt.itn) - int(rj.itn)) <= 2
    assert rel_err(rt.x, rj.x) < 1e-4


def test_banded_slice_end_to_end_matches_jax(rng):
    """The main path: COO triplets -> auto_operator -> lsqr, f32, in both."""
    m, n, ks = 2000, 2000, tuple(range(-5, 6))
    data, _ = banded(rng, m, n, ks, np.float32, boost=12.0)
    vals, rows, cols = banded_triplets(data, ks, n)
    b = rng.standard_normal(m).astype(np.float32)
    Aj = lj.auto_operator(m, n, vals, rows, cols)
    At = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert type(At).__name__ == type(Aj).__name__
    rj = lj.lsqr(Aj, b, 0.01, atol=1e-6, btol=1e-6)
    rt = lt.lsqr(At, b, 0.01, atol=1e-6, btol=1e-6)
    assert rt.x.dtype == torch.float32 and int(rt.istop) in (1, 2, 3)
    _same_result(rj, rt, itn_band=1, rtol=1e-5)
    assert rel_err(rt.x, rj.x) < 1e-5


def test_dtype_follows_inputs(rng):
    Aj, At, b = _banded_f64(rng, 300, 300, (-1, 0, 1))
    A32 = lt.DIASharedOperator(dp=At.dp.float(), m=At.m, n=At.n, offsets=At.offsets, H=At.H)
    assert lt.lsqr(A32, b.astype(np.float32), itnlim=2).x.dtype == torch.float32
    assert lt.lsqr(A32, b, itnlim=2).x.dtype == torch.float64  # promoted, as in JAX
    assert lt.lsqr(A32, b, itnlim=2, dtype="float32").x.dtype == torch.float32
    with pytest.raises(ValueError, match="length m"):
        lt.lsqr(A32, b[:-1])


def test_deferred_options_raise():
    A = lt.as_operator(np.eye(3), device=DEV)
    b = np.ones(3)
    with pytest.raises(NotImplementedError, match="item 8"):
        lt.lsqr(A, b, debug_log=True)
    # megakernel=True is ported (item 13); a dense operator is unsupported
    with pytest.raises(ValueError, match="megakernel=True requires"):
        lt.lsqr(A, b, megakernel=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        lt.lsqr(A, b, 0.1, x0=np.zeros(3))
    # complex solves are ported (item 12): b = (1+1j) * ones solves the identity
    xc = lt.lsqr(A, (1 + 1j) * b).x
    assert xc.dtype == torch.complex128 and np.allclose(xc.numpy(), (1 + 1j) * b)
    with pytest.raises(ValueError, match="fused_pair"):
        lt.lsqr(lt.coo_operator(3, 3, *_diag([1.0, 2.0, 3.0]), device=DEV), b, pair=True)
