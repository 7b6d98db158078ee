"""The iteration megakernels of the PyTorch port against the JAX package.

On the CPU the port's ``megakernel=True`` routes run the kernels' plain
twins (``ops/megakernel*.py``), as JAX runs its Pallas megakernels in
interpret mode; both sides get the same numpy problem in f32. The shapes and
bounds are those of tests/test_megakernel.py, test_megakernel_lsmr.py and
test_megakernel_craig.py: istop equal, itn within 1 (f32 reduction order
can flip a borderline test by one iteration), x within rtol 1e-3 /
atol 1e-4. The CUDA kernels are held against the twins in
test_torch_cuda.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops import megakernel as jmk
from lsqr_tpu.ops import megakernel_craig as jmk_craig
from lsqr_tpu.ops import megakernel_lsmr as jmk_lsmr
from lsqr_tpu_torch.ops import megakernel as tmk
from lsqr_tpu_torch.ops import megakernel_craig as tmk_craig
from lsqr_tpu_torch.ops import megakernel_lsmr as tmk_lsmr
from lsqr_tpu_torch.ops import spmv

from _torch_parity import DEV, PORT_DIR, rel_err, to_np

OFFS = (-3, -1, 0, 2, 5)
SOLVERS = {  # name: (JAX megakernel, port megakernel, JAX regular, port regular)
    "lsqr": (jmk.lsqr_megakernel, lt.lsqr_megakernel, lj.lsqr, lt.lsqr),
    "lsmr": (jmk_lsmr.lsmr_megakernel, lt.lsmr_megakernel, lj.lsmr, lt.lsmr),
    "craig": (jmk_craig.craig_megakernel, lt.craig_megakernel, lj.craig, lt.craig),
}


def _problem(seed, m, n, boost, offs=OFFS, consistent=False, storage=None):
    """(JAX DIAOperator, port DIAOperator, b) from one numpy problem."""
    rng = np.random.default_rng(seed)
    stripes = rng.standard_normal((len(offs), m)).astype(np.float32)
    stripes[offs.index(0) if 0 in offs else 0] += boost
    Aj = lj.dia_operator(m, n, offs, stripes, use_pallas=False, storage_dtype=storage)
    At = lt.dia_operator(m, n, offs, stripes, storage_dtype=storage, device=DEV)
    if consistent:
        z = rng.standard_normal(n).astype(np.float32)
        b = np.asarray(Aj.matvec(jnp.asarray(z)))
    else:
        b = rng.standard_normal(m).astype(np.float32)
    return Aj, At, b


def _same(res, ref, rtol=1e-3, atol=1e-4, itn_band=1):
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= itn_band
    assert res.x.dtype == torch.float32
    np.testing.assert_allclose(to_np(res.x), np.asarray(ref.x), rtol=rtol, atol=atol)


def _args(solver, damp):
    return () if solver == "craig" else (damp,)


def _same_at_itn(solver, fn, At, b, damp, res, ref, **kw):
    """istop equal, itn within 1, and x to the bounds at the same iteration.
    Where the two stopped one iteration apart (a borderline test), the
    port's solve is re-run to exactly ref.itn iterations (its tests then fire
    only at itnlim) and x is held to 1e-3 of max|x|: on the nearly
    rank-deficient 3072 x 2048 LSMR problem single entries of the f32
    iterates move by 2e-4 with the summation order alone (ROADMAP Queue 3).
    Returns the port's result at ref.itn iterations."""
    if int(res.itn) != int(ref.itn):
        assert int(res.istop) == int(ref.istop)
        assert abs(int(res.itn) - int(ref.itn)) <= 1
        kw.update(itnlim=int(ref.itn), atol=0.0, btol=0.0)
        if solver != "craig":
            kw.update(conlim=0.0)
        res = fn(At, b, *_args(solver, damp), **kw)
        assert int(res.itn) == int(ref.itn)
        assert rel_err(res.x, ref.x) < 1e-3
        return res
    _same(res, ref)
    return res


@pytest.mark.parametrize("solver,m,n,damp", [
    ("lsqr", 2048, 2048, 0.0), ("lsqr", 2048, 2048, 0.05), ("lsqr", 3072, 2048, 0.0),
    ("lsqr", 2048, 3072, 0.0),
    ("lsmr", 2048, 2048, 0.0), ("lsmr", 2048, 2048, 0.05), ("lsmr", 3072, 2048, 0.0),
    ("lsmr", 2048, 3072, 0.0),
    ("craig", 2048, 2048, 0.0), ("craig", 2048, 3072, 0.0),
])
def test_megakernel_twin_matches_jax_megakernel(solver, m, n, damp):
    jfn, tfn, _, _ = SOLVERS[solver]
    Aj, At, b = _problem(m + n, m, n, 8.0 if solver == "craig" else 4.0,
                         consistent=solver == "craig")
    kw = dict(atol=1e-5, btol=1e-5, itnlim=150, iters_per_call=16)
    ref = jfn(Aj, b, *_args(solver, damp), interpret=True, **kw)
    res = tfn(At, b, *_args(solver, damp), **kw)
    # the norm estimates accumulate a term per iteration: compare them at
    # the same itn
    res = _same_at_itn(solver, tfn, At, b, damp, res, ref, iters_per_call=16)
    if solver == "lsqr":
        np.testing.assert_allclose(float(res.anorm), float(ref.anorm), rtol=1e-2)
        np.testing.assert_allclose(float(res.xnorm), float(ref.xnorm), rtol=1e-2)
        np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=5e-2, atol=1e-4)
    elif solver == "lsmr":
        np.testing.assert_allclose(float(res.normr), float(ref.normr), rtol=5e-2, atol=1e-5)
        np.testing.assert_allclose(float(res.norma), float(ref.norma), rtol=1e-2)
        np.testing.assert_allclose(float(res.normx), float(ref.normx), rtol=1e-2)
    else:
        np.testing.assert_allclose(float(res.xnorm), float(ref.xnorm), rtol=1e-4)
        np.testing.assert_allclose(float(res.anorm), float(ref.anorm), rtol=1e-2)


def test_megakernel_bf16_stripes_match_jax():
    Aj, At, b = _problem(42, 2048, 2048, 8.0, storage="bfloat16")
    assert At.is_bf16_storage and lt.megakernel_supported(At)
    kw = dict(atol=1e-4, btol=1e-4, iters_per_call=16)
    ref = jmk.lsqr_megakernel(Aj, b, 0.0, interpret=True, **kw)
    res = lt.lsqr_megakernel(At, b, 0.0, **kw)
    _same(res, ref)
    _same(res, lj.lsqr(Aj, b, 0.0, atol=1e-4, btol=1e-4))


@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
def test_megakernel_istop_boundary_carryover(solver):
    """A stop in the middle of a call masks the rest: K = 64 and K = 4 give
    bit-equal results."""
    _, At, b = _problem(3, 2048, 2048, 8.0, consistent=solver == "craig")
    fn = SOLVERS[solver][1]
    kw = dict(atol=1e-4, btol=1e-4, itnlim=100)
    r1 = fn(At, b, *_args(solver, 0.0), iters_per_call=64, **kw)
    r2 = fn(At, b, *_args(solver, 0.0), iters_per_call=4, **kw)
    assert int(r1.istop) == int(r2.istop) and int(r1.itn) == int(r2.itn) > 0
    assert torch.equal(r1.x, r2.x)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
def test_megakernel_b_zero(solver):
    _, At, _ = _problem(4, 2048, 2048, 4.0)
    res = SOLVERS[solver][1](At, np.zeros(2048, np.float32), *_args(solver, 0.0),
                             iters_per_call=4, itnlim=20)
    assert int(res.istop) == 0 and int(res.itn) == 0
    assert not res.x.any()


@pytest.mark.parametrize("solver,offs", [("lsqr", (0, 1, 2)), ("lsqr", (-2, -1, 0)),
                                         ("lsqr", (0,)), ("lsmr", (0, 1, 2)),
                                         ("lsmr", (-2, -1, 0))])
def test_megakernel_one_sided_offsets(solver, offs):
    _, jfn_reg, tfn = SOLVERS[solver][0], SOLVERS[solver][2], SOLVERS[solver][1]
    Aj, At, b = _problem(5, 2048, 2048, 8.0, offs=offs)
    ref = jfn_reg(Aj, b, atol=1e-4, btol=1e-4)
    res = tfn(At, b, atol=1e-4, btol=1e-4, iters_per_call=8)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(to_np(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("solver,m,n", [
    ("lsqr", 2500, 2500), ("lsqr", 2500, 1800), ("lsqr", 1800, 2500),
    ("lsmr", 2500, 2500), ("lsmr", 2500, 1800), ("lsmr", 1800, 2500),
    ("craig", 2500, 2500), ("craig", 1800, 2500),
])
def test_megakernel_ragged_shapes(solver, m, n):
    """m, n not multiples of anything: every read is masked by index."""
    _, tfn, jfn_reg, _ = SOLVERS[solver]
    Aj, At, b = _problem(m * 3 + n, m, n, 8.0, consistent=solver == "craig")
    ref = jfn_reg(Aj, b, atol=1e-5, btol=1e-5, itnlim=150)
    _same(tfn(At, b, atol=1e-5, btol=1e-5, itnlim=150, iters_per_call=8), ref)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr", "craig"])
def test_megakernel_x0_warm_start(solver):
    Aj, At, b = _problem(6, 2048, 2048, 8.0, consistent=solver == "craig")
    x0 = np.random.default_rng(60).standard_normal(2048).astype(np.float32) * 0.01
    _, tfn, jfn_reg, _ = SOLVERS[solver]
    ref = jfn_reg(Aj, b, *_args(solver, 0.0), atol=1e-5, btol=1e-5, x0=x0)
    warm = tfn(At, b, *_args(solver, 0.0), atol=1e-5, btol=1e-5, iters_per_call=16, x0=x0)
    _same(warm, ref)
    if solver != "craig":
        with pytest.raises(ValueError, match="damp == 0"):
            tfn(At, b, 0.1, x0=x0)


def test_megakernel_supported_gates():
    Aj, At, b = _problem(7, 2048, 2048, 4.0)
    gates = (lt.megakernel_supported, lt.lsmr_megakernel_supported,
             lt.craig_megakernel_supported)
    assert all(gate(At) for gate in gates)
    assert not lt.megakernel_supported(At, wantse=True)
    assert not lt.megakernel_supported(At, record_trace=True)
    assert not lt.lsmr_megakernel_supported(At, record_trace=True)
    # as in JAX: f64 stripes, other layouts and other operators are refused
    data = to_np(At.data).astype(np.float64)
    others = [lt.dia_operator(2048, 2048, OFFS, data, device=DEV),
              lt.dia_shared_operator(2048, 2048, OFFS, to_np(At.data), device=DEV),
              lt.as_operator(np.eye(4, dtype=np.float32), device=DEV)]
    for op in others:
        assert not any(gate(op) for gate in gates)
    assert jmk.megakernel_supported(Aj) and jmk_lsmr.lsmr_megakernel_supported(Aj)
    assert jmk_craig.craig_megakernel_supported(Aj)


def test_megakernel_option_routing():
    """megakernel=True routes each solver through its megakernel; None and
    False stay on the regular path; an unsupported configuration raises."""
    _, At, b = _problem(8, 2048, 2048, 8.0)
    _, _, bc = _problem(8, 2048, 2048, 8.0, consistent=True)
    kw = dict(atol=1e-5, btol=1e-5)
    for fn, direct, rhs in ((lt.lsqr, lt.lsqr_megakernel, b), (lt.lsmr, lt.lsmr_megakernel, b),
                            (lt.craig, lt.craig_megakernel, bc)):
        routed = fn(At, rhs, megakernel=True, **kw)
        assert torch.equal(routed.x, direct(At, rhs, **kw).x)
        regular = fn(At, rhs, **kw)
        for off in (None, False):
            assert torch.equal(fn(At, rhs, megakernel=off, **kw).x, regular.x)
        _same(routed, regular)
    shared = lt.dia_shared_operator(2048, 2048, OFFS, to_np(At.data), device=DEV)
    for call in (lambda: lt.lsqr(At, b, megakernel=True, record_trace=True),
                 lambda: lt.lsqr(At, b, megakernel=True, wantse=True),
                 lambda: lt.lsqr(At, b.astype(np.float64), megakernel=True),
                 lambda: lt.lsmr(At, b, megakernel=True, record_trace=True),
                 lambda: lt.lsmr(shared, b, megakernel=True),
                 lambda: lt.craig(shared, b, megakernel=True)):
        with pytest.raises(ValueError, match="megakernel=True requires"):
            call()


def test_megakernel_calls_run_twins_on_cpu_and_count_nothing():
    _, At, b = _problem(9, 500, 400, 8.0)
    spmv.reset_launch_counts()
    vectors, state = tmk.lsqr_megakernel_prepare(At, b, itnlim=100)
    twin = [t.clone() for t in (*vectors, state)]
    tmk.lsqr_megakernel_call(At.data, At.tdata, *vectors, state, offsets=At.offsets,
                             m=500, n=400, K=5)
    tmk.lsqr_megakernel_plain(At.data, At.tdata, *twin, offsets=At.offsets, m=500,
                              n=400, K=5)
    for a, t in zip((*vectors, state), twin):
        assert torch.equal(a, t)
    assert int(state[tmk.ITN]) == 5
    counts = spmv.launch_counts(by_variant=True)
    assert not any(counts.values())
    for name in ("lsqr_megakernel", "lsmr_megakernel", "craig_megakernel"):
        assert name in counts and f"{name}[bf16]" in counts
    with pytest.raises(ValueError, match="K must be"):
        tmk.lsqr_megakernel_call(At.data, At.tdata, *vectors, state, offsets=At.offsets,
                                 m=500, n=400, K=0)
    with pytest.raises(TypeError):
        tmk.lsqr_megakernel_call(At.data, At.tdata, vectors[0].double(), *vectors[1:], state,
                                 offsets=At.offsets, m=500, n=400, K=1)


@pytest.mark.parametrize("jax_mod,port_mod,enum", [
    (jmk, tmk, "lsqr_idx"), (jmk_lsmr, tmk_lsmr, "lsmr_idx"),
    (jmk_craig, tmk_craig, "craig_idx")])
def test_state_indices_match_jax_and_the_kernel_source(jax_mod, port_mod, enum):
    """The named state indices are the JAX package's, and the CUDA source's
    enum lists the same names in the same order."""
    src = (PORT_DIR / "csrc" / "megakernel.cu").read_text()
    body = re.search(r"namespace %s \{\s*enum : int \{([^}]*)\}" % enum, src).group(1)
    names = [nm.strip() for nm in body.split(",") if nm.strip()]
    assert len(names) == len(set(names)) and len(names) <= tmk.NSTATE
    for i, nm in enumerate(names):
        assert getattr(port_mod, nm) == getattr(jax_mod, nm) == i, nm


#: the card's shared memory an SM and a block (NVIDIA H100 80GB HBM3)
H100_SMEM = (233_472, 232_448)


@pytest.mark.parametrize("nd,lo,hi,T,esize,nbytes", [
    # the main band, f32: 2 x (11 x 516 x 4 + (528 + 512 + 4) x 4) + 16 x 12
    (11, 5, 5, 512, 4, 53_952),
    (11, 5, 5, 512, 2, 31_424),      # bf16 rows of 520: 2 x (11,440 + 4,176) + 192
    (53, 0, 0, 512, 4, 227_936),     # 2 x (53 x 2,064 + (516 + 516) x 4) + 16 x 56
    (106, 0, 0, 512, 2, 230_464),    # 2 x (106 x 1,040 + 4,128) + 16 x 108
    (1, 0, 0, 256, 4, 6_304),        # 2 x (260 x 4 + (260 + 256 + 4) x 4) + 16 x 4
    (3, 32_768, 32_768, 512, 4, 544_992),  # 2 x (6,192 + (66,052 + 516) x 4) + 64
])
def test_mk_stage_bytes(nd, lo, hi, T, esize, nbytes):
    """The staged phases' shared memory (csrc/megakernel.cu: MkLayout):
    MK_STAGES stages of nd rows of T + 16/esize stripe elements, the
    vector window (T + lo + hi + 3 floats rounded up to 4) and T + 4 floats
    of y, then four ints a diagonal (nd rounded up to 4)."""
    assert spmv.MK_STAGES == 2 and spmv.MK_STATIC_BYTES == 1280
    assert spmv.mk_stage_bytes(nd, lo, hi, T, esize) == nbytes


@pytest.mark.parametrize("nd,lo,hi,esize,tile", [
    (11, 5, 5, 4, 512),        # the main band
    (11, 5, 5, 2, 512),
    (53, 0, 0, 4, 512),        # the most f32 diagonals: 227,936 + 1,280 bytes
    (54, 0, 0, 4, 0),          # 232,064 + 1,280 > 232,448
    (106, 0, 0, 2, 512),       # the most bf16 diagonals: 230,464 + 1,280
    (107, 0, 0, 2, 0),
    (53, 5, 5, 4, 512),
    # the widest f32 window of 14 diagonals: 2 x (28,896 + (21,124 + 516) x 4)
    # + 256 + 1,280 = 232,448 bytes (the spread allows lo + hi = 20,992)
    (14, 10_304, 10_305, 4, 512),
    (14, 10_305, 10_305, 4, 0),
    # five diagonals spread to 512 + lo + hi = 7,680 = MK_SPREAD x 5 x 512
    (5, 3_584, 3_584, 4, 512),
    (5, 3_584, 3_585, 4, 0),
    (5, 3_584, 3_585, 2, 0),
    (3, 2_048, 2_048, 2, 512),     # offsets -2048, 0, 2048: 4,608 = 3 x 3 x 512
    (5, 4_096, 4_096, 4, 0),       # a 2-D Laplacian on a 4096-wide grid
    (3, 32_768, 32_768, 4, 0),     # offsets of +-m/2 at 2^16: the direct route
    (3, 32_768, 32_768, 2, 0),
])
def test_mk_tile(nd, lo, hi, esize, tile):
    """The staged phases' tile on the H100: MK_TILE (two outputs a thread)
    where its stages and the kernels' static shared memory fit one block
    and its vector window (T + lo + hi floats a tile) is at most MK_SPREAD
    times the direct route's vector reads (nd a tile output), else 0 (the
    direct route)."""
    assert spmv.MK_TILE == 512 and spmv.MK_SPREAD == 3
    assert spmv.mk_tile(nd, lo, hi, esize, H100_SMEM[1]) == tile
    fits = spmv.mk_stage_bytes(nd, lo, hi, spmv.MK_TILE, esize) + spmv.MK_STATIC_BYTES
    dense = spmv.MK_TILE + lo + hi <= spmv.MK_SPREAD * nd * spmv.MK_TILE
    assert (fits <= H100_SMEM[1] and dense) == bool(tile)


def test_mk_grid_cache_is_keyed_on_the_route(monkeypatch):
    """The cooperative grid is asked with the route's shared memory: its
    cache keys on nd, lo + hi and the tile, so a band that takes the direct
    route is not given the staged one's grid."""
    import contextlib

    from lsqr_tpu_torch.ops import _cuda

    calls = []

    class Library:
        @staticmethod
        def lsqr_mk_grid(solver, bf16, dim, nd, halo, tile, blocks):
            calls.append((solver, bf16, dim, nd, halo, tile))
            blocks._obj.value = 132 * (4 if tile else 6)
            return 0

    monkeypatch.setattr(_cuda, "library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(spmv, "_smem_limits", lambda device: H100_SMEM)
    tmk._grid_cached.cache_clear()
    try:
        stripes = torch.zeros(1, dtype=torch.bfloat16)
        main = tuple(range(-5, 6))
        far = (-2 ** 15, 0, 2 ** 15)
        assert tmk.route("lsqr", stripes, main, 2 ** 23, 2 ** 23) == (512, 528)
        assert tmk.route("lsqr", stripes, main, 2 ** 23, 2 ** 23) == (512, 528)
        assert tmk.route("lsqr", stripes, far, 2 ** 16, 2 ** 16) == (0, 792)
        assert tmk.route("lsmr", stripes.float(), main, 2 ** 23, 2 ** 23) == (512, 528)
        assert calls == [(0, 1, 2 ** 23, 11, 10, 512), (0, 1, 2 ** 16, 3, 2 ** 16, 0),
                         (1, 0, 2 ** 23, 11, 10, 512)]
    finally:
        tmk._grid_cached.cache_clear()


@pytest.mark.parametrize("solver,m,n", [("lsqr", 2501, 1803), ("lsmr", 2501, 1803),
                                        ("craig", 1803, 2501)])
def test_megakernel_bf16_ragged_twin_matches_jax_megakernel(solver, m, n):
    """bf16 stripes on m != n, neither a multiple of 8, with offsets whose
    rows sit at mixed 16-byte phases (the card's staged phases' edges): the
    twin against JAX's megakernel in interpret mode, to the bounds of
    test_megakernel_twin_matches_jax_megakernel."""
    jfn, tfn, _, _ = SOLVERS[solver]
    offs = (-7, -3, 0, 1, 5)
    Aj, At, b = _problem(m * 7 + n, m, n, 8.0 if solver == "craig" else 4.0, offs=offs,
                         consistent=solver == "craig", storage="bfloat16")
    assert At.is_bf16_storage
    kw = dict(atol=1e-5, btol=1e-5, itnlim=150, iters_per_call=16)
    ref = jfn(Aj, b, *_args(solver, 0.0), interpret=True, **kw)
    res = tfn(At, b, *_args(solver, 0.0), **kw)
    _same_at_itn(solver, tfn, At, b, 0.0, res, ref, iters_per_call=16)
