"""The shared-stripe DIA layer of the PyTorch port against the JAX package:
geometry and stripe bytes, the three kernels' plain twins against the Pallas
kernels (interpret mode), the operator, ``auto_operator``'s layout choice
and CPU dispatch.
The kernels themselves are held against the twins in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.ops import pallas_spmv as jspmv
from lsqr_tpu.ops.structured import dia_shared_operator as j_shared
from lsqr_tpu_torch.ops import spmv

from _torch_parity import DEV, banded, banded_triplets, rel_err, shared_to_torch, to_np

# tests/test_dia_shared.py CASES: square, wide, tall, ragged single diagonal
CASES = [
    (300, 300, (-2, -1, 0, 1, 2)),
    (200, 330, (-3, 0, 7, 60)),
    (330, 200, (-60, -3, 0, 5)),
    (257, 129, (0,)),
]
# tests/test_pair.py shapes of the pair kernel
PAIR_CASES = [
    (4096, 4096, (-2, -1, 0, 1, 2)),
    (5000, 5000, (-3, 0, 5)),
    (3000, 2000, (-5, -1, 0, 2)),
    (2000, 3000, (0, 1, 7)),
]
# one-sided bands (lower, upper, and lower without the main diagonal) on
# ragged m != n both ways: the halos the card's staged pair takes one-sided
ONE_SIDED = [
    (3001, 2003, (-9, -4, 0)),
    (1999, 2501, (-6, -1)),
    (2501, 1803, (0, 3, 11)),
]
IDS = [f"{m}x{n}_nd{len(ks)}" for m, n, ks in CASES]
TOL = 5e-6  # f32, relative to the max: the two sides differ in rounding only


def _ops(rng, m, n, ks, dtype=np.float32):
    data, dense = banded(rng, m, n, ks, dtype)
    Aj = j_shared(m, n, ks, data)
    return data, dense, Aj, shared_to_torch(Aj)


@pytest.mark.parametrize("m,n,ks", CASES + [(9_000_000, 5, (0, 3)),
                                            (5, 4_500_000, (-2,)),
                                            (10_000, 12_000, (-1000, 7))])
def test_geometry_matches_jax(m, n, ks):
    args = (ks, m, n, spmv._shared_tm(m), spmv._shared_tm(n))
    assert spmv.dia_shared_geometry(*args) == jspmv.dia_shared_geometry(
        ks, m, n, jspmv._shared_tm(m), jspmv._shared_tm(n))
    assert spmv._shared_tm(m) == jspmv._shared_tm(m)


@pytest.mark.parametrize("m,n,ks", CASES, ids=IDS)
def test_stripes_byte_equal_to_jax(rng, m, n, ks):
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    Aj = j_shared(m, n, ks, data)
    At = lt.dia_shared_operator(m, n, ks, data, device=DEV)
    assert At.H == Aj.H and At.offsets == Aj.offsets
    assert to_np(At.dp).dtype == np.float32
    assert to_np(At.dp).tobytes() == np.asarray(Aj.dp).tobytes()


@pytest.mark.parametrize("m,n,ks", CASES, ids=IDS)
@pytest.mark.parametrize("adjoint", [False, True])
def test_product_twin_matches_pallas(rng, m, n, ks, adjoint):
    _, dense, Aj, At = _ops(rng, m, n, ks)
    vec = rng.standard_normal(m if adjoint else n).astype(np.float32)
    ref = jspmv.dia_product_shared(Aj.dp, jnp.asarray(vec), offsets=ks, m=m, n=n,
                                   adjoint=adjoint, interpret=True, tm=128)
    got = spmv.dia_product_shared_plain(At.dp, torch.from_numpy(vec), offsets=ks,
                                        m=m, n=n, adjoint=adjoint)
    assert got.dtype == torch.float32 and got.shape == ((n,) if adjoint else (m,))
    assert rel_err(got, ref) < TOL
    assert rel_err(got, (dense.T if adjoint else dense) @ vec) < TOL


@pytest.mark.parametrize("m,n,ks", CASES, ids=IDS)
@pytest.mark.parametrize("adjoint", [False, True])
def test_axpy_twin_matches_pallas(rng, m, n, ks, adjoint):
    _, _, Aj, At = _ops(rng, m, n, ks)
    vec = rng.standard_normal(m if adjoint else n).astype(np.float32)
    y = rng.standard_normal(n if adjoint else m).astype(np.float32)
    c1, c2 = 0.7, 1.3
    ref = jspmv.dia_product_shared_axpy(
        Aj.dp, jnp.asarray(vec), jnp.asarray(y), c1, c2, offsets=ks, m=m, n=n,
        adjoint=adjoint, interpret=True, tm=128)
    got = spmv.dia_product_shared_axpy_plain(
        At.dp, torch.from_numpy(vec), torch.from_numpy(y), c1, c2, offsets=ks,
        m=m, n=n, adjoint=adjoint)
    assert rel_err(got, ref) < TOL


#: the staged half-step's edges on the card: mixed odd offsets (each
#: diagonal's adjoint piece at a 16-byte phase of its own) on m and n not
#: multiples of 8, m != n both ways, dim_out below one tile, one-sided bands
AXPY_EDGES = [
    (1003, 757, (-7, -3, 0, 1, 5)),
    (757, 1003, (-7, -3, 0, 1, 5)),
    (45, 37, (-7, -3, 0, 1, 5)),
    (601, 403, (-9, -4, 0)),
    (403, 601, (0, 3, 11)),
]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("m,n,ks", AXPY_EDGES)
def test_axpy_twin_matches_pallas_at_staging_edges(rng, m, n, ks, adjoint, storage):
    """The half-step's twin against the Pallas kernel (interpret mode) at
    the staged kernel's edges, f32 and bf16 stripes (the same bf16 values in
    both packages), within TOL of the largest element: the two sum in f32
    in other orders."""
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    Aj = j_shared(m, n, ks, data, storage_dtype=storage)
    At = lt.dia_shared_operator(m, n, ks, data, storage_dtype=getattr(torch, storage),
                                device=DEV)
    assert to_np(At.dp.view(torch.int16) if storage == "bfloat16" else At.dp).tobytes() \
        == np.asarray(Aj.dp).tobytes()
    vec = rng.standard_normal(m if adjoint else n).astype(np.float32)
    y = rng.standard_normal(n if adjoint else m).astype(np.float32)
    ref = jspmv.dia_product_shared_axpy(
        Aj.dp, jnp.asarray(vec), jnp.asarray(y), 0.7, 1.3, offsets=ks, m=m, n=n,
        adjoint=adjoint, interpret=True, tm=128)
    got = spmv.dia_product_shared_axpy(
        At.dp, torch.from_numpy(vec), torch.from_numpy(y), torch.tensor(0.7),
        torch.tensor(1.3), offsets=ks, m=m, n=n, adjoint=adjoint)
    assert got.dtype == torch.float32 and got.shape == ((n,) if adjoint else (m,))
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("m,n,ks", PAIR_CASES + CASES[1:3] + ONE_SIDED
                         + [(1201, 997, tuple(range(-40, 41)))])
def test_pair_twin_matches_pallas(rng, m, n, ks):
    _, dense, Aj, At = _ops(rng, m, n, ks)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    c1, c2 = 0.8, 1.1
    uj, zj = jspmv.dia_pair_shared(Aj.dp, jnp.asarray(v), jnp.asarray(y), c1, c2,
                                   offsets=ks, m=m, n=n, interpret=True)
    # the tensors c1, c2 take the solver's route: 0-d tensors
    ut, zt = spmv.dia_pair_shared_plain(
        At.dp, torch.from_numpy(v), torch.from_numpy(y), torch.tensor(c1),
        torch.tensor(c2), offsets=ks, m=m, n=n)
    assert rel_err(ut, uj) < TOL and rel_err(zt, zj) < TOL
    u_ref = dense @ (v * np.float32(c1)) - np.float32(c2) * y
    assert rel_err(ut, u_ref) < TOL and rel_err(zt, dense.T @ u_ref) < TOL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_operator_products_match_jax(rng, dtype):
    m, n, ks = 330, 200, (-60, -3, 0, 5)
    _, dense, Aj, At = _ops(rng, m, n, ks, dtype)
    x = rng.standard_normal(n).astype(dtype)
    y = rng.standard_normal(m).astype(dtype)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert At.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel_err(At.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) < tol
    assert rel_err(At.rmatvec(torch.from_numpy(y)), Aj.rmatvec(jnp.asarray(y))) < tol
    np.testing.assert_array_equal(to_np(At.todense()), np.asarray(Aj.todense()))
    np.testing.assert_array_equal(to_np(At.todense()), dense)


def test_fused_halfstep_and_pair_on_operator(rng):
    m, n, ks = 400, 300, (-4, 0, 3)
    _, dense, Aj, At = _ops(rng, m, n, ks)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    c1, c2 = torch.tensor(0.5), torch.tensor(2.0)
    out, ssq = At.fused_halfstep(forward=True, y=torch.from_numpy(y),
                                 win=torch.from_numpy(v), c1=c1, c2=c2)
    outj, ssqj = Aj.fused_halfstep(forward=True, y=jnp.asarray(y), win=jnp.asarray(v),
                                   c1=0.5, c2=2.0)
    assert rel_err(out, outj) < TOL
    np.testing.assert_allclose(float(ssq), float(ssqj), rtol=1e-5)
    u, z = At.fused_pair(y=torch.from_numpy(y), win=torch.from_numpy(v), c1=c1, c2=c2)
    assert rel_err(u, out) < TOL and rel_err(z, dense.T @ to_np(out)) < TOL


def test_f64_fused_paths_stay_exact(rng):
    m, n, ks = 500, 500, (-1, 0, 2)
    _, dense, _, At = _ops(rng, m, n, ks, np.float64)
    v, y = rng.standard_normal(n), rng.standard_normal(m)
    c1, c2 = torch.tensor(0.3, dtype=torch.float64), torch.tensor(1.7, dtype=torch.float64)
    u_ref = dense @ (v * 0.3) - 1.7 * y
    u, z = At.fused_pair(y=torch.from_numpy(y), win=torch.from_numpy(v), c1=c1, c2=c2)
    assert u.dtype == torch.float64
    assert rel_err(u, u_ref) < 1e-14 and rel_err(z, dense.T @ u_ref) < 1e-14
    out, _ = At.fused_halfstep(forward=True, y=torch.from_numpy(y),
                               win=torch.from_numpy(v), c1=c1, c2=c2)
    assert rel_err(out, u_ref) < 1e-14


def test_acheck_passes_on_port_operator(rng):
    m, n, ks = 500, 300, (-4, 0, 3)
    _, _, Aj, At = _ops(rng, m, n, ks)
    chk = lt.acheck(At)
    assert int(chk.inform) == 0 and chk.tol == lj.acheck(Aj).tol
    assert float(chk.error) <= 10 * float(lj.acheck(Aj).error) + 1e-6


def test_bf16_storage_on_cpu_matches_jax(rng):
    m, n, ks = 500, 300, (-4, 0, 3)
    data = rng.standard_normal((3, m)).astype(np.float32)
    Aj = j_shared(m, n, ks, data, storage_dtype="bfloat16")
    At = lt.dia_shared_operator(m, n, ks, data, storage_dtype=torch.bfloat16, device=DEV)
    assert At.is_bf16_storage and At.dtype == torch.float32
    assert to_np(At.dp.view(torch.int16)).tobytes() == np.asarray(Aj.dp).tobytes()
    x = rng.standard_normal(n).astype(np.float32)
    assert rel_err(At.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) < 1e-6


def test_cpu_wrappers_run_twins_and_count_nothing(rng):
    m, n, ks = 300, 330, (-3, 0, 7)
    _, _, _, At = _ops(rng, m, n, ks)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    spmv.reset_launch_counts()
    kw = dict(offsets=ks, m=m, n=n)
    torch.testing.assert_close(spmv.dia_product_shared(At.dp, v, adjoint=False, **kw),
                               spmv.dia_product_shared_plain(At.dp, v, adjoint=False, **kw),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        spmv.dia_product_shared_axpy(At.dp, y, v, 0.5, 2.0, adjoint=True, **kw),
        spmv.dia_product_shared_axpy_plain(At.dp, y, v, 0.5, 2.0, adjoint=True, **kw),
        rtol=0, atol=0)
    for a, b in zip(spmv.dia_pair_shared(At.dp, v, y, 0.5, 2.0, **kw),
                    spmv.dia_pair_shared_plain(At.dp, v, y, 0.5, 2.0, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    lt.lsqr(At, y, pair=True, itnlim=3)
    counts = spmv.launch_counts()
    assert {"dia_pair_shared", "dia_product_shared", "dia_product_shared_axpy"} <= set(counts)
    assert not any(counts.values())
    assert not At.prefers_pair and not At.prefers_fused


@pytest.mark.parametrize("H,tile,ring,route", [
    (5, 1012, True, "staged"), (5, 0, True, "unstaged"),
    (spmv.PAIR_MAX_HALO, 0, True, "unstaged"), (spmv.PAIR_MAX_HALO, 2048, True, "staged"),
    (spmv.PAIR_MAX_HALO, 2048, False, "staged"), (5, 0, False, "two launches"),
    (spmv.PAIR_MAX_HALO + 1, 0, True, "two launches"),
])
def test_shared_pair_route(H, tile, ring, route):
    """The card's route of dia_pair_shared: a halo past PAIR_MAX_HALO takes
    two launches, any other band one, staged where a tile fits, else the
    ring kernel where its ring fits, else two launches."""
    assert spmv.pair_shared_route(H, tile, ring) == route


@pytest.mark.parametrize("nd,lo,hi,esize,nbytes,fits", [
    (81, 40, 40, 4, 69_728, True),      # chip_smoke's MANY band, f32: W = 208
    (81, 40, 40, 2, 36_032, True),      # bf16: half the ring
    (9, 1000, 1000, 4, 93_728, True),   # a wide sparse band (halo near PAIR_MAX_HALO)
    (11, 5, 5, 4, 7_376, True),
    (81, 1024, 1024, 4, 723_104, False),  # many diagonals and a wide halo: two launches
    (400, 40, 40, 4, 337_664, False),
    (1, 0, 0, 2, 1_312, True),
])
def test_pair_ring_bytes(nd, lo, hi, esize, nbytes, fits):
    """The ring kernel's shared memory (csrc/dia_shared.cu: RingLayout):
    nd rows of W = (RING_AHEAD + 1) * RING_CHUNK + lo + hi (rounded to 16
    bytes' worth) in the stripes' dtype, u for W rows, a step's x window
    (RING_CHUNK + lo + hi floats, rounded to 4) and two ints a diagonal (nd
    rounded up to 4); it takes the many-diagonal bands whose ring fits one
    block on the H100."""
    v = 16 // esize
    W = -(-((spmv.RING_AHEAD + 1) * spmv.RING_CHUNK + lo + hi) // v) * v
    assert (spmv.RING_CHUNK, spmv.RING_AHEAD) == (128, 0) and W % v == 0
    assert spmv.pair_ring_bytes(nd, lo, hi, esize) == nbytes
    assert (nbytes <= 232_448) == fits


#: the card's shared memory an SM and a block (NVIDIA H100 80GB HBM3)
H100_SMEM = (233_472, 232_448)


@pytest.mark.parametrize("nd,lo,hi,T,esize,nbytes", [
    # the main band, f32: 2 x (11 x 1028 x 4 + (1040 + 1024) x 4) + 4 x 12
    (11, 5, 5, 1024, 4, 107_024),
    (11, 5, 5, 1024, 2, 61_968),     # bf16 rows of 1032: 2 x (22,704 + 8,256) + 48
    (81, 40, 40, 256, 4, 173_584),   # 2 x (81 x 260 x 4 + (340 + 256) x 4) + 4 x 84
    (81, 40, 40, 256, 2, 90_640),    # 2 x (81 x 264 x 2 + 2,384) + 336
    (1024, 0, 0, 16, 4, 168_224),    # 2 x (1024 x 20 x 4 + (20 + 16) x 4) + 4,096
    (3, 1500, 1500, 1024, 4, 65_104),  # 2 x (3 x 1028 x 4 + (4028 + 1024) x 4) + 16
])
def test_axpy_stage_bytes(nd, lo, hi, T, esize, nbytes):
    """The staged half-step's shared memory (csrc/dia_shared.cu:
    AxpyLayout): AXPY_STAGES stages of nd rows of T + 16/esize stripe
    elements, the vector window (T + lo + hi + 3 floats rounded up to 4)
    and T floats of y, then nd ints rounded up to 4."""
    assert spmv.AXPY_STAGES == 2
    assert spmv.axpy_stage_bytes(nd, lo, hi, T, esize) == nbytes


@pytest.mark.parametrize("nd,lo,hi,esize,tile", [
    (11, 5, 5, 4, 1024),     # the main band: two blocks an SM (107 KB)
    (11, 5, 5, 2, 1024),
    (81, 40, 40, 4, 256),    # one block of T = 256 before two of T = 128
    (81, 40, 40, 2, 256),    # two blocks (91 KB)
    (3, 1500, 1500, 4, 1024),  # a halo past PAIR_MAX_HALO
    (394, 0, 0, 4, 32),
    (395, 0, 0, 4, 16),      # f32: T = 16 from 395 diagonals
    (1024, 0, 0, 4, 16),     # the most diagonals the kernels take
    (1024, 0, 0, 2, 16),
    (1, 14_400, 14_400, 4, 64),
    (1, 14_500, 14_500, 4, 0),  # no tile's window fits: the direct kernel
])
def test_axpy_tile(nd, lo, hi, esize, tile):
    """The staged half-step's tile on the H100: the largest tile of at least
    a block's threads (1024, 512, 256) whose two stages fit two blocks an
    SM, else one block, else the same with 128 down to 16; 0 where no
    window fits."""
    assert spmv.axpy_tile(nd, lo, hi, esize, *H100_SMEM) == tile
    if tile:
        assert spmv.axpy_stage_bytes(nd, lo, hi, tile, esize) <= H100_SMEM[1]


#: bands of each of the card's routes: staged (one-sided), unstaged (81
#: diagonals: no staged tile fits), two launches (a halo past PAIR_MAX_HALO)
ROUTE_BANDS = ONE_SIDED + [(1201, 997, tuple(range(-40, 41))),
                           (2501, 1803, (-1100, 0, 5))]


@pytest.mark.parametrize("m,n,ks", ROUTE_BANDS)
def test_cpu_pair_takes_the_twin_on_either_route(rng, m, n, ks):
    """On the CPU the wrapper runs the twin whichever route the card would
    take for the band, and counts nothing; the unstaged route has counters
    of its own."""
    _, _, _, At = _ops(rng, m, n, ks)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    kw = dict(offsets=ks, m=m, n=n)
    ref = spmv.dia_pair_shared_plain(At.dp, v, y, 0.8, 1.1, **kw)
    spmv.reset_launch_counts()
    for a, b in zip(spmv.dia_pair_shared(At.dp, v, y, 0.8, 1.1, **kw), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    counts = spmv.launch_counts(by_variant=True)
    assert {"dia_pair_shared[unstaged]", "dia_pair_shared[bf16_unstaged]"} <= set(counts)
    assert not any(counts.values())


def test_auto_operator_routes_banded_like_jax(rng):
    m, n, ks = 700, 650, (-5, -1, 0, 2, 9)
    data, _ = banded(rng, m, n, ks, np.float32)
    vals, rows, cols = banded_triplets(data, ks, n)
    Aj = lj.auto_operator(m, n, vals, rows, cols)
    At = lt.auto_operator(m, n, vals, rows, cols, device=DEV)
    assert type(Aj).__name__ == type(At).__name__ == "DIASharedOperator"
    assert to_np(At.dp).tobytes() == np.asarray(Aj.dp).tobytes()
    # f64: the packed DIA layout, as in JAX
    vals64 = vals.astype(np.float64)
    A64j = lj.auto_operator(m, n, vals64, rows, cols)
    A64t = lt.auto_operator(m, n, vals64, rows, cols, device=DEV)
    assert type(A64j).__name__ == type(A64t).__name__ == "DIAOperator"
    assert A64t.dtype == torch.float64 and A64t.offsets == A64j.offsets
    assert to_np(A64t.data).tobytes() == np.asarray(A64j.data).tobytes()
    assert to_np(A64t.tdata).tobytes() == np.asarray(A64j.tdata).tobytes()
    # compact=True: the shared layout for f64 too
    Acj = lj.auto_operator(m, n, vals64, rows, cols, compact=True)
    Act = lt.auto_operator(m, n, vals64, rows, cols, compact=True, device=DEV)
    assert type(Acj).__name__ == type(Act).__name__ == "DIASharedOperator"
    assert to_np(Act.dp).tobytes() == np.asarray(Acj.dp).tobytes()


def test_auto_operator_empty_and_unported_patterns(rng):
    empty = lt.auto_operator(4, 3, np.zeros(0), np.zeros(0, int), np.zeros(0, int), device=DEV)
    assert isinstance(empty, lt.COOOperator) and empty.nnz == 0
    rows, cols = rng.integers(0, 200, 300), rng.integers(0, 200, 300)
    vals = rng.standard_normal(300)
    # an unstructured pattern: the same operator in both packages since the
    # general slice (one 8192-row tile: JDIA's 16 slots take it)
    assert type(lt.auto_operator(200, 200, vals, rows, cols, device=DEV)).__name__ == \
        type(lj.auto_operator(200, 200, vals, rows, cols)).__name__
    # a tall unstructured f32 one takes JAX's WCOO in both packages
    rows, cols = rng.integers(0, 16384, 40000), rng.integers(0, 2048, 40000)
    vals = rng.standard_normal(40000).astype(np.float32)
    assert type(lt.auto_operator(16384, 2048, vals, rows, cols, device=DEV)).__name__ == \
        type(lj.auto_operator(16384, 2048, vals, rows, cols)).__name__ == "WCOOOperator"
    # complex patterns are ported (item 12): JAX's ZDIA for this banded one
    one = (np.array([1j]), np.array([0]), np.array([0]))
    assert type(lt.auto_operator(3, 3, *one, device=DEV)).__name__ == \
        type(lj.auto_operator(3, 3, *one)).__name__ == "ZDIAOperator"
