"""The two variants of the fused half-step (``dia_fused_halfstep_v2`` and
``_v3``): the port's plain twins against the JAX package's Pallas kernels
run in interpret mode, on the same seeded inputs.

Both compute out = A (win*c1) - c2*y in the stripes' dtype and ssq, the sum
of squares of the unrounded f32 accumulator. f32 stripes: out within 2e-5
(the JAX test's tolerance), ssq within 1e-4 relative. bf16 stripes: JAX's
interpret mode takes them with a bf16 ``win`` (its window buffer has the
stripes' dtype), the port with an f32 ``win`` holding the same bf16 values;
out is the f32 sum rounded to bf16 in both, held to one bf16 rounding
(2^-8 relative), ssq to 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqr_tpu.ops.pallas_spmv import dia_fused_halfstep_v2 as j_v2
from lsqr_tpu.ops.pallas_spmv import dia_fused_halfstep_v3 as j_v3
from lsqr_tpu.ops.structured import _dia_matvec_xla
from lsqr_tpu.ops.structured import dia_operator as j_dia_operator
from lsqr_tpu_torch.ops import spmv

from _torch_parity import banded, to_np

OFFS = (-3, 0, 5)  # tests/test_fused.py:96
C1, C2 = 0.37, 1.21
SHAPES = [(1500, 1500), (2100, 1800)]  # tests/test_fused.py:88


def _inputs(rng, m, n):
    data, _ = banded(rng, m, n, OFFS, dense=False)
    y = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    return data, y, v


def _numpy_ref(data, y, v, m, n):
    """The JAX test's reference: the XLA product of the JAX operator's
    stripes, minus c2 y."""
    A = j_dia_operator(m, n, OFFS, data, use_pallas=False)
    return np.asarray(_dia_matvec_xla(A.data, jnp.asarray(v * np.float32(C1)), OFFS, m, n)) \
        - np.float32(C2) * y


def _port(variant, data, y, v, m, n, **kw):
    fn = {"v2": spmv.dia_fused_halfstep_v2, "v3": spmv.dia_fused_halfstep_v3}[variant]
    return fn(torch.from_numpy(data), torch.from_numpy(y), torch.from_numpy(v), C1, C2,
              offsets=OFFS, m=m, n=n, **kw)


def _hold_f32(out, ssq, out_j, ssq_j, ref):
    assert out.dtype == torch.float32 and ssq.dtype == torch.float32 and ssq.dim() == 0
    np.testing.assert_allclose(to_np(out), np.asarray(out_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(to_np(out), ref, rtol=2e-5, atol=2e-5)
    ref_ssq = float((ref.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(float(ssq), float(ssq_j), rtol=1e-4)
    np.testing.assert_allclose(float(ssq), ref_ssq, rtol=1e-4)


@pytest.mark.parametrize("ssq_out", ["vmem", "smem"])
@pytest.mark.parametrize("shape", SHAPES)
def test_v2_twin_matches_jax_interpret(rng, shape, ssq_out):
    m, n = shape
    data, y, v = _inputs(rng, m, n)
    out_j, ssq_j = j_v2(jnp.asarray(data), jnp.asarray(y), jnp.asarray(v), C1, C2,
                        offsets=OFFS, m=m, n=n, interpret=True, ssq_out=ssq_out)
    out, ssq = _port("v2", data, y, v, m, n, ssq_out=ssq_out)
    _hold_f32(out, ssq, out_j, ssq_j, _numpy_ref(data, y, v, m, n))


@pytest.mark.parametrize("shape", SHAPES)
def test_v3_twin_matches_jax_interpret(rng, shape):
    m, n = shape
    data, y, v = _inputs(rng, m, n)
    out_j, ssq_j = j_v3(jnp.asarray(data), jnp.asarray(y), jnp.asarray(v), C1, C2,
                        offsets=OFFS, m=m, n=n, interpret=True)
    out, ssq = _port("v3", data, y, v, m, n)
    _hold_f32(out, ssq, out_j, ssq_j, _numpy_ref(data, y, v, m, n))


@pytest.mark.parametrize("variant,ssq_out", [("v2", "vmem"), ("v2", "smem"), ("v3", None)])
def test_bf16_stripes_match_jax_interpret(rng, variant, ssq_out):
    m, n = SHAPES[1]
    data, y, v = _inputs(rng, m, n)
    d16 = torch.from_numpy(data).bfloat16()
    v16 = torch.from_numpy(v).bfloat16()
    dj, vj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (d16, v16))
    kw = {} if ssq_out is None else dict(ssq_out=ssq_out)
    out_j, ssq_j = (j_v2 if variant == "v2" else j_v3)(
        dj, jnp.asarray(y), vj, C1, C2, offsets=OFFS, m=m, n=n, interpret=True, **kw)
    fn = spmv.dia_fused_halfstep_v2 if variant == "v2" else spmv.dia_fused_halfstep_v3
    out, ssq = fn(d16, torch.from_numpy(y), v16.float(), C1, C2, offsets=OFFS, m=m, n=n,
                  **kw)
    assert out.dtype == torch.bfloat16 and out_j.dtype == jnp.bfloat16
    assert ssq.dtype == torch.float32
    got, ref = to_np(out).astype(np.float64), np.asarray(out_j.astype(jnp.float32), np.float64)
    assert np.all(np.abs(got - ref) <= 2.0 ** -8 * np.abs(ref) + 1e-30)
    np.testing.assert_allclose(float(ssq), float(ssq_j), rtol=1e-4)


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_ssq_is_of_the_unrounded_sum(rng, variant):
    """ssq sums the f32 accumulator's squares, not the bf16-rounded out's,
    and the rows past m add nothing (there are none: out has m rows)."""
    m, n = 1000, 1200
    data, y, v = _inputs(rng, m, n)
    d16 = torch.from_numpy(data).bfloat16()
    out, ssq = getattr(spmv, f"dia_fused_halfstep_{variant}")(
        d16, torch.from_numpy(y), torch.from_numpy(v), C1, C2, offsets=OFFS, m=m, n=n)
    acc = spmv.dia_matvec_axpy_plain(d16, torch.from_numpy(y), torch.from_numpy(v), C1, C2,
                                     offsets=OFFS, m=m, n=n, out_dtype=torch.float32)
    assert out.shape == (m,)
    assert float(ssq) == pytest.approx(float(torch.sum(acc.double() ** 2)), rel=1e-6)
    rounded = float(torch.sum(out.double() ** 2))
    assert abs(rounded - float(ssq)) / float(ssq) > 1e-7  # bf16 rounding shows


def test_variants_take_the_twins_on_the_cpu_and_are_counted(rng):
    m, n = 300, 280
    data, y, v = _inputs(rng, m, n)
    spmv.reset_launch_counts()
    for variant in ("v2", "v3"):
        _port(variant, data, y, v, m, n)
    counts = spmv.launch_counts(by_variant=True)
    for name in ("dia_fused_halfstep_v2", "dia_fused_halfstep_v3"):
        assert counts[name] == counts[f"{name}[bf16]"] == 0
    # the row-7 twin, the v2 twin and the v3 twin agree exactly
    t = [f(torch.from_numpy(data), torch.from_numpy(y), torch.from_numpy(v), C1, C2,
           offsets=OFFS, m=m, n=n)
         for f in (spmv.dia_fused_halfstep_plain, spmv.dia_fused_halfstep_v2_plain,
                   spmv.dia_fused_halfstep_v3_plain)]
    for out, ssq in t[1:]:
        assert torch.equal(out, t[0][0]) and torch.equal(ssq, t[0][1])


#: (shared memory an SM, the most one block may opt in to) of the H100
H100_SMEM = (233_472, 232_448)


@pytest.mark.parametrize("nd,lo,hi,T,esize,nbytes", [
    # the main band, f32: 2 x (11 x 1028 x 4 + 1040 x 4 + 1024 x 4) + 8 x 12 + 64
    (11, 5, 5, 1024, 4, 107_136),
    (11, 5, 5, 1024, 2, 62_080),     # bf16 rows of 1032: 2 x (22,704 + 8,256) + 96 + 64
    (81, 40, 40, 256, 4, 173_984),   # 2 x (81 x 260 x 4 + 340 x 4 + 1,024) + 672 + 64
    (81, 40, 40, 256, 2, 91_040),    # 2 x (81 x 264 x 2 + 1,360 + 1,024) + 672 + 64
    (1024, 0, 0, 16, 4, 172_384),    # 2 x (1024 x 20 x 4 + 20 x 4 + 64) + 8,192 + 64
    (1024, 0, 0, 16, 2, 106_848),    # 2 x (1024 x 24 x 2 + 80 + 64) + 8,192 + 64
    (3, 1500, 1500, 1024, 4, 65_184),  # 2 x (3 x 1028 x 4 + 4028 x 4 + 4,096) + 32 + 64
])
def test_halfstep_stage_bytes(nd, lo, hi, T, esize, nbytes):
    """The staged fused half-step's shared memory (csrc/dia_product_staged.cuh:
    ProductLayout with a step): the staged product's stages with T floats of
    y in each, the offsets and phases (two ints a diagonal, nd rounded up to
    4), and two tiles' warp sums (2 x 8 floats)."""
    assert spmv.PRODUCT_STAGES == 2 and spmv.PRODUCT_WARPS == 8
    assert spmv.halfstep_stage_bytes(nd, lo, hi, T, esize) == nbytes
    assert nbytes == spmv.product_stage_bytes(nd, lo, hi, T, esize) + 2 * 4 * T + 64


@pytest.mark.parametrize("nd,lo,hi,esize,tile", [
    (11, 5, 5, 4, 1024),     # the main band: two blocks an SM (107 KB)
    (11, 5, 5, 2, 1024),     # (62 KB)
    (21, 10, 10, 4, 512),
    (53, 5, 5, 4, 256),      # f32: the most diagonals with two blocks of 256
    (54, 5, 5, 4, 0),        # f32: one block of 256 would fit: the direct kernel
    (81, 40, 40, 4, 0),
    (81, 40, 40, 2, 256),    # bf16: two blocks (91 KB)
    (3, 1500, 1500, 4, 1024),  # a halo past PAIR_MAX_HALO
    (700, 0, 0, 4, 0),
    (700, 0, 0, 2, 16),      # bf16: two blocks of 16 before one of 32
    (1024, 0, 0, 2, 16),     # bf16: the most diagonals the kernels take still get a tile
    (11, 5_530, 5_530, 4, 256),
    (11, 5_540, 5_540, 4, 0),  # f32: no window fits two blocks of 256
    (11, 14_430, 14_430, 2, 16),
    (11, 14_440, 14_440, 2, 0),  # bf16: no window fits one block of 16
])
def test_halfstep_tile(nd, lo, hi, esize, tile):
    """The staged fused half-step's tile on the H100. bf16: the product's
    rule over its own bytes (the largest tile of 1024, 512, 256 whose two
    stages fit two blocks an SM, else one block, else the same with 128 down
    to 16). f32: only a tile of 1024, 512, 256 that fits two blocks an SM.
    0 elsewhere, and v2 and v3 then take their direct kernels."""
    assert spmv.halfstep_tile(nd, lo, hi, esize, *H100_SMEM) == tile
    two_blocks = H100_SMEM[0] // 2 - 1024
    if tile:
        assert spmv.halfstep_stage_bytes(nd, lo, hi, tile, esize) <= (
            two_blocks if esize == 4 else H100_SMEM[1])
    elif esize == 4:
        assert spmv.halfstep_stage_bytes(nd, lo, hi, 256, esize) > two_blocks
    else:
        assert spmv.halfstep_stage_bytes(nd, lo, hi, 16, esize) > H100_SMEM[1]
