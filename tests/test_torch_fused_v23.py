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
