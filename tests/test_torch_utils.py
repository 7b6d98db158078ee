"""The port's reports, live iteration log, checkpointed solves and profiling
hooks (lsqr_tpu_torch.utils, ``debug_log``) against the JAX package
(tests/test_utils.py).

The same numpy problems go to both packages (JAX on the CPU in x64, the
port on the CPU). Bounds: the report strings equal to JAX's for the same
result fields; the ``debug_log`` lines with JAX's iteration numbers and
their numbers within 1e-7 of JAX's (relative, and 1e-12 absolute for the
columns that converge to 0; the printed digits of the same f64 iterates);
checkpointed solves bit-equal (``torch.equal``) to the uninterrupted solve; a state file JAX wrote resumes in the port to JAX's
istop and itn, x within 1e-10 of JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu as lj
import lsqr_tpu_torch as lt
from lsqr_tpu.utils import checkpoint as ckpt_j
from lsqr_tpu.utils import printing as printing_j
from lsqr_tpu_torch.utils import checkpoint as ckpt_t
from lsqr_tpu_torch.utils import printing as printing_t
from lsqr_tpu_torch.utils import profiling

from _torch_parity import DEV, rel_err, to_np


def _problem(rng, m=120, n=80, nnz=600):
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    return (lt.coo_operator(m, n, vals, rows, cols, device=DEV),
            lj.coo_operator(m, n, vals, rows, cols), rng.standard_normal(m))


def _as_jax(res, cls):
    """The JAX package's result type over the port result's numbers."""
    return cls(**{f: None if getattr(res, f) is None else jnp.asarray(to_np(getattr(res, f)))
                  for f in res._fields})


def test_report_strings_equal_jax(rng):
    """format_header, format_iteration_log (throttled and not),
    format_exit_block and format_report: JAX's strings for the same
    fields."""
    A, _, b = _problem(rng)
    res = lt.lsqr(A, b, 0.1, record_trace=True, atol=1e-8, btol=1e-8, itnlim=200)
    res_j = _as_jax(res, lj.LSQRResult)
    params = dict(damp=0.1, atol=1e-8, btol=1e-8, itnlim=200)
    kw = dict(m=A.m, n=A.n, itnlim=200, damped=True, header_params=params)
    assert printing_t.format_report(res, **kw) == printing_j.format_report(res_j, **kw)
    assert printing_t.format_header(A.m, A.n, **params) == printing_j.format_header(
        A.m, A.n, **params)
    for throttle in (True, False):
        got = printing_t.format_iteration_log(res, n=A.n, itnlim=200, throttle=throttle)
        assert got == printing_j.format_iteration_log(res_j, n=A.n, itnlim=200,
                                                      throttle=throttle)
    report = lt.format_report(res, **kw)
    assert "Enter LSQR" in report and "Norm Abar" in report
    assert "damped least-squares solution" in report
    plain = lt.lsqr(A, b, 0.0, itnlim=200)
    assert lt.format_exit_block(plain) == printing_j.format_exit_block(
        _as_jax(plain, lj.LSQRResult))
    with pytest.raises(ValueError, match="no trace recorded"):
        lt.format_iteration_log(plain)


def test_format_summary_all_solvers_equal_jax(rng):
    dense = rng.standard_normal((50, 25))
    A = lt.as_operator(torch.tensor(dense))
    b = rng.standard_normal(50)
    sq = rng.standard_normal((25, 25)) + 4 * np.eye(25)
    cases = ((lt.lsqr(A, b), lj.LSQRResult, "LSQR"), (lt.lsmr(A, b), lj.LSMRResult, "LSMR"),
             (lt.cgls(A, b), lj.CGLSResult, "CGLS"),
             (lt.craig(lt.as_operator(torch.tensor(sq)), sq @ rng.standard_normal(25)),
              lj.CRAIGResult, "CRAIG"))
    for res, cls, name in cases:
        out = printing_t.format_summary(res)
        assert out == printing_j.format_summary(_as_jax(res, cls))
        assert f"Exit  {name}" in out and out.count("\n") >= 3


def _debug_lines(text):
    return [line.split() for line in text.splitlines() if line.strip()]


@pytest.mark.parametrize("m, n, itnlim", [(30, 12, 50), (160, 90, 70)],
                         ids=["every_row", "throttled"])
def test_debug_log_prints_jax_lines(rng, capfd, m, n, itnlim):
    """debug_log=True prints the rows JAX's jax.debug.print does: every
    iteration when n <= 40, else the reference's throttle rule (first and
    last 10, every 10th, near the tolerances, the stop); the same numbers
    in the same formats."""
    dense = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    kw = dict(debug_log=True, atol=1e-6, btol=1e-6, itnlim=itnlim)
    res = lt.lsqr(lt.as_operator(torch.tensor(dense)), b, 0.0, **kw)
    ours = _debug_lines(capfd.readouterr().out)
    res_j = lj.lsqr(lj.DenseOperator(a=jnp.asarray(dense)), b, 0.0, **kw)
    res_j.x.block_until_ready()
    theirs = _debug_lines(capfd.readouterr().out)
    assert int(res.itn) == int(res_j.itn)
    assert [row[0] for row in ours] == [row[0] for row in theirs]
    assert int(ours[-1][0]) == int(res.itn) and ours[0][0] == "1"
    if n <= 40:
        assert len(ours) == int(res.itn)
    else:
        assert len(ours) < int(res.itn)
    got = np.array([[float(v) for v in row] for row in ours])
    ref = np.array([[float(v) for v in row] for row in theirs])
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)
    assert all(len(a) == len(b) for a, b in zip(ours, theirs))


def test_segmented_matches_oneshot_bit_for_bit(rng):
    A, _, b = _problem(rng)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=300)
    ref = lt.lsqr(A, b, 0.1, **kw)
    res = lt.lsqr_checkpointed(A, b, 0.1, segment_iters=7, **kw)
    assert int(res.istop) == int(ref.istop) and int(res.itn) == int(ref.itn)
    assert torch.equal(res.x, ref.x) and torch.equal(res.rnorm, ref.rnorm)
    zero = lt.lsqr_checkpointed(A, np.zeros(A.m), 0.0, segment_iters=10, itnlim=50)
    assert int(zero.istop) == 0 and int(zero.itn) == 0


def test_checkpoint_save_resume_bit_for_bit(rng, tmp_path):
    A, _, b = _problem(rng)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=300)
    ref = lt.lsqr(A, b, 0.05, **kw)
    path = str(tmp_path / "state.npz")
    seen = []

    def stop_early(seg, carry):
        seen.append(int(carry.itn))
        if seg >= 3:
            raise KeyboardInterrupt  # a preemption

    with pytest.raises(KeyboardInterrupt):
        lt.lsqr_checkpointed(A, b, 0.05, segment_iters=5, checkpoint_path=path,
                             on_segment=stop_early, **kw)
    assert seen == [5, 10, 15]
    carry = lt.load_state(path, device=DEV)
    assert isinstance(carry, ckpt_t._Carry) and int(carry.itn) == 15
    res = lt.lsqr_checkpointed(A, b, 0.05, segment_iters=50, resume_from=path, **kw)
    assert int(res.itn) == int(ref.itn) and int(res.istop) == int(ref.istop)
    assert torch.equal(res.x, ref.x)


def test_jax_state_file_resumes_in_port(rng, tmp_path):
    """A carry written by JAX's save_state (its fields and names) resumes in
    the port's segmented solve to JAX's istop and itn."""
    A, Aj, b = _problem(rng)
    kw = dict(atol=1e-10, btol=1e-10, itnlim=300)
    path = str(tmp_path / "jax_state.npz")

    def stop(seg, carry):
        if seg >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        ckpt_j.lsqr_checkpointed(Aj, b, 0.05, segment_iters=6, checkpoint_path=path,
                                 on_segment=stop, **kw)
    ref_j = ckpt_j.lsqr_checkpointed(Aj, b, 0.05, segment_iters=50, resume_from=path, **kw)
    res = lt.lsqr_checkpointed(A, b, 0.05, segment_iters=50, resume_from=path, **kw)
    assert int(res.istop) == int(ref_j.istop) and int(res.itn) == int(ref_j.itn)
    assert rel_err(res.x, np.asarray(ref_j.x)) < 1e-10


def test_sibling_checkpointed_bit_identical(rng, tmp_path):
    """LSMR, CGLS and CRAIG in segments: the one-shot solves' bits; an LSMR
    preemption resumed from disk likewise."""
    m = n = 600
    data = rng.standard_normal((3, m))
    data[1] += 5.0
    A = lt.dia_operator(m, n, (-1, 0, 2), data, device=DEV)
    b = rng.standard_normal(m)
    ref = lt.lsmr(A, b, 0.01, atol=1e-9, btol=1e-9)
    res = ckpt_t.lsmr_checkpointed(A, b, 0.01, atol=1e-9, btol=1e-9, segment_iters=7)
    assert int(res.istop) == int(ref.istop) and int(res.itn) == int(ref.itn)
    assert torch.equal(res.x, ref.x)
    refg = lt.cgls(A, b, 0.05, atol=1e-8, btol=1e-8)
    resg = ckpt_t.cgls_checkpointed(A, b, 0.05, atol=1e-8, btol=1e-8, segment_iters=6)
    assert int(resg.itn) == int(refg.itn) and torch.equal(resg.x, refg.x)
    bc = to_np(A.matvec(torch.tensor(rng.standard_normal(n))))
    refc = lt.craig(A, bc, atol=1e-9, btol=1e-9)
    resc = ckpt_t.craig_checkpointed(A, bc, atol=1e-9, btol=1e-9, segment_iters=4)
    assert int(resc.itn) == int(refc.itn) and torch.equal(resc.x, refc.x)

    path = str(tmp_path / "lsmr.npz")

    def stop(seg, carry):
        if seg >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        ckpt_t.lsmr_checkpointed(A, b, 0.01, atol=1e-9, btol=1e-9, segment_iters=5,
                                 checkpoint_path=path, on_segment=stop)
    again = ckpt_t.lsmr_checkpointed(A, b, 0.01, atol=1e-9, btol=1e-9, segment_iters=100,
                                     resume_from=path)
    assert int(again.itn) == int(ref.itn) and torch.equal(again.x, ref.x)


def test_load_state_complex_checkpoint_real_dtype_request(rng, tmp_path):
    """A real dtype request on a complex checkpoint keeps the imaginary
    parts (complex64 vectors) and real f32 scalars."""
    m, n, nnz = 60, 40, 300
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    A = lt.coo_operator(m, n, vals, rows, cols, device=DEV)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    path = str(tmp_path / "z.npz")
    lt.lsqr_checkpointed(A, b, 0.05, segment_iters=4, checkpoint_path=path, itnlim=8)
    carry = lt.load_state(path, dtype=np.float32, device=DEV)
    assert carry.u.dtype == torch.complex64 and carry.x.dtype == torch.complex64
    assert to_np(carry.u).imag.any()
    assert carry.rhobar.dtype == torch.float32


def test_profiling_hooks(rng, tmp_path):
    """product_rate's keys (JAX's) and a Chrome trace written by trace."""
    m = n = 300
    A = lt.dia_shared_operator(m, n, (-1, 0, 1), rng.standard_normal((3, m)), device=DEV)
    out = profiling.product_rate(A, iters=5)
    assert set(out) == {"seconds_per_product", "gnnz_per_s", "iters"}
    assert out["seconds_per_product"] > 0 and out["iters"] == 5
    assert set(profiling.product_rate(A, iters=3, pair=False)) == set(out)
    with pytest.raises(ValueError, match="square"):
        profiling.product_rate(lt.as_operator(torch.ones(3, 2)), pair=False)
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        A.matvec(torch.ones(n, dtype=torch.float64))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert (log_dir / files[0]).stat().st_size > 0
