"""The solvers' segment loop (``solver._run_segments``): a segment ends
where a step's stop flag, read without blocking, says the solve is done,
at most ``solver.AHEAD`` masked steps past the stop, and the answer is the
one of a solve that reads after every step (``loop_segment=1``), bit for
bit. The last case needs the card (``-m cuda``), where the flags come
through pinned host buffers behind CUDA events.
"""

import numpy as np
import pytest
import torch

import lsqr_tpu_torch as lt
from lsqr_tpu_torch import tracing
from lsqr_tpu_torch.implicit import normal_cg
from lsqr_tpu_torch.solver import AHEAD

from _torch_parity import banded, cuda_device  # noqa: F401

M = 256
OFFSETS = (-2, -1, 0, 1, 2)
TOL = dict(atol=1e-7, btol=1e-7)


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def band(device="cpu", m=M, offsets=OFFSETS, boost=5.0, seed=0):
    data, _ = banded(np.random.default_rng(seed), m, m, offsets, boost=boost, dense=False)
    return lt.dia_shared_operator(m, m, offsets, data, device=device)


def rhs(rows=None, m=M, device="cpu"):
    g = torch.Generator().manual_seed(1)
    shape = (m,) if rows is None else (rows, m)
    return torch.randn(shape, generator=g).to(device)


def fields(res):
    """A result's tensors by name (a NamedTuple's fields that are set)."""
    if isinstance(res, dict):
        return res
    return {k: v for k, v in res._asdict().items() if v is not None}


def cg(A, g, seg):
    info = {}
    s = normal_cg(A, 0.01, g, tol=1e-6, loop_segment=seg, info=info)
    return {"s": s, "itn": torch.tensor(info["itn"])}


CASES = {
    "lsqr_pair": lambda A, seg: lt.lsqr(A, rhs(), 0.01, pair=True, loop_segment=seg, **TOL),
    "lsqr_plain": lambda A, seg: lt.lsqr(A, rhs(), 0.01, pair=False, fused=False,
                                         wantse=True, loop_segment=seg, **TOL),
    "lsqr_batch": lambda A, seg: lt.lsqr_batch(A, rhs(3), 0.01, wantse=True,
                                               loop_segment=seg, **TOL),
    "lsmr_batch": lambda A, seg: lt.lsmr_batch(A, rhs(3), 0.01, loop_segment=seg, **TOL),
    "cgls_batch": lambda A, seg: lt.cgls_batch(A, rhs(3), 0.01, loop_segment=seg, **TOL),
    "lsqr_multidamp": lambda A, seg: lt.lsqr_multidamp(A, rhs(), [0.0, 0.01, 0.5],
                                                       wantse=True, loop_segment=seg, **TOL),
    "normal_cg": lambda A, seg: cg(A, A.rmatvec(rhs()), seg),
}


@pytest.mark.parametrize("seg", [16, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_cut_segment_gives_the_bits_of_a_read_after_every_step(case, seg):
    A = band()
    got = fields(CASES[case](A, seg))
    c = tracing.counts()
    ref = fields(CASES[case](A, 1))
    assert sorted(got) == sorted(ref)
    for name in got:
        assert torch.equal(got[name], ref[name]), name
    needed, launched = c["iterations_needed"], c["iterations_launched"]
    assert needed == int(got["itn"].max()) and needed % seg != 0
    assert needed <= launched <= needed + AHEAD
    # every segment but the cut one ran whole
    assert c["segments_cut"] == 1 and launched // seg == needed // seg


def test_a_debug_log_solve_runs_whole_segments(capsys):
    """Its rows ride on the segment's blocking read, so no step's flag cuts
    a segment."""
    res = lt.lsqr(band(), rhs(), 0.01, debug_log=True, loop_segment=16, **TOL)
    c = tracing.counts()
    assert int(res.itn) % 16 != 0
    assert c["iterations_launched"] == 16 * -(-int(res.itn) // 16)
    assert c["segments_cut"] == 0
    assert capsys.readouterr().out


# --- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_a_cut_batch_gives_the_bits_of_a_read_after_every_step(cuda_device):
    """``lsqr_batch`` of 4 rows on 2^20 x 11 shared stripes: the flags come
    through pinned buffers behind events, and the solve runs at most AHEAD
    masked steps past the stop."""
    A = band(cuda_device, m=2 ** 20, offsets=tuple(range(-5, 6)), boost=12.0)
    B = rhs(4, m=2 ** 20, device=cuda_device)
    lt.lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6)  # warm
    torch.cuda.synchronize()
    tracing.clear()
    got = lt.lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6)
    torch.cuda.synchronize()
    c = tracing.counts()
    ref = lt.lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6, loop_segment=1)
    for name, value in fields(got).items():
        assert torch.equal(value, getattr(ref, name)), name
    needed, launched = c["iterations_needed"], c["iterations_launched"]
    assert needed == int(got.itn.max()) < 64
    assert needed <= launched <= needed + AHEAD
    assert c["segments_cut"] >= 1
