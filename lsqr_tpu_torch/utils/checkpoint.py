"""Segmented solves with checkpoint and resume.

PyTorch counterpart of :mod:`lsqr_tpu.utils.checkpoint`. The reference has
no checkpointing; its docstring documents the x0 warm start
(lsqr.f90:303-320). Here the whole solver state is the carry (about twenty
0-d tensors and the u, v, w, x, se vectors), so a solve is cut into
segments of ``segment_iters`` iterations with the carry written to an
``.npz`` between them, and resumed later, on another machine if need be.

A segment is one masked segment of :func:`lsqr_tpu_torch.solver._run_segments`
whose iterations past ``start + segment_iters`` are masked: the same body,
the same stopping tests, so the products and the scalars are those of the
uninterrupted solve on the same route, bit for bit. As in the JAX package
the segmented solves take the two-product route (no fused half-step, no
pair). The ``.npz`` holds the carry's fields under JAX's names, so a state
written by either package resumes in the other.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import LSQROptions, as_dtype, default_dtype, real_dtype, resolve_device
from ..ops.linop import as_operator, as_tensor, to_numpy
from ..solver import LSQRResult, _build, _Carry, _run_segments

__all__ = [
    "lsqr_checkpointed",
    "lsmr_checkpointed",
    "cgls_checkpointed",
    "craig_checkpointed",
    "save_state",
    "load_state",
]


def save_state(path: str, carry) -> None:
    """Write a solver carry (any solver's NamedTuple) to an .npz file: one
    host copy of each field."""
    np.savez(path, **{f: to_numpy(getattr(carry, f)) for f in carry._fields})


def load_state(path: str, dtype=None, carry_cls=_Carry, *, device=None):
    """Load a carry written by :func:`save_state` (of either package) onto
    ``device`` (the card when None).

    ``carry_cls`` picks the solver (LSQR's carry by default; pass
    ``lsmr._Carry``, ``cgls._Carry`` or ``craig._Carry`` for the siblings').
    With ``dtype``, real float fields take its real dtype and complex ones
    the complex dtype of that precision (a real request never drops the
    imaginary parts of a complex checkpoint)."""
    data = np.load(path)
    dev = resolve_device(device)
    if dtype is not None:
        rdt = real_dtype(dtype)
        cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    kw = {}
    for f in carry_cls._fields:
        t = torch.from_numpy(np.array(data[f], copy=True)).to(dev)
        if dtype is not None:
            if t.is_complex():
                t = t.to(cdt)
            elif t.is_floating_point():
                t = t.to(rdt)
        kw[f] = t
    return carry_cls(**kw)


def _run_checkpointed(carry0, cond_fun, body_fun, finalize, itnlim, *, A, segment_iters,
                      checkpoint_path, resume_from, on_segment, carry_cls, dtype,
                      device, log=None):
    carry = (load_state(resume_from, dtype=dtype, carry_cls=carry_cls, device=device)
             if resume_from else carry0)
    seg = 0
    start = int(carry.itn)
    while True:
        carry = _run_segments(carry, cond_fun, body_fun, A=A, itnlim=itnlim,
                              seg_len=segment_iters, log=log,
                              stop_at=min(start + segment_iters, itnlim))
        seg += 1
        if checkpoint_path:
            save_state(checkpoint_path, carry)
        if on_segment is not None:
            on_segment(seg, carry)
        istop, itn = torch.stack([carry.istop, carry.itn]).tolist()
        # stopped, out of iterations, or a degenerate setup (arnorm0 == 0)
        if istop != 0 or itn >= itnlim or itn == start:
            return finalize(carry)
        start = itn


def _setup(A, b, m, n, dtype=None):
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    dtype = as_dtype(dtype) or (
        b.dtype if b.dtype.is_floating_point or b.dtype.is_complex else default_dtype())
    b = b.to(dtype)
    return A, b, dtype, lambda v: as_tensor(v, dtype=real_dtype(dtype), device=b.device)


def lsqr_checkpointed(
    A,
    b,
    damp: float = 0.0,
    *,
    segment_iters: int = 100,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    on_segment: Optional[Callable[[int, _Carry], None]] = None,
    options: Optional[LSQROptions] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    **option_overrides,
) -> LSQRResult:
    """Solve as :func:`lsqr_tpu_torch.lsqr` does, but in segments of
    ``segment_iters`` iterations, writing the carry to ``checkpoint_path``
    (npz) after each segment and/or resuming from the carry at
    ``resume_from``; ``on_segment(index, carry)`` runs after each segment.
    The state goes to the operator's device."""
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    A, b, dtype, scalar = _setup(A, b, m, n, opts.dtype)
    itnlim = opts.resolve_itnlim(A.n)
    log = [] if opts.debug_log else None
    pieces = _build(A, b, scalar(damp), scalar(opts.atol), scalar(opts.btol),
                    scalar(opts.conlim), itnlim=itnlim, wantse=opts.wantse,
                    nconv=opts.nconv, record_trace=opts.record_trace,
                    safe_norms=opts.safe_norms, scalar_dtype=as_dtype(opts.scalar_dtype),
                    log_rows=log)
    return _run_checkpointed(*pieces, itnlim, A=A, segment_iters=segment_iters,
                             checkpoint_path=checkpoint_path, resume_from=resume_from,
                             on_segment=on_segment, carry_cls=_Carry, dtype=dtype,
                             device=b.device, log=log)


def _sibling(module, A, b, m, n, itnlim_rule, build_args, segment_iters, checkpoint_path,
             resume_from, on_segment, **build_kw):
    import importlib

    mod = importlib.import_module(f"lsqr_tpu_torch.{module}")
    A, b, dtype, scalar = _setup(A, b, m, n)
    itnlim = build_kw.pop("itnlim")
    itnlim = int(itnlim_rule(A) if itnlim is None else itnlim)
    pieces = mod._build(A, b, *(scalar(v) for v in build_args), itnlim=itnlim, **build_kw)
    return _run_checkpointed(*pieces, itnlim, A=A, segment_iters=segment_iters,
                             checkpoint_path=checkpoint_path, resume_from=resume_from,
                             on_segment=on_segment, carry_cls=mod._Carry, dtype=dtype,
                             device=b.device)


def lsmr_checkpointed(
    A, b, damp: float = 0.0, *, atol=1e-6, btol=1e-6, conlim=1e8, itnlim=None,
    segment_iters: int = 100, checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None, on_segment: Optional[Callable] = None,
    safe_norms: bool = True, m: Optional[int] = None, n: Optional[int] = None,
):
    """Segmented and checkpointed LSMR (the runner of
    :func:`lsqr_checkpointed`; the defaults of :func:`lsqr_tpu_torch.lsmr`)."""
    return _sibling("lsmr", A, b, m, n, lambda A: min(A.m, A.n),
                    (damp, atol, btol, conlim), segment_iters, checkpoint_path,
                    resume_from, on_segment, itnlim=itnlim, record_trace=False,
                    safe_norms=safe_norms)


def cgls_checkpointed(
    A, b, damp: float = 0.0, *, atol=1e-6, btol=1e-6, itnlim=None,
    segment_iters: int = 100, checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None, on_segment: Optional[Callable] = None,
    safe_norms: bool = True, m: Optional[int] = None, n: Optional[int] = None,
):
    """Segmented and checkpointed CGLS."""
    return _sibling("cgls", A, b, m, n, lambda A: 4 * A.n, (damp, atol, btol),
                    segment_iters, checkpoint_path, resume_from, on_segment,
                    itnlim=itnlim, safe_norms=safe_norms)


def craig_checkpointed(
    A, b, *, atol=1e-6, btol=1e-6, itnlim=None, segment_iters: int = 100,
    checkpoint_path: Optional[str] = None, resume_from: Optional[str] = None,
    on_segment: Optional[Callable] = None, safe_norms: bool = True,
    m: Optional[int] = None, n: Optional[int] = None,
):
    """Segmented and checkpointed CRAIG."""
    return _sibling("craig", A, b, m, n, lambda A: min(A.m, A.n), (atol, btol),
                    segment_iters, checkpoint_path, resume_from, on_segment,
                    itnlim=itnlim, safe_norms=safe_norms)
