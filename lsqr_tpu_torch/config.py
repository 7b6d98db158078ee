"""Configuration layer: solver options and the dtype policy.

PyTorch counterpart of :mod:`lsqr_tpu.config`. The options keep every field
of the JAX package so that the same keyword arguments drive both solvers.

Dtype policy: there is no global switch. The working dtype follows the
inputs (``torch.promote_types`` of b and A); float64 tensors are the
conformance mode that reproduces the reference's real64 iteration counts,
float32 on CUDA is the fast path that runs through the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = ["LSQROptions", "default_dtype", "eps_for", "as_dtype", "real_dtype",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """Where a builder puts what it builds: the card (``cuda``) unless the
    caller names a device. An explicit device passes through unchanged.
    There is no fallback: without a card, building on the default device
    fails (as ``.to("cuda")`` does on a CPU build of torch); the CPU is
    used only when asked for, as in ``device="cpu"``."""
    return torch.device("cuda") if device is None else torch.device(device)


def default_dtype() -> torch.dtype:
    """The working precision when nothing else fixes it: PyTorch's default
    floating dtype (float32 unless the caller changed it)."""
    return torch.get_default_dtype()


def as_dtype(dtype) -> Optional[torch.dtype]:
    """Accept a ``torch.dtype``, its name (``"float64"``) or a numpy dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, str):
        import numpy as np

        dtype = np.dtype(dtype).name
    return getattr(torch, dtype)


def real_dtype(dtype) -> torch.dtype:
    """The real dtype of a complex one (complex64 -> float32); a real dtype
    unchanged. The scalars of a complex solve live in it."""
    dtype = as_dtype(dtype)
    return dtype.to_real() if dtype.is_complex else dtype


def eps_for(dtype) -> float:
    """Machine precision (`relpr` in the reference docs, lsqr.f90:353-356)."""
    return float(torch.finfo(as_dtype(dtype)).eps)


@dataclasses.dataclass(frozen=True)
class LSQROptions:
    """Solver options; the fields and defaults of
    :class:`lsqr_tpu.config.LSQROptions`.

    Differences in meaning:

    * ``loop``: both forms run the same host-stepped masked segments of
      ``loop_segment`` iterations (one host read of istop/itn per
      segment); ``istop``/``itn`` equal those of JAX's ``while_loop``.
    * ``debug_log=True`` raises ``NotImplementedError`` (ROADMAP Queue 1
      item 8).
    * ``megakernel=True`` routes the solve through the LSQR iteration
      megakernel (K iterations per launch, :mod:`.ops.megakernel`): the
      CUDA kernel on the card, its plain twin on the CPU (where JAX runs
      the Pallas kernel interpreted). An unsupported configuration raises
      ``ValueError``. None means False, as in the JAX package; whether the
      amortization pays on the H100 is measured in PERF.md, not assumed.
    """

    atol: float = 0.0
    btol: float = 0.0
    conlim: float = 0.0
    itnlim: Optional[int] = None
    wantse: bool = False
    nconv: int = 1
    record_trace: bool = False
    safe_norms: bool = True
    debug_log: bool = False
    dtype: Optional[Union[torch.dtype, str]] = None
    loop: Optional[str] = None
    loop_segment: int = 64
    fused: Optional[bool] = None
    pair: Optional[bool] = None
    scalar_dtype: Optional[Union[torch.dtype, str]] = None
    megakernel: Optional[bool] = None

    def resolve_itnlim(self, n: int) -> int:
        return int(self.itnlim) if self.itnlim is not None else 4 * int(n)

    def replace(self, **kw) -> "LSQROptions":
        return dataclasses.replace(self, **kw)
