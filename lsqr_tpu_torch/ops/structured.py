"""The main-path operator: banded A in the shared-stripe DIA layout.

PyTorch counterpart of ``DIASharedOperator`` and ``dia_shared_operator`` in
:mod:`lsqr_tpu.ops.structured`. One flat, zero-padded stripe array
``dp[d * Lp + H + i] = A[i, i + offsets[d]]`` serves both products.

Kernel choice: every product of an operator whose stripes lie on CUDA goes
through the hand-written kernels (:mod:`.spmv`); on the CPU it goes through
their plain twins. Pair and fused modes are preferred exactly for f32
stripes on CUDA; f64 never takes them (as in the JAX package), so f64
solves on the card run unfused through the f64 product kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..config import as_dtype
from .linop import LinearOperator, as_tensor
from .spmv import (
    _geometry,
    dia_pair_shared,
    dia_product_shared,
    dia_product_shared_axpy,
    no_bf16_kernel,
)

__all__ = ["DIASharedOperator", "dia_shared_operator"]


@dataclasses.dataclass(frozen=True, eq=False)
class DIASharedOperator(LinearOperator):
    """Banded m x n matrix stored as one flat padded stripe array ``dp``
    (nd * Lp,) that serves both the forward and the adjoint product.
    ``offsets_t`` is the int32 copy of ``offsets`` on dp's device that the
    kernels read; it is made from ``offsets`` when not given."""

    dp: torch.Tensor
    m: int
    n: int
    offsets: tuple
    H: int
    offsets_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        H, Lp = _geometry(self.offsets, self.m, self.n)
        if self.H != H or self.dp.shape != (len(self.offsets) * Lp,):
            raise ValueError(
                f"dp of shape {tuple(self.dp.shape)} with H={self.H} does not "
                f"match the geometry (H={H}, nd*Lp={len(self.offsets) * Lp})"
            )
        if self.offsets_t is None:
            object.__setattr__(self, "offsets_t", torch.tensor(
                self.offsets, dtype=torch.int32, device=self.dp.device))

    @property
    def dtype(self):
        return torch.float32 if self.dp.dtype == torch.bfloat16 else self.dp.dtype

    @property
    def device(self):
        return self.dp.device

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.m

    @property
    def Lp(self) -> int:
        return self.dp.shape[0] // len(self.offsets)

    @property
    def data(self) -> torch.Tensor:
        """The unpadded row-aligned stripes (nd, m), a view of dp."""
        return self.dp.view(len(self.offsets), self.Lp)[:, self.H:self.H + self.m]

    @property
    def is_bf16_storage(self) -> bool:
        return self.dp.dtype == torch.bfloat16

    def _kw(self):
        return dict(offsets=self.offsets, m=self.m, n=self.n, offsets_t=self.offsets_t)

    @property
    def prefers_pair(self) -> bool:
        return self.dp.is_cuda and self.dp.dtype == torch.float32

    @property
    def prefers_fused(self) -> bool:
        return self.prefers_pair

    def matvec(self, x):
        return dia_product_shared(self.dp, x.to(self.dtype), adjoint=False, **self._kw())

    def rmatvec(self, y):
        return dia_product_shared(self.dp, y.to(self.dtype), adjoint=True, **self._kw())

    def fused_halfstep(self, *, forward: bool, y, win, c1, c2):
        """One bidiagonalization half-step, product and axpy in one pass:
          forward:  A  (win*c1) - c2*y   with y (m,), win (n,)
          adjoint:  A' (win*c1) - c2*y   with y (n,), win (m,)
        Returns (out, sum(out**2)). f64 stripes take the exact product
        kernel and an axpy instead (the axpy kernel is f32)."""
        if self.dp.dtype == torch.float64:
            prod = self.matvec if forward else self.rmatvec
            out = prod(win * c1) - c2 * y
        else:
            out = dia_product_shared_axpy(
                self.dp, win.to(self.dtype), y.to(self.dtype), c1, c2,
                adjoint=not forward, **self._kw())
        return out, torch.sum(out * out)

    def fused_pair(self, *, y, win, c1, c2):
        """Both bidiagonalization products in one pass over the stripes:
            u_new = A (win*c1) - c2*y,     z = A' u_new
        with y (m,), win (n,). f64 stripes take two exact products."""
        if self.dp.dtype == torch.float64:
            u = self.matvec(win * c1) - c2 * y
            return u, self.rmatvec(u)
        return dia_pair_shared(self.dp, win.to(self.dtype), y.to(self.dtype),
                               c1, c2, **self._kw())

    def todense(self) -> torch.Tensor:
        dense = torch.zeros((self.m, self.n), dtype=self.dtype, device=self.device)
        i = torch.arange(self.m, device=self.device)
        data = self.data.to(self.dtype)
        for j, k in enumerate(self.offsets):
            valid = (i + k >= 0) & (i + k < self.n)
            dense[i[valid], i[valid] + k] += data[j][valid]
        return dense


def dia_shared_operator(m, n, offsets: Sequence[int], data, *, dtype=None,
                        storage_dtype=None, device=None) -> DIASharedOperator:
    """Build a :class:`DIASharedOperator` from row-aligned stripes ``data``
    of shape (len(offsets), m), ``data[d, i] = A[i, i + offsets[d]]``.
    Entries outside the matrix are zeroed; the padding is one copy on the
    device. ``storage_dtype=torch.bfloat16`` keeps bf16 stripes (CPU only
    for now: the CUDA kernels take f32 and f64)."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    data = as_tensor(data, dtype=dtype, device=device)
    if tuple(data.shape) != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {tuple(data.shape)}")
    storage_dtype = as_dtype(storage_dtype)
    if storage_dtype == torch.bfloat16 and data.is_cuda:
        no_bf16_kernel()
    i = torch.arange(m, device=data.device)
    mask = torch.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    data = data * mask.to(data.dtype)
    if storage_dtype is not None:
        data = data.to(storage_dtype)
    H, Lp = _geometry(offsets, m, n)
    dp = torch.zeros((nd, Lp), dtype=data.dtype, device=data.device)
    dp[:, H:H + m] = data
    return DIASharedOperator(dp=dp.reshape(-1), m=int(m), n=int(n),
                             offsets=offsets, H=H)
