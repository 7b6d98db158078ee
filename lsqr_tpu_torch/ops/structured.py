"""Banded operators in the two DIA layouts of the JAX package.

PyTorch counterpart of :mod:`lsqr_tpu.ops.structured`'s DIA part:

* ``DIAOperator`` / ``dia_operator`` / ``dia_operator_device``: the packed
  layout, row-aligned stripes ``data (nd, m)`` with
  ``data[d, i] = A[i, i + offsets[d]]`` and their packed transpose
  ``tdata (nd, n)`` (offsets ``-k``). The layout the iteration megakernels
  need, and ``auto_operator``'s choice for f64 banded patterns.
* ``DIASharedOperator`` / ``dia_shared_operator``: one flat, zero-padded
  stripe array ``dp[d * Lp + H + i] = A[i, i + offsets[d]]`` that serves
  both products (half the memory); the f32 default of ``auto_operator``.

Kernel choice: every product of an operator whose stripes lie on CUDA goes
through the hand-written kernels (:mod:`.spmv`); on the CPU it goes through
their plain twins. There is no switch between the two. On CUDA the pair mode
is preferred for f32 and bf16 stripes, the fused half-step for f32 only (as
in the JAX package). f64 takes neither, so f64 solves on the card run
unfused through the f64 product kernels; a forced f64 pair or half-step
computes exact products.

bf16 stripes (``storage_dtype=torch.bfloat16``) are a storage format: the
products accumulate in f32 and return f32, and ``dtype`` reports f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..config import as_dtype
from .linop import LinearOperator, as_tensor
from .spmv import (
    _geometry,
    dia_fused_halfstep,
    dia_matvec,
    dia_matvec_axpy,
    dia_pair,
    dia_pair_shared,
    dia_product_shared,
    dia_product_shared_axpy,
)

__all__ = ["DIAOperator", "dia_operator", "dia_operator_device",
           "DIASharedOperator", "dia_shared_operator"]


def _offsets_tensor(offsets, device):
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _masked(data, offsets, m, n):
    """The stripes with every entry outside the m x n matrix set to 0."""
    i = torch.arange(m, device=data.device)
    mask = torch.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    return data * mask.to(data.dtype)


def _todense(data, offsets, m, n, dtype):
    """The dense m x n matrix of row-aligned stripes (testing convenience)."""
    dense = torch.zeros((m, n), dtype=dtype, device=data.device)
    i = torch.arange(m, device=data.device)
    data = data.to(dtype)
    for j, k in enumerate(offsets):
        valid = (i + k >= 0) & (i + k < n)
        dense[i[valid], i[valid] + k] += data[j][valid]
    return dense


def _no_complex(data):
    if data.is_complex():
        raise NotImplementedError(
            "complex stripes (ZDIA) are not ported yet (ROADMAP Queue 1 item 12)")


# ---------------------------------------------------------------------------
# DIA, packed: row-aligned stripes and their packed transpose
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DIAOperator(LinearOperator):
    """Banded m x n matrix in the packed DIA layout: ``data`` (nd, m) with
    ``data[d, i] = A[i, i + offsets[d]]`` (zero outside the matrix) and the
    transpose stripes ``tdata`` (nd, n) with ``tdata[d, c] = data[d, c - k]``,
    the offsets of Aᵀ being ``toffsets = -offsets``. ``offsets_t`` and
    ``toffsets_t`` are the int32 copies on the stripes' device that the
    kernels read; they are made when not given."""

    data: torch.Tensor
    tdata: torch.Tensor
    m: int
    n: int
    offsets: tuple
    offsets_t: Optional[torch.Tensor] = None
    toffsets_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        nd = len(self.offsets)
        if self.data.shape != (nd, self.m) or self.tdata.shape != (nd, self.n):
            raise ValueError(
                f"data {tuple(self.data.shape)} and tdata {tuple(self.tdata.shape)} "
                f"must have shapes ({nd}, {self.m}) and ({nd}, {self.n})")
        if self.tdata.dtype != self.data.dtype or self.tdata.device != self.data.device:
            raise ValueError("data and tdata must share dtype and device")
        if self.offsets_t is None:
            object.__setattr__(self, "offsets_t",
                               _offsets_tensor(self.offsets, self.data.device))
        if self.toffsets_t is None:
            object.__setattr__(self, "toffsets_t",
                               _offsets_tensor(self.toffsets, self.data.device))

    @property
    def dtype(self):
        return torch.float32 if self.data.dtype == torch.bfloat16 else self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        # stored entries, the structural zeros at the band edges included
        return len(self.offsets) * self.m

    @property
    def toffsets(self) -> tuple:
        return tuple(-k for k in self.offsets)

    @property
    def is_bf16_storage(self) -> bool:
        return self.data.dtype == torch.bfloat16

    @property
    def prefers_pair(self) -> bool:
        return self.data.is_cuda and self.data.dtype in (torch.float32, torch.bfloat16)

    @property
    def prefers_fused(self) -> bool:
        return self.data.is_cuda and self.data.dtype == torch.float32

    def matvec(self, x):
        return dia_matvec(self.data, x.to(self.dtype), offsets=self.offsets, m=self.m,
                          n=self.n, offsets_t=self.offsets_t)

    def rmatvec(self, y):
        # Aᵀ is itself a DIA matrix with negated offsets: the same kernel
        # streams the transpose stripes
        return dia_matvec(self.tdata, y.to(self.dtype), offsets=self.toffsets,
                          m=self.n, n=self.m, offsets_t=self.toffsets_t)

    def fused_halfstep(self, *, forward: bool, y, win, c1, c2):
        """One bidiagonalization half-step, product and axpy in one pass:
          forward:  A  (win*c1) - c2*y   on data,  with y (m,), win (n,)
          adjoint:  A' (win*c1) - c2*y   on tdata, with y (n,), win (m,)
        Returns (out, sum(out**2)). f32 stripes take the fused kernel (the
        norm in the same launch); bf16 stripes the product+axpy kernel and
        a separate norm; f64 stripes the exact product and an axpy."""
        if self.data.dtype == torch.float64:
            prod = self.matvec if forward else self.rmatvec
            out = prod(win * c1) - c2 * y
            return out, torch.sum(out * out)
        stripes, offs, offs_t = ((self.data, self.offsets, self.offsets_t) if forward
                                 else (self.tdata, self.toffsets, self.toffsets_t))
        m_out, n_in = (self.m, self.n) if forward else (self.n, self.m)
        args = (stripes, y.to(self.dtype), win.to(self.dtype), c1, c2)
        kw = dict(offsets=offs, m=m_out, n=n_in, offsets_t=offs_t)
        if self.data.dtype == torch.float32:
            return dia_fused_halfstep(*args, **kw)
        out = dia_matvec_axpy(*args, **kw, out_dtype=torch.float32)
        return out, torch.sum(out * out)

    def fused_pair(self, *, y, win, c1, c2):
        """Both bidiagonalization products in one pass over ``data``:
            u_new = A (win*c1) - c2*y,     z = A' u_new
        with y (m,), win (n,). f64 stripes take two exact products."""
        if self.data.dtype == torch.float64:
            u = self.matvec(win * c1) - c2 * y
            return u, self.rmatvec(u)
        return dia_pair(self.data, y.to(self.dtype), win.to(self.dtype), c1, c2,
                        offsets=self.offsets, m=self.m, n=self.n,
                        offsets_t=self.offsets_t)

    def todense(self) -> torch.Tensor:
        return _todense(self.data, self.offsets, self.m, self.n, self.dtype)


def dia_operator_device(m, n, offsets: Sequence[int], data: torch.Tensor, *,
                        storage_dtype=None) -> DIAOperator:
    """Build a :class:`DIAOperator` from stripes ``data`` (len(offsets), m)
    already on their device; the masking and the transpose packing run on
    that device, so the stripes never cross to the host.
    ``storage_dtype=torch.bfloat16`` stores both stripe arrays in bf16
    (rounded after masking and packing, as in the JAX package)."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    _no_complex(data)
    if tuple(data.shape) != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {tuple(data.shape)}")
    data = _masked(data, offsets, m, n)
    # tdata[j, c] = A[c - k, c] = data[j, c - k] on an n-long axis
    tdata = data.new_zeros((nd, n))
    for j, k in enumerate(offsets):
        lo, hi = max(0, -k), min(m, n - k)
        if hi > lo:
            tdata[j, lo + k:hi + k] = data[j, lo:hi]
    storage_dtype = as_dtype(storage_dtype)
    if storage_dtype is not None:
        data, tdata = data.to(storage_dtype), tdata.to(storage_dtype)
    return DIAOperator(data=data.contiguous(), tdata=tdata, m=int(m), n=int(n),
                       offsets=offsets)


def dia_operator(m, n, offsets: Sequence[int], data, *, dtype=None,
                 storage_dtype=None, device=None) -> DIAOperator:
    """Build a :class:`DIAOperator` from row-aligned stripes ``data``
    (len(offsets), m), ``data[d, i] = A[i, i + offsets[d]]`` (a numpy array,
    tensor or nested list). The masking and the transpose packing run on
    the host; the two stripe arrays then move to ``device`` once.
    ``storage_dtype=torch.bfloat16`` keeps bf16 stripes (f32 products).
    Complex stripes raise ``NotImplementedError`` (ZDIA, ROADMAP Queue 1
    item 12)."""
    data = as_tensor(data, dtype=dtype, device="cpu")
    op = dia_operator_device(m, n, offsets, data, storage_dtype=storage_dtype)
    if device is None:
        return op
    return DIAOperator(data=op.data.to(device), tdata=op.tdata.to(device), m=op.m,
                       n=op.n, offsets=op.offsets)


# ---------------------------------------------------------------------------
# DIA, shared: one padded stripe array for both products
# ---------------------------------------------------------------------------


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
            object.__setattr__(self, "offsets_t",
                               _offsets_tensor(self.offsets, self.dp.device))

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
        return self.dp.is_cuda and self.dp.dtype in (torch.float32, torch.bfloat16)

    @property
    def prefers_fused(self) -> bool:
        return self.dp.is_cuda and self.dp.dtype == torch.float32

    def matvec(self, x):
        return dia_product_shared(self.dp, x.to(self.dtype), adjoint=False, **self._kw())

    def rmatvec(self, y):
        return dia_product_shared(self.dp, y.to(self.dtype), adjoint=True, **self._kw())

    def fused_halfstep(self, *, forward: bool, y, win, c1, c2):
        """One bidiagonalization half-step, product and axpy in one pass:
          forward:  A  (win*c1) - c2*y   with y (m,), win (n,)
          adjoint:  A' (win*c1) - c2*y   with y (n,), win (m,)
        Returns (out, sum(out**2)). f64 stripes take the exact product
        kernel and an axpy instead (the axpy kernel takes f32 and bf16)."""
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
        return _todense(self.data, self.offsets, self.m, self.n, self.dtype)


def dia_shared_operator(m, n, offsets: Sequence[int], data, *, dtype=None,
                        storage_dtype=None, device=None) -> DIASharedOperator:
    """Build a :class:`DIASharedOperator` from row-aligned stripes ``data``
    of shape (len(offsets), m), ``data[d, i] = A[i, i + offsets[d]]``.
    Entries outside the matrix are zeroed; the padding is one copy on the
    device. ``storage_dtype=torch.bfloat16`` keeps bf16 stripes (f32
    products)."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    data = as_tensor(data, dtype=dtype, device=device)
    if tuple(data.shape) != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {tuple(data.shape)}")
    storage_dtype = as_dtype(storage_dtype)
    data = _masked(data, offsets, m, n)
    if storage_dtype is not None:
        data = data.to(storage_dtype)
    H, Lp = _geometry(offsets, m, n)
    dp = torch.zeros((nd, Lp), dtype=data.dtype, device=data.device)
    dp[:, H:H + m] = data
    return DIASharedOperator(dp=dp.reshape(-1), m=int(m), n=int(n),
                             offsets=offsets, H=H)
