"""Structured operators: the two DIA layouts, ELL, HYB and BlockELL.

PyTorch counterpart of :mod:`lsqr_tpu.ops.structured`:

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

* ``ELLOperator`` / ``ell_operator``: padded rows and their transpose
  packing; the products are gathers (JAX has no ELL kernel either).
* ``hyb_operator``: ELL of a bounded width plus a COO spill, summed
  (:class:`~lsqr_tpu_torch.ops.compose.SumOperator`), for power-law rows.
* ``BlockELLOperator`` / ``block_ell_operator``: dense (bh, bw) blocks in
  ELL layout. On CUDA its f32 products go through the BlockELL kernels
  (:mod:`.spmv_sparse`), on the CPU and for f64 through their twins.

The ELL, HYB and BlockELL builders pack on the host (:mod:`..native`) and
move the packed arrays to ``device`` once; ``device=None`` means the device
of a tensor ``vals``, else the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..config import as_dtype
from .coo import destination_order, segment_sum
from .linop import LinearOperator, as_tensor, placement, to_numpy
from .spmv import (
    _aligned,
    _geometry,
    dia_fused_halfstep,
    dia_matvec,
    dia_matvec_axpy,
    dia_pair,
    dia_pair_shared,
    dia_product_shared,
    dia_product_shared_axpy,
)
from .spmv_sparse import (
    block_ell_matvec,
    block_ell_matvec_plain,
    block_ell_matvec_windowed,
    block_ell_pair_plain,
    block_ell_pair_windowed,
    windowed_rows_per_tile,
)

__all__ = ["DIAOperator", "dia_operator", "dia_operator_device",
           "DIASharedOperator", "dia_shared_operator", "ELLOperator", "ell_operator",
           "hyb_operator", "BlockELLOperator", "block_ell_operator"]


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


def _transpose_stripes(data, offsets, m, n):
    """The packed transpose of row-aligned stripes (nd, m): (nd, n) with
    ``t[d, c] = A[c - k, c] = data[d, c - k]``, on data's device."""
    t = data.new_zeros((len(offsets), n))
    for j, k in enumerate(offsets):
        lo, hi = max(0, -k), min(m, n - k)
        if hi > lo:
            t[j, lo + k:hi + k] = data[j, lo:hi]
    return t


def _real_only(storage_dtype):
    """Complex stripes go to the plane-split ZDIA operator, which stores
    them as they are: bf16 storage applies to real stripes only."""
    if storage_dtype is not None:
        raise ValueError("storage_dtype applies to real stripes only")


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
        # stripes off the 16-byte grid are copied once here: the staged
        # kernels copy them in 16-byte pieces
        for name in ("data", "tdata"):
            object.__setattr__(self, name, _aligned(getattr(self, name))[0])
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


@tracing.builder("dia_operator_device")
def dia_operator_device(m, n, offsets: Sequence[int], data: torch.Tensor, *,
                        storage_dtype=None) -> DIAOperator:
    """Build a :class:`DIAOperator` from stripes ``data`` (len(offsets), m)
    already on their device; the masking and the transpose packing run on
    that device, so the stripes never cross to the host.
    ``storage_dtype=torch.bfloat16`` stores both stripe arrays in bf16
    (rounded after masking and packing, as in the JAX package). Complex
    stripes give the plane-split
    :class:`~lsqr_tpu_torch.ops.zdia.ZDIAOperator`."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    if data.is_complex():
        from .zdia import zdia_operator_device

        _real_only(storage_dtype)
        return zdia_operator_device(m, n, offsets, data)
    if tuple(data.shape) != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {tuple(data.shape)}")
    with tracing.span("build.pack"):
        data = _masked(data, offsets, m, n)
        tdata = _transpose_stripes(data, offsets, m, n)
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
    the host; the two stripe arrays then move to ``device`` once (when None:
    the device of a tensor ``data``, else the card).
    ``storage_dtype=torch.bfloat16`` keeps bf16 stripes (f32 products).
    Complex stripes give the plane-split
    :class:`~lsqr_tpu_torch.ops.zdia.ZDIAOperator` (``storage_dtype`` then
    raises ValueError)."""
    device = placement(data, device)
    data = as_tensor(data, dtype=dtype, device="cpu")
    if data.is_complex():
        from .zdia import zdia_operator

        _real_only(storage_dtype)
        return zdia_operator(m, n, offsets, data, device=device)
    op = dia_operator_device(m, n, offsets, data, storage_dtype=storage_dtype)
    if op.device == device:
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
        object.__setattr__(self, "dp", _aligned(self.dp)[0])  # as DIAOperator's stripes
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


@tracing.builder("dia_shared_operator")
def dia_shared_operator(m, n, offsets: Sequence[int], data, *, dtype=None,
                        storage_dtype=None, device=None) -> DIASharedOperator:
    """Build a :class:`DIASharedOperator` from row-aligned stripes ``data``
    of shape (len(offsets), m), ``data[d, i] = A[i, i + offsets[d]]``, on
    ``device`` (the card when None; a tensor stays where it is unless a
    device is named). Entries outside the matrix are zeroed; the padding is
    one copy on the device. ``storage_dtype=torch.bfloat16`` keeps bf16 stripes (f32
    products)."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    with tracing.span("build.upload"):
        data = as_tensor(data, dtype=dtype, device=device)
    if tuple(data.shape) != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {tuple(data.shape)}")
    storage_dtype = as_dtype(storage_dtype)
    with tracing.span("build.pack"):
        data = _masked(data, offsets, m, n)
        if storage_dtype is not None:
            data = data.to(storage_dtype)
        H, Lp = _geometry(offsets, m, n)
        dp = torch.zeros((nd, Lp), dtype=data.dtype, device=data.device)
        dp[:, H:H + m] = data
        return DIASharedOperator(dp=dp.reshape(-1), m=int(m), n=int(n),
                                 offsets=offsets, H=H)


# ---------------------------------------------------------------------------
# ELL: padded rows (gather-only products)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ELLOperator(LinearOperator):
    """m x n sparse matrix in ELL (padded-row) layout with its transpose
    packing, so both products are gathers:

    vals/cols (m, k): the forward packing (padded entries: value 0, col 0);
    tvals/trows (n, kt): the packing of A'. Indices are int64 on the
    device."""

    vals: torch.Tensor
    cols: torch.Tensor
    tvals: torch.Tensor
    trows: torch.Tensor
    m: int
    n: int

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz(self) -> int:
        return self.vals.shape[0] * self.vals.shape[1]

    def matvec(self, x):
        return torch.sum(self.vals * x.to(self.dtype)[self.cols], dim=1)

    def rmatvec(self, y):
        return torch.sum(self.tvals * y.to(self.dtype)[self.trows], dim=1)

    def todense(self):
        dense = torch.zeros((self.m, self.n), dtype=self.dtype, device=self.device)
        rows = torch.arange(self.m, device=self.device).repeat_interleave(self.vals.shape[1])
        return dense.index_put_((rows, self.cols.reshape(-1)), self.vals.reshape(-1),
                                accumulate=True)


def ell_operator(m, n, vals, rows, cols, *, dtype=None, device=None) -> ELLOperator:
    """Build an :class:`ELLOperator` and its transpose packing from COO
    triplets, packed on the host by :mod:`..native`."""
    from .. import native

    device = placement(vals, device)
    vals, rows, cols = to_numpy(vals, dtype), to_numpy(rows), to_numpy(cols)
    fv, fc = native.ell_pack(rows, cols, vals, m)
    tv, tr = native.ell_pack(cols, rows, vals, n)

    def t(a, dt=None):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return ELLOperator(vals=t(fv), cols=t(fc, torch.int64), tvals=t(tv),
                       trows=t(tr, torch.int64), m=int(m), n=int(n))


#: the HYB width rule's cost of a spilled COO entry against a streamed ELL
#: slot (the JAX package's SPILL_COST, kept so both pick the same width)
SPILL_COST = 1.5


def hyb_width(counts, m) -> int:
    """The JAX package's cost-balanced HYB width: the smallest w minimising
    m*w + SPILL_COST * (entries past w), over w = 1 and the distinct row
    lengths."""
    wmax = int(counts.max())
    best_w, best_cost = wmax, m * wmax
    for w in np.union1d([1], np.unique(counts[counts > 0])):
        w = int(w)
        cost = m * w + SPILL_COST * int(np.maximum(counts - w, 0).sum())
        if cost < best_cost:
            best_w, best_cost = w, cost
    return max(1, best_w)


def hyb_operator(m, n, vals, rows, cols, *, width=None, dtype=None, device=None):
    """HYB (ELL + COO spill) operator for power-law row distributions: each
    row's first ``width`` entries (in column order) go to an ELL part, the
    rest to a COO part, summed by a
    :class:`~lsqr_tpu_torch.ops.compose.SumOperator` (a pure ELL operator
    when nothing spills). ``width=None`` takes :func:`hyb_width`. Real
    values only."""
    from .compose import add_operators
    from .coo import coo_operator

    device = placement(vals, device)
    vals, rows, cols = to_numpy(vals, dtype), to_numpy(rows), to_numpy(cols)
    if np.iscomplexobj(vals):
        raise ValueError("hyb_operator is real-only; complex matrices use the COO "
                         "path (coo_operator / auto_operator)")
    if vals.size == 0:
        return coo_operator(m, n, vals, rows, cols, dtype=dtype, device=device)
    order = np.lexsort((cols, rows))
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    counts = np.bincount(rows_s, minlength=m)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(vals_s)) - np.repeat(row_start, counts)
    if width is None:
        width = hyb_width(counts, m)
    main = rank < width
    E = ell_operator(m, n, vals_s[main], rows_s[main], cols_s[main], dtype=dtype,
                     device=device)
    if bool(np.all(main)):
        return E
    C = coo_operator(m, n, vals_s[~main], rows_s[~main], cols_s[~main], dtype=dtype,
                     device=device)
    return add_operators([E, C])


# ---------------------------------------------------------------------------
# BlockELL: dense blocks in ELL layout
# ---------------------------------------------------------------------------


def _pad_to(x, length):
    if x.shape[0] == length:
        return x
    return torch.cat([x, x.new_zeros(length - x.shape[0])])


@dataclasses.dataclass(frozen=True, eq=False)
class BlockELLOperator(LinearOperator):
    """Block-sparse m x n matrix: dense (bh, bw) blocks in ELL layout.

    blocks (mb, kb, bh, bw), bcols (mb, kb) int32: kb blocks per block row,
    zero blocks padding the short rows; tblocks/tbrows (nb, kt, bw, bh),
    (nb, kt): the transpose packing, padded to the most blocks in one block
    column (kt), so a scattered pattern stores more there than in blocks.

    Products: on CUDA an f32 operator runs, for each packing,
    ``block_ell_matvec_windowed`` where one block row's x segments fit the
    Pallas kernel's window, else ``block_ell_matvec``, as JAX routes its two
    kernels (on the card both run one kernel, which splits long block rows
    across CTAs: ``spmv_sparse.block_ell_plan``). With 128-wide blocks, a
    packing of more than 96 blocks per block row (such as the transpose of
    a tall pattern, kt > 96) takes the latter.
    ``fused_pair`` runs ``block_ell_pair_windowed``. On the CPU and for f64
    they run the einsum twins. ``prefers_pair`` stays False, as in JAX:
    ``pair=True`` is the opt-in. ``zorder``/``zoffsets``, built with the
    operator, list the mb*kb blocks by block column (stable) for the
    pair's fixed-order sum."""

    blocks: torch.Tensor
    bcols: torch.Tensor
    tblocks: torch.Tensor
    tbrows: torch.Tensor
    m: int
    n: int
    zorder: torch.Tensor = dataclasses.field(init=False, repr=False)
    zoffsets: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        order, offsets = destination_order(self.bcols.reshape(-1), self.tblocks.shape[0])
        object.__setattr__(self, "zorder", order)
        object.__setattr__(self, "zoffsets", offsets)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def bh(self) -> int:
        return self.blocks.shape[2]

    @property
    def bw(self) -> int:
        return self.blocks.shape[3]

    @property
    def kb(self) -> int:
        return self.blocks.shape[1]

    @property
    def kt(self) -> int:
        return self.tblocks.shape[1]

    @property
    def nnz(self) -> int:
        return self.blocks.numel()

    @property
    def prefers_pair(self) -> bool:
        return False

    def _kernels(self) -> bool:
        return self.blocks.is_cuda and self.dtype == torch.float32

    def _product(self, blocks, bcols, x):
        if not self._kernels():
            return block_ell_matvec_plain(blocks, bcols, x)
        mb, kb, _, bw = blocks.shape
        if windowed_rows_per_tile(mb, kb, bw):
            return block_ell_matvec_windowed(blocks, bcols, x)
        return block_ell_matvec(blocks, bcols, x)

    def matvec(self, x):
        xp = _pad_to(x.to(self.dtype), self.tblocks.shape[0] * self.bw)
        return self._product(self.blocks, self.bcols, xp)[:self.m]

    def rmatvec(self, y):
        yp = _pad_to(y.to(self.dtype), self.blocks.shape[0] * self.bh)
        return self._product(self.tblocks, self.tbrows, yp)[:self.n]

    def fused_pair(self, *, y, win, c1, c2):
        """Both bidiagonalization products: u = A(win*c1) - c2*y and
        z = A'u, from one pass over ``blocks`` (no transpose packing): the
        pair gives u and the per-block partials zp[r, j] = blocks[r, j]' u_r,
        and z is their sum by block column: the mb*kb zp rows gathered in
        block-column order (``zorder``) and summed per block column in row
        order (``segment_sum``), the same bits in every run."""
        mb, kb, bh, bw = self.blocks.shape
        xp = _pad_to(win.to(self.dtype), self.tblocks.shape[0] * bw)
        yp = _pad_to(y.to(self.dtype), mb * bh)
        pair = block_ell_pair_windowed if self._kernels() else block_ell_pair_plain
        u, zp = pair(self.blocks, self.bcols, xp, yp, c1, c2)
        z = segment_sum(zp.reshape(mb * kb, bw)[self.zorder], self.zoffsets)
        return u[:self.m], z.reshape(-1)[:self.n]

    def todense(self):
        mb, kb, bh, bw = self.blocks.shape
        nb = self.tblocks.shape[0]
        dense = torch.zeros((mb, bh, nb, bw), dtype=self.dtype, device=self.device)
        r = torch.arange(mb, device=self.device).repeat_interleave(kb)
        dense = dense.permute(0, 2, 1, 3)            # (mb, nb, bh, bw), a view
        dense.index_put_((r, self.bcols.reshape(-1).long()),
                         self.blocks.reshape(mb * kb, bh, bw), accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(mb * bh, nb * bw)[:self.m, :self.n]


def block_ell_operator(m, n, vals, rows, cols, *, block=(128, 128), dtype=None,
                       device=None) -> BlockELLOperator:
    """Build a :class:`BlockELLOperator` from COO triplets by snapping the
    entries into dense (bh, bw) blocks, on the host (:mod:`..native`).
    Raises ValueError when the blocks would store more than 64x the
    entries (a pattern that is not blocky)."""
    from .. import native

    device = placement(vals, device)
    bh, bw = block
    vals, rows, cols = to_numpy(vals, dtype), to_numpy(rows), to_numpy(cols)
    mb, nb = -(-m // bh), -(-n // bw)
    stride = max(nb, mb)
    fb, fc = native.block_pack(rows, cols, vals, mb, bh, bw, stride)
    tb, tr = native.block_pack(cols, rows, vals, nb, bw, bh, stride)

    def t(a):
        return torch.from_numpy(a).to(device)

    return BlockELLOperator(blocks=t(fb), bcols=t(fc), tblocks=t(tb), tbrows=t(tr),
                            m=int(m), n=int(n))
