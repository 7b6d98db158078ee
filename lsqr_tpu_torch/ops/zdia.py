"""Complex banded and jittered operators: plane-split ZDIA and ZJDIA.

PyTorch counterpart of :mod:`lsqr_tpu.ops.zdia`. A complex matrix
``A = Ar + i Ai`` is stored as two real planes, and every product is a fixed
combination of real products:

    A x   : (Ar xr - Ai xi) + i (Ar xi + Ai xr)
    A^H y : (Ar' yr + Ai' yi) + i (Ar' yi - Ai' yr)

The conjugation of the adjoint is a sign in the combination; no conjugated
copy of the matrix is made.

* ``ZDIAOperator``: the two planes in the packed DIA layout (``dr``, ``di``
  (nd, m)) and their packed transposes (``tdr``, ``tdi`` (nd, n), offsets
  ``-k``). Each product is four calls of :func:`~.spmv.dia_matvec` (the
  kernel on CUDA; f64 planes take its f64 variant, the exact route of the
  real f64 ``DIAOperator``). ``fused_pair`` runs :func:`~.spmv.zdia_pair`
  for f32 planes: both products of a bidiagonalization step in one pass
  over the planes (f64 planes take two exact products).
* ``ZJDIAOperator``: two :class:`~.jdia.JDIAOperator` planes packed from the
  same pattern; each product is four JDIA products (``jdia_matvec`` on CUDA).

f32 planes give complex64 products, f64 planes complex128.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .jdia import JDIAOperator, from_packing, pack_triplets
from .linop import LinearOperator, as_tensor, placement, to_numpy
from .spmv import dia_matvec, zdia_pair, zdia_pair_plain

__all__ = ["ZDIAOperator", "zdia_operator", "zdia_operator_device", "ZJDIAOperator",
           "zjdia_operator", "zjdia_pack", "zjdia_from_packings", "zdia_pair_plain"]


def _complex_dtype(real_dtype):
    return torch.complex64 if real_dtype == torch.float32 else torch.complex128


def _planes(x, rdt):
    """(real part, imaginary part) of x as contiguous ``rdt`` vectors."""
    if not x.is_complex():
        x = x.to(rdt)
        return x.contiguous(), torch.zeros_like(x)
    return x.real.to(rdt).contiguous(), x.imag.to(rdt).contiguous()


def _combine(re_re, im_im, re_im, im_re, sign):
    """(re_re - sign im_im) + i (re_im + sign im_re): the forward (sign 1)
    and the adjoint (sign -1) combinations of four real products."""
    if sign > 0:
        return torch.complex(re_re - im_im, re_im + im_re)
    return torch.complex(re_re + im_im, re_im - im_re)


@dataclasses.dataclass(frozen=True, eq=False)
class ZDIAOperator(LinearOperator):
    """Complex banded m x n matrix as two real packed DIA planes:
    ``dr[d, i] + 1j * di[d, i] = A[i, i + offsets[d]]`` (nd, m), zero outside
    the matrix; ``tdr``, ``tdi`` (nd, n) are the packed transposes of each
    plane (offsets ``-k``). ``offsets_t`` and ``toffsets_t`` are the int32
    copies on the planes' device that the kernels read."""

    dr: torch.Tensor
    di: torch.Tensor
    tdr: torch.Tensor
    tdi: torch.Tensor
    m: int
    n: int
    offsets: tuple
    offsets_t: Optional[torch.Tensor] = None
    toffsets_t: Optional[torch.Tensor] = None

    #: the solvers' pair path takes complex vectors with this operator
    supports_complex_pair = True

    def __post_init__(self):
        nd = len(self.offsets)
        for name, t, dim in (("dr", self.dr, self.m), ("di", self.di, self.m),
                             ("tdr", self.tdr, self.n), ("tdi", self.tdi, self.n)):
            if tuple(t.shape) != (nd, dim):
                raise ValueError(f"{name} must have shape ({nd}, {dim}), got "
                                 f"{tuple(t.shape)}")
            if t.dtype != self.dr.dtype or t.device != self.dr.device:
                raise ValueError("the four planes must share dtype and device")
        if self.dr.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"planes of dtype {self.dr.dtype}: float32 or float64")
        for name, offs in (("offsets_t", self.offsets), ("toffsets_t", self.toffsets)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, torch.tensor(offs, dtype=torch.int32,
                                                            device=self.dr.device))

    @property
    def dtype(self):
        return _complex_dtype(self.dr.dtype)

    @property
    def device(self):
        return self.dr.device

    @property
    def nnz(self) -> int:
        # stored complex entries, the structural zeros at the band edges included
        return len(self.offsets) * self.m

    @property
    def toffsets(self) -> tuple:
        return tuple(-k for k in self.offsets)

    @property
    def prefers_pair(self) -> bool:
        # the pair kernel reads the planes once for all four real products
        # of both sides, the port's rule for the real packed operator
        return self.dr.is_cuda and self.dr.dtype == torch.float32

    def _product(self, P, Q, offsets, offsets_t, m, n, x, sign):
        xr, xi = _planes(x, P.dtype)
        kw = dict(offsets=offsets, m=m, n=n, offsets_t=offsets_t)
        return _combine(dia_matvec(P, xr, **kw), dia_matvec(Q, xi, **kw),
                        dia_matvec(P, xi, **kw), dia_matvec(Q, xr, **kw), sign)

    def matvec(self, x):
        return self._product(self.dr, self.di, self.offsets, self.offsets_t, self.m,
                             self.n, x, 1)

    def rmatvec(self, y):
        # A^H on the transpose planes: the imaginary plane enters with a minus
        return self._product(self.tdr, self.tdi, self.toffsets, self.toffsets_t, self.n,
                             self.m, y, -1)

    def fused_pair(self, *, y, win, c1, c2):
        """u = A (win*c1) - c2*y and z = A^H u with REAL c1, c2, in one pass
        over the planes for f32 planes (:func:`~.spmv.zdia_pair`); f64
        planes take two exact products. Returns (u (m,), z (n,))."""
        if self.dr.dtype == torch.float64:
            u = self.matvec(win * c1) - c2 * y
            return u, self.rmatvec(u)
        return zdia_pair(self.dr, self.di, y.to(torch.complex64), win.to(torch.complex64),
                         c1, c2, offsets=self.offsets, m=self.m, n=self.n,
                         offsets_t=self.offsets_t)

    def todense(self) -> torch.Tensor:
        dense = torch.zeros((self.m, self.n), dtype=self.dtype, device=self.device)
        i = torch.arange(self.m, device=self.device)
        data = torch.complex(self.dr, self.di)
        for d, k in enumerate(self.offsets):
            ok = (i + k >= 0) & (i + k < self.n)
            dense[i[ok], i[ok] + k] += data[d][ok]
        return dense


def zdia_operator_device(m, n, offsets: Sequence[int], data: torch.Tensor) -> ZDIAOperator:
    """Build a :class:`ZDIAOperator` from complex stripes ``data``
    (len(offsets), m), ``data[d, i] = A[i, i + offsets[d]]``, already on
    their device: the masking and the transpose packing run there.
    complex64 gives f32 planes, complex128 f64 planes."""
    from .structured import _masked, _transpose_stripes

    offsets = tuple(int(k) for k in offsets)
    if tuple(data.shape) != (len(offsets), m):
        raise ValueError(f"data must have shape ({len(offsets)}, {m}), got "
                         f"{tuple(data.shape)}")
    if not data.is_complex():
        data = data.to(torch.complex64)
    rdt = torch.float32 if data.dtype == torch.complex64 else torch.float64
    dr = _masked(data.real.to(rdt), offsets, m, n).contiguous()
    di = _masked(data.imag.to(rdt), offsets, m, n).contiguous()
    return ZDIAOperator(dr=dr, di=di, tdr=_transpose_stripes(dr, offsets, m, n),
                        tdi=_transpose_stripes(di, offsets, m, n), m=int(m), n=int(n),
                        offsets=offsets)


def zdia_operator(m, n, offsets: Sequence[int], data, *, dtype=None,
                  device=None) -> ZDIAOperator:
    """Build a :class:`ZDIAOperator` from complex stripes ``data`` (a numpy
    array, tensor or nested list), masked and packed on the host and moved
    to ``device`` once (when None: the device of a tensor ``data``, else the
    card). Real stripes become complex64."""
    device = placement(data, device)
    op = zdia_operator_device(m, n, offsets, as_tensor(data, dtype=dtype, device="cpu"))
    if op.device == device:
        return op
    return ZDIAOperator(dr=op.dr.to(device), di=op.di.to(device), tdr=op.tdr.to(device),
                        tdi=op.tdi.to(device), m=op.m, n=op.n, offsets=op.offsets)


@dataclasses.dataclass(frozen=True, eq=False)
class ZJDIAOperator(LinearOperator):
    """Complex general-sparse operator over two real
    :class:`~.jdia.JDIAOperator` planes packed from the same pattern (so
    their slots and remainders line up entry for entry). Each product is
    four real JDIA products combined as ZDIA's are. It has no pair kernel:
    the solvers take the two-product path."""

    re: JDIAOperator
    im: JDIAOperator

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.re.m

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.re.n

    @property
    def dtype(self):
        return _complex_dtype(self.re.dtype)

    @property
    def device(self):
        return self.re.device

    @property
    def nnz(self) -> int:
        return self.re.nnz

    @property
    def fit_fraction(self) -> float:
        return self.re.fit_fraction

    def matvec(self, x):
        xr, xi = _planes(x, self.re.dtype)
        return _combine(self.re.matvec(xr), self.im.matvec(xi), self.re.matvec(xi),
                        self.im.matvec(xr), 1)

    def rmatvec(self, y):
        yr, yi = _planes(y, self.re.dtype)
        return _combine(self.re.rmatvec(yr), self.im.rmatvec(yi), self.re.rmatvec(yi),
                        self.im.rmatvec(yr), -1)

    def todense(self) -> torch.Tensor:
        return torch.complex(self.re.todense(), self.im.todense()).to(self.dtype)


def zjdia_pack(m, n, vals, rows, cols, *, ns_max=16, dtype=None):
    """The host half of :func:`zjdia_operator`: the :func:`~.jdia.jdia_pack`
    dicts of the real and the imaginary plane (the same slots), and the
    number of entries. Raises ValueError or
    :class:`~.jdia.JDIAFixpointError` where the packer refuses the pattern."""
    vals = to_numpy(vals, dtype)
    if not np.iscomplexobj(vals):
        vals = vals.astype(np.complex64)
    rdt = np.float32 if vals.dtype == np.complex64 else np.float64
    re, im = (pack_triplets(m, n, part.astype(rdt), rows, cols, ns_max=ns_max, dtype=rdt)[0]
              for part in (vals.real, vals.imag))
    return re, im, len(vals)


def zjdia_from_packings(re, im, m, n, nnz, device) -> ZJDIAOperator:
    """The operator over the two plane packings of :func:`zjdia_pack`."""
    return ZJDIAOperator(re=from_packing(re, m, n, nnz, device),
                         im=from_packing(im, m, n, nnz, device))


def zjdia_operator(m, n, vals, rows, cols, *, ns_max=16, dtype=None,
                   device=None) -> ZJDIAOperator:
    """Build a :class:`ZJDIAOperator` from complex COO triplets (duplicates
    summed beforehand), packed on the host and moved to ``device`` once
    (when None: the device of a tensor ``vals``, else the card): both planes
    pack the whole pattern. complex64 values give f32 planes (the JDIA
    kernel on CUDA), complex128 f64 planes (the twin on every device, as
    JAX takes its XLA form); real values become complex64."""
    device = placement(vals, device)
    re, im, nnz = zjdia_pack(m, n, vals, to_numpy(rows), to_numpy(cols), ns_max=ns_max,
                             dtype=dtype)
    return zjdia_from_packings(re, im, m, n, nnz, device)
