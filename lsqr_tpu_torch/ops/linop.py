"""Linear-operator layer: the ``aprod`` protocol (lsqr.f90:67-82) as two
products on tensors,

    matvec(x)  -> A  @ x     (shape (m,))
    rmatvec(y) -> A' @ y     (shape (n,))

PyTorch counterpart of :mod:`lsqr_tpu.ops.linop`. Operators are plain
objects holding tensors; the device is the device of those tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import as_dtype, resolve_device

__all__ = ["LinearOperator", "DenseOperator", "CallbackOperator", "as_operator",
           "as_tensor", "placement", "to_numpy"]


def to_numpy(a, dtype=None) -> np.ndarray:
    """A numpy array of a tensor (copied to the host), numpy array or list,
    cast to ``dtype`` (torch or numpy, or its name) when one is given: the
    input of the host packers."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if dtype is None:
        return a
    return a.astype(torch.empty((), dtype=as_dtype(dtype)).numpy().dtype, copy=False)


def placement(a, device=None) -> torch.device:
    """Where a builder puts what it makes from ``a``: ``device`` when one is
    named, else the device of a tensor ``a``, else the card
    (:func:`~lsqr_tpu_torch.config.resolve_device`)."""
    if device is None and isinstance(a, torch.Tensor):
        return a.device
    return resolve_device(device)


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """Tensor from a tensor, numpy array or nested list. Python floats
    become float64 (numpy's rule), so the dtype follows the input values.
    A tensor stays on its device unless ``device`` names another; host data
    goes to :func:`~lsqr_tpu_torch.config.resolve_device` (the card when
    ``device`` is None)."""
    dev = placement(a, device)
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, copy=True))
    return a.to(device=dev, dtype=as_dtype(dtype))


class LinearOperator:
    """Abstract base. Subclasses define m, n, dtype, device, matvec, rmatvec."""

    m: int
    n: int

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def device(self) -> Optional[torch.device]:
        return None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def T(self) -> "LinearOperator":
        """The adjoint operator: swaps matvec and rmatvec."""
        return _TransposedOperator(op=self)

    def todense(self) -> torch.Tensor:
        """Materialize A column by column (testing convenience)."""
        eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
        return torch.stack([self.matvec(e) for e in eye], dim=1)


def _matmul(a, x):
    """a @ x in the promoted dtype (a real matrix takes complex vectors, as
    in JAX); no copy when the dtypes agree."""
    dt = torch.promote_types(a.dtype, x.dtype)
    return a.to(dt) @ x.to(dt)


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense A; the products are ``torch.matmul`` (``rmatvec`` with the
    conjugate transpose ``A.mH``)."""

    a: torch.Tensor

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.a.shape[0]

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.a.shape[1]

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        return _matmul(self.a, x)

    def rmatvec(self, y):
        return _matmul(self.a.mH, y)

    def todense(self):
        return self.a


@dataclasses.dataclass(frozen=True)
class _TransposedOperator(LinearOperator):
    op: LinearOperator

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.op.n

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.op.m

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, y):
        return self.op.matvec(y)


@dataclasses.dataclass(frozen=True)
class CallbackOperator(LinearOperator):
    """Bring-your-own matvec/rmatvec (the reference's custom ``aprod``,
    lsqr.f90:16-30)."""

    m: int
    n: int
    _matvec: Callable[[torch.Tensor], torch.Tensor]
    _rmatvec: Callable[[torch.Tensor], torch.Tensor]
    dtype: Optional[torch.dtype] = None
    _device: Optional[torch.device] = None

    @property
    def device(self):
        return self._device

    def matvec(self, x):
        return self._matvec(x)

    def rmatvec(self, y):
        return self._rmatvec(y)


def as_operator(a, m: Optional[int] = None, n: Optional[int] = None, *,
                device=None) -> LinearOperator:
    """Coerce an operator, a dense 2-D array or tensor, or a
    (matvec, rmatvec) pair with explicit m, n to a LinearOperator. A numpy
    array or list goes to ``device`` (the card when None); a tensor stays
    where it is."""
    if isinstance(a, LinearOperator):
        return a
    if callable(a):
        raise TypeError(
            "pass (matvec, rmatvec) as a tuple together with m and n, "
            "or build a CallbackOperator directly"
        )
    if isinstance(a, (tuple, list)) and len(a) == 2 and callable(a[0]):
        if m is None or n is None:
            raise ValueError("m and n are required for a (matvec, rmatvec) pair")
        return CallbackOperator(m=m, n=n, _matvec=a[0], _rmatvec=a[1])
    arr = as_tensor(a, device=device)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {tuple(arr.shape)}")
    return DenseOperator(a=arr)
