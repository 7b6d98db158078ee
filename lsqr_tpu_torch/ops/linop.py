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

from ..config import as_dtype

__all__ = ["LinearOperator", "DenseOperator", "CallbackOperator", "as_operator",
           "as_tensor"]


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """Tensor from a tensor, numpy array or nested list. Python floats
    become float64 (numpy's rule), so the dtype follows the input values."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, copy=True))
    return a.to(device=device, dtype=as_dtype(dtype))


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


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense A; the products are ``torch.matmul``."""

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
        return self.a @ x

    def rmatvec(self, y):
        return self.a.mH @ y

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


def as_operator(a, m: Optional[int] = None, n: Optional[int] = None) -> LinearOperator:
    """Coerce an operator, a dense 2-D array or tensor, or a
    (matvec, rmatvec) pair with explicit m, n to a LinearOperator."""
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
    arr = as_tensor(a)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {tuple(arr.shape)}")
    return DenseOperator(a=arr)
