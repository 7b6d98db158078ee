"""Carry state across from the JAX package without repacking.

``operator_from_arrays`` turns the arrays of a JAX operator (as numpy
arrays) into this package's operator on a device; ``result_to_numpy`` turns
a result of either package into numpy arrays. Together they let both
packages compute on the same stored operator and compare what comes out.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .coo import coo_operator
from .linop import LinearOperator
from .structured import DIASharedOperator

__all__ = ["operator_from_arrays", "result_to_numpy"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def operator_from_arrays(kind: str, arrays: Mapping[str, np.ndarray],
                         meta: Mapping, device=None) -> LinearOperator:
    """Build this package's operator from a JAX operator's arrays.

    kind "dia_shared": arrays {"dp"}, meta {"m", "n", "offsets", "H"}, i.e.
        ``np.asarray(op.dp)`` and the static fields of a JAX
        ``DIASharedOperator``; dp is used as it is.
    kind "coo": arrays {"vals", "rows", "cols"}, meta {"m", "n"}.
    """
    if kind == "dia_shared":
        return DIASharedOperator(
            dp=_tensor(arrays["dp"], device), m=int(meta["m"]), n=int(meta["n"]),
            offsets=tuple(int(k) for k in meta["offsets"]), H=int(meta["H"]),
        )
    if kind == "coo":
        return coo_operator(meta["m"], meta["n"], _tensor(arrays["vals"], device),
                            arrays["rows"], arrays["cols"])
    raise ValueError(f"unknown operator kind {kind!r} (dia_shared, coo)")


def result_to_numpy(res) -> dict:
    """{field: numpy array or None} for an LSQRResult of either package."""
    out = {}
    for name, value in res._asdict().items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        elif value is not None:
            value = np.asarray(value)
        out[name] = value
    return out
