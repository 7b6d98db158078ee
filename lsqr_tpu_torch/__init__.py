"""lsqr_tpu_torch — the PyTorch and CUDA port of ``lsqr_tpu``.

The JAX package ``lsqr_tpu`` stays beside this one as the reference: the
same inputs give the same ``istop``/``itn`` and, to tolerance, the same
``x`` and estimates. This slice ports the banded main path: the LSQR core,
the COO, dense, callback and shared-stripe DIA operators, ``auto_operator``
for banded patterns, ``acheck``/``xcheck``, the Paige–Saunders problems and
``LSQRSolver``. The products of the shared-stripe DIA operator on CUDA run
through three kernels written by hand for Hopper (``csrc/dia_shared.cu``),
built with ``nvcc`` at first use.

Importing this package imports ``torch`` and never ``jax``.
"""

from .api import LSQRSolver
from .config import LSQROptions, default_dtype, eps_for
from .diagnostics import ACheckResult, XCheckResult, acheck, xcheck
from .models.paige_saunders import PaigeSaundersOperator, lstp, suite_configs
from .ops.convert import operator_from_arrays, result_to_numpy
from .ops.coo import COOOperator, coo_operator
from .ops.interop import auto_operator
from .ops.linop import CallbackOperator, DenseOperator, LinearOperator, as_operator
from .ops.structured import DIASharedOperator, dia_shared_operator
from .solver import ISTOP_MESSAGES, TRACE_COLUMNS, LSQRResult, lsqr

__version__ = "0.1.0"

__all__ = [
    "LSQRSolver",
    "LSQROptions",
    "LSQRResult",
    "ISTOP_MESSAGES",
    "TRACE_COLUMNS",
    "lsqr",
    "acheck",
    "xcheck",
    "ACheckResult",
    "XCheckResult",
    "LinearOperator",
    "DenseOperator",
    "CallbackOperator",
    "COOOperator",
    "coo_operator",
    "as_operator",
    "DIASharedOperator",
    "dia_shared_operator",
    "auto_operator",
    "PaigeSaundersOperator",
    "lstp",
    "suite_configs",
    "operator_from_arrays",
    "result_to_numpy",
    "default_dtype",
    "eps_for",
]
