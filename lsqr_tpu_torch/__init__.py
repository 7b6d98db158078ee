"""lsqr_tpu_torch — the PyTorch and CUDA port of ``lsqr_tpu``.

The JAX package ``lsqr_tpu`` stays beside this one as the reference: the
same inputs give the same ``istop``/``itn`` and, to tolerance, the same
``x`` and estimates. Ported so far: the LSQR core, the COO, dense, callback
and both DIA operators (shared-stripe and packed, with bf16 stripe
storage), ``auto_operator`` for banded patterns, ``from_scipy``,
``acheck``/``xcheck``, the Paige–Saunders and synthetic problems,
``LSQRSolver``, the sibling solvers ``lsmr``, ``craig`` and ``cgls``, and
the three iteration megakernels (``megakernel=True``). The DIA products on
CUDA run through seven kernels written by hand for Hopper
(``csrc/dia_shared.cu``, ``csrc/dia_packed.cu``) and the megakernels
through three persistent cooperative kernels (``csrc/megakernel.cu``), all
built with ``nvcc`` at first use.

Importing this package imports ``torch`` and never ``jax``.
"""

from .api import LSQRSolver
from .cgls import CGLS_ISTOP_MESSAGES, CGLSResult, cgls
from .config import LSQROptions, default_dtype, eps_for
from .craig import CRAIG_ISTOP_MESSAGES, CRAIGResult, craig
from .diagnostics import ACheckResult, XCheckResult, acheck, xcheck
from .lsmr import LSMR_ISTOP_MESSAGES, LSMRResult, lsmr
from .models.paige_saunders import PaigeSaundersOperator, lstp, suite_configs
from .models.synthetic import (banded_dia, banded_problem, block_banded_coo,
                               random_coo_problem)
from .ops.convert import operator_from_arrays, result_to_numpy
from .ops.coo import COOOperator, coo_operator
from .ops.interop import auto_operator, from_scipy
from .ops.linop import CallbackOperator, DenseOperator, LinearOperator, as_operator
from .ops.megakernel import lsqr_megakernel, megakernel_supported
from .ops.megakernel_craig import craig_megakernel, craig_megakernel_supported
from .ops.megakernel_lsmr import lsmr_megakernel, lsmr_megakernel_supported
from .ops.structured import (DIAOperator, DIASharedOperator, dia_operator,
                             dia_operator_device, dia_shared_operator)
from .solver import ISTOP_MESSAGES, TRACE_COLUMNS, LSQRResult, lsqr

__version__ = "0.1.0"

__all__ = [
    "LSQRSolver",
    "LSQROptions",
    "LSQRResult",
    "ISTOP_MESSAGES",
    "TRACE_COLUMNS",
    "lsqr",
    "lsmr",
    "LSMRResult",
    "LSMR_ISTOP_MESSAGES",
    "craig",
    "CRAIGResult",
    "CRAIG_ISTOP_MESSAGES",
    "cgls",
    "CGLSResult",
    "CGLS_ISTOP_MESSAGES",
    "lsqr_megakernel",
    "megakernel_supported",
    "lsmr_megakernel",
    "lsmr_megakernel_supported",
    "craig_megakernel",
    "craig_megakernel_supported",
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
    "DIAOperator",
    "dia_operator",
    "dia_operator_device",
    "DIASharedOperator",
    "dia_shared_operator",
    "auto_operator",
    "from_scipy",
    "PaigeSaundersOperator",
    "lstp",
    "suite_configs",
    "banded_dia",
    "banded_problem",
    "random_coo_problem",
    "block_banded_coo",
    "operator_from_arrays",
    "result_to_numpy",
    "default_dtype",
    "eps_for",
]
