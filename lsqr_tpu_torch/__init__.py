"""lsqr_tpu_torch — the PyTorch and CUDA port of ``lsqr_tpu``.

The JAX package ``lsqr_tpu`` stays beside this one as the reference: the
same inputs give the same ``istop``/``itn`` and, to tolerance, the same
``x`` and estimates. Ported so far: the LSQR core, the COO, dense, callback
and both DIA operators (shared-stripe and packed, with bf16 stripe
storage), ``auto_operator`` for banded patterns, ``from_scipy``,
``acheck``/``xcheck``, the Paige–Saunders and synthetic problems,
``LSQRSolver``, the sibling solvers ``lsmr``, ``craig`` and ``cgls``, the
three iteration megakernels (``megakernel=True``), and the general-sparsity
path: JDIA, ELL, HYB, BlockELL, ``csr_operator``, ``auto_operator``'s steps
2, 4 and 5 and the reordering planner (``plan_general``,
``solve_general``). The DIA products on CUDA run through seven kernels
written by hand for Hopper (``csrc/dia_shared.cu``, ``csrc/dia_packed.cu``),
the megakernels through three persistent cooperative kernels
(``csrc/megakernel.cu``), the JDIA and BlockELL products through four more
(``csrc/jdia.cu``, ``csrc/block_ell.cu``), all built with ``nvcc`` at first
use. The host packer (``native/sparse_pack.cpp``) builds with ``g++``.

Builders put what they build on the card unless given ``device=`` (see
:func:`~lsqr_tpu_torch.config.resolve_device`).

Importing this package imports ``torch`` and never ``jax``.
"""

from .api import LSQRSolver
from .cgls import CGLS_ISTOP_MESSAGES, CGLSResult, cgls
from .config import LSQROptions, default_dtype, eps_for, resolve_device
from .craig import CRAIG_ISTOP_MESSAGES, CRAIGResult, craig
from .diagnostics import ACheckResult, XCheckResult, acheck, xcheck
from .lsmr import LSMR_ISTOP_MESSAGES, LSMRResult, lsmr
from .models.paige_saunders import PaigeSaundersOperator, lstp, suite_configs
from .models.synthetic import (banded_dia, banded_problem, block_banded_coo,
                               jittered_band_coo, random_block_coo, random_coo_problem,
                               zipf_coo)
from .ops.compose import SumOperator, add_operators
from .ops.convert import operator_from_arrays, result_to_numpy
from .ops.coo import COOOperator, coo_operator
from .ops.interop import auto_operator, csr_operator, from_scipy
from .ops.jdia import JDIAOperator, jdia_operator
from .ops.linop import CallbackOperator, DenseOperator, LinearOperator, as_operator
from .ops.megakernel import lsqr_megakernel, megakernel_supported
from .ops.megakernel_craig import craig_megakernel, craig_megakernel_supported
from .ops.megakernel_lsmr import lsmr_megakernel, lsmr_megakernel_supported
from .ops.reorder import GeneralPlan, bandwidth_orders, plan_general, solve_general
from .ops.structured import (BlockELLOperator, DIAOperator, DIASharedOperator,
                             ELLOperator, block_ell_operator, dia_operator,
                             dia_operator_device, dia_shared_operator, ell_operator,
                             hyb_operator)
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
    "JDIAOperator",
    "jdia_operator",
    "ELLOperator",
    "ell_operator",
    "hyb_operator",
    "BlockELLOperator",
    "block_ell_operator",
    "SumOperator",
    "add_operators",
    "auto_operator",
    "from_scipy",
    "csr_operator",
    "bandwidth_orders",
    "GeneralPlan",
    "plan_general",
    "solve_general",
    "PaigeSaundersOperator",
    "lstp",
    "suite_configs",
    "banded_dia",
    "banded_problem",
    "random_coo_problem",
    "block_banded_coo",
    "jittered_band_coo",
    "random_block_coo",
    "zipf_coo",
    "operator_from_arrays",
    "result_to_numpy",
    "default_dtype",
    "eps_for",
    "resolve_device",
]
