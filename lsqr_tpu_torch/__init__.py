"""lsqr_tpu_torch — the PyTorch and CUDA port of ``lsqr_tpu``.

The JAX package ``lsqr_tpu`` stays beside this one as the reference: the
same inputs give the same ``istop``/``itn`` and, to tolerance, the same
``x`` and estimates. Ported so far: the LSQR core, the COO, dense, callback
and both DIA operators (shared-stripe and packed, with bf16 stripe
storage), ``auto_operator`` for banded patterns, ``from_scipy``,
``acheck``/``xcheck``, the Paige–Saunders and synthetic problems,
``LSQRSolver``, the sibling solvers ``lsmr``, ``craig`` and ``cgls``, the
three iteration megakernels (``megakernel=True``), the general-sparsity
path: JDIA, ELL, HYB, BlockELL, WCOO, WWCOO, RWCOO, ``csr_operator``, all
five steps of ``auto_operator`` and the reordering planner
(``plan_general``, ``solve_general``), and complex problems: the four
solvers, ``acheck``/``xcheck``, COO, the plane-split ZDIA and ZJDIA
operators and ``auto_operator``'s complex branch; the operator algebra
(stacks, scalings, diagonals, ``tikhonov``), right preconditioning and
column scaling, the host and Matrix Market I/O (``host_coo``, ``to_scipy``,
``from_matrix_market``, ``from_torch_sparse``, ``lsqr_scipy``,
``lsmr_scipy``), the reports, ``debug_log``, checkpointed solves,
profiling, LSRN (``lsrn``), mixed-precision refinement (``lsqr_refined``)
and hybrid regularization (``hybrid_lsqr``); many right-hand sides
(``lsqr_batch``, ``lsmr_batch``, ``cgls_batch``), multi-damp sweeps
(``lsqr_multidamp``, ``lsmr_multidamp``), regularization paths
(``reg_sweep``, ``discrepancy_damp``, ``lcurve_corner``, ``gcv_damp``) and
gradients through the solver (``lsqr_grad``, ``normal_cg``). The DIA products on CUDA
run through nine kernels written by hand for Hopper (``csrc/dia_shared.cu``,
``csrc/dia_packed.cu``), the complex DIA pair through one more
(``csrc/zdia.cu``), the megakernels through three persistent cooperative
kernels (``csrc/megakernel.cu``), the JDIA and BlockELL products through
four more (``csrc/jdia.cu``, ``csrc/block_ell.cu``), and the WCOO and WWCOO
products through three wrappers each (``csrc/wcoo.cu``, ``csrc/wwcoo.cu``),
and the streaming-ceiling probe ``stream_ceiling`` through ``stream_copy``
(``csrc/stream_copy.cu``), all built with ``nvcc`` at first use. The host packer
(``native/sparse_pack.cpp``) builds with ``g++``.

Builders put what they build on the card unless given ``device=`` (see
:func:`~lsqr_tpu_torch.config.resolve_device`).

Importing this package imports ``torch`` and never ``jax``.
"""

from .api import LSQRSolver
from .batch import cgls_batch, lsmr_batch, lsqr_batch
from .cgls import CGLS_ISTOP_MESSAGES, CGLSResult, cgls
from .config import LSQROptions, default_dtype, eps_for, real_dtype, resolve_device
from .craig import CRAIG_ISTOP_MESSAGES, CRAIGResult, craig
from .diagnostics import ACheckResult, XCheckResult, acheck, xcheck
from .lsmr import LSMR_ISTOP_MESSAGES, LSMRResult, lsmr
from .multidamp import lsmr_multidamp, lsqr_multidamp
from .models.paige_saunders import PaigeSaundersOperator, lstp, suite_configs
from .models.synthetic import (banded_dia, banded_problem, block_banded_coo,
                               jittered_band_coo, random_block_coo, random_coo_problem,
                               zdia_stripes, zipf_column_coo, zipf_coo)
from .implicit import lsqr_grad, normal_cg
from .hybrid import (GKBasis, HybridResult, gcv_lambda, golub_kahan, hybrid_lsqr,
                     projected_tikhonov)
from .ops.compose import (DiagonalOperator, HStackOperator, ScaledOperator, SumOperator,
                          VStackOperator, add_operators, diagonal_operator,
                          hstack_operators, scale_operator, tikhonov, vstack_operators)
from .ops.convert import operator_from_arrays, result_to_numpy
from .ops.coo import COOOperator, coo_operator
from .ops.host import host_coo, host_products, to_scipy
from .ops.interop import (auto_operator, csr_operator, from_bcoo, from_matrix_market,
                          from_scipy, from_torch_sparse, lsmr_scipy, lsqr_scipy)
from .ops.jdia import JDIAOperator, jdia_operator
from .ops.linop import CallbackOperator, DenseOperator, LinearOperator, as_operator
from .ops.megakernel import lsqr_megakernel, megakernel_supported
from .ops.megakernel_craig import craig_megakernel, craig_megakernel_supported
from .ops.megakernel_lsmr import lsmr_megakernel, lsmr_megakernel_supported
from .ops.roofline import stream_ceiling, stream_copy
from .ops.precondition import (ColumnScaledOperator, ComposedOperator, column_norms,
                               column_scaled, right_preconditioned)
from .ops.reorder import GeneralPlan, bandwidth_orders, plan_general, solve_general
from .ops.rwcoo import RWCOOOperator, rwcoo_operator
from .ops.structured import (BlockELLOperator, DIAOperator, DIASharedOperator,
                             ELLOperator, block_ell_operator, dia_operator,
                             dia_operator_device, dia_shared_operator, ell_operator,
                             hyb_operator)
from .ops.wcoo import WCOOOperator, wcoo_operator
from .ops.wwcoo import WWCOOOperator, wwcoo_operator
from .ops.zdia import (ZDIAOperator, ZJDIAOperator, zdia_operator, zdia_operator_device,
                       zjdia_operator)
from .randomized import LSRNResult, lsrn, lsrn_preconditioner, sketch_left, sketch_right
from .refine import RefineResult, lsqr_refined
from .regpath import RegPath, discrepancy_damp, gcv_damp, lcurve_corner, reg_sweep
from .solver import ISTOP_MESSAGES, TRACE_COLUMNS, LSQRResult, lsqr
from .utils.checkpoint import load_state, lsqr_checkpointed, save_state
from .utils.printing import format_exit_block, format_iteration_log, format_report

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
    "WCOOOperator",
    "wcoo_operator",
    "WWCOOOperator",
    "wwcoo_operator",
    "RWCOOOperator",
    "rwcoo_operator",
    "ZDIAOperator",
    "zdia_operator",
    "zdia_operator_device",
    "ZJDIAOperator",
    "zjdia_operator",
    "SumOperator",
    "add_operators",
    "auto_operator",
    "from_scipy",
    "from_matrix_market",
    "from_bcoo",
    "from_torch_sparse",
    "lsqr_scipy",
    "lsmr_scipy",
    "csr_operator",
    "GKBasis",
    "HybridResult",
    "golub_kahan",
    "hybrid_lsqr",
    "projected_tikhonov",
    "gcv_lambda",
    "LSRNResult",
    "lsrn",
    "lsrn_preconditioner",
    "sketch_left",
    "sketch_right",
    "RefineResult",
    "lsqr_refined",
    "lsqr_batch",
    "lsmr_batch",
    "cgls_batch",
    "lsqr_multidamp",
    "lsmr_multidamp",
    "RegPath",
    "reg_sweep",
    "discrepancy_damp",
    "lcurve_corner",
    "gcv_damp",
    "lsqr_grad",
    "normal_cg",
    "host_coo",
    "host_products",
    "to_scipy",
    "ComposedOperator",
    "ColumnScaledOperator",
    "column_norms",
    "column_scaled",
    "right_preconditioned",
    "lsqr_checkpointed",
    "save_state",
    "load_state",
    "format_report",
    "format_exit_block",
    "format_iteration_log",
    "bandwidth_orders",
    "GeneralPlan",
    "plan_general",
    "solve_general",
    "stream_ceiling",
    "stream_copy",
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
    "zipf_column_coo",
    "zdia_stripes",
    "operator_from_arrays",
    "result_to_numpy",
    "default_dtype",
    "eps_for",
    "real_dtype",
    "resolve_device",
]
