#!/usr/bin/env python3
"""Drive lsqr_tpu_torch's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA device (it exits non-zero, printing no result, without one),
nvcc under $CUDA_HOME or /usr/local/cuda, and scipy. It builds the kernels
from lsqr_tpu_torch/csrc into build/lsqr_tpu_torch/ (and the host packer
from lsqr_tpu_torch/native with g++), then runs twenty-two phases; each
raises on failure:

1. each hand-written kernel against its plain PyTorch twin on the card, at
   the main path's shape (m = n = 2^23, 11 diagonals: f32, and bf16
   stripes), a ragged rectangular one (f32, and the f64 products), a wide
   one, and a band wider than the pair kernels' halo (2^20, offsets
   +-1500: the two-launch route); the kernels' and the twins' times; the
   shared pair's staged route (checked to be the one taken at the main
   shape) and its unstaged kernel, the same bits at every shape whose halo
   one launch takes, both also timed at 2^19; the half-step timed in both
   directions at the main shape (the adjoint's row ``[adjoint]`` beside the
   kernels line's forward one); every call of the two products (shared
   forward and ``[adjoint]``, packed data forward, ``[t]`` on tdata and
   ``[column]``, data's column side) at every shape, f32 and bf16 stripes,
   bit-equal to the direct kernel (one thread an output), the main shape's
   through the staged route, and each timed there beside its bound and,
   f32, the CSR product (of A' for the adjoint calls); the two variants of
   the fused half-step (v2, v3) on data and tdata at every shape, f32 and
   bf16 stripes, out bit-equal to their direct kernel and ssq within TOL of
   it, the main shape's through the staged route, timed there on both
   routes (the kernels line's ``direct_ms``);
2. the main-path solve at m = n = 2^23 on the shared-stripe layout: f32
   stripes from a seeded generator with 12 added to the main diagonal, damp
   0.01 — a run to the machine-precision guards within 64 iterations, a
   fixed 64-iteration run for the time per iteration, and a run to
   atol = btol = 1e-6 whose answer is checked independently with the twins
   in f64;
3. the same solve with pair=False (the product+axpy kernel);
4. ``auto_operator`` on the COO triplets of a 2^20 banded f32 matrix and a
   short solve, against the same solve on the host; solves at 2^20 on 81
   diagonals (f32 and bf16 stripes), whose shared pair takes the unstaged
   route, the ring kernel (no staged tile fits), checked in f64 and against
   the same solves with the pair as two launches (the same istop and itn),
   after that pair at those stripes against its twin and the ring kernel
   called directly (the same bits over two calls), timed beside its bound
   and, f32, the two CSR calls (the kernel's row in the last lines), and
   the half-step there (staged tiles) against its twin in both directions,
   the same bits over two calls and from the direct kernel, timed beside
   its bound;
5. f64 conformance at 2^16 against ``scipy.sparse.linalg.lsqr``, on the
   shared layout and through ``auto_operator`` (the packed layout), and the
   README 3x3 system through ``LSQRSolver(device="cuda")``;
6. the CUDA kernel launches one iteration of the f32 shared pair solve
   makes;
7. the phase-2 solve on the packed layout (``dia_operator_device``, same
   stripes): fixed 64 iterations, the run to 1e-6 checked in f64 and against
   phase 2's x, pair=False (the fused half-step) and fused=False (the
   product), its launches per iteration, and a band wider than the pair
   kernel's halo at 2^20;
8. bf16 stripe storage at 2^23 on both layouts: solves to 1e-6 checked in
   f64 against the bf16-rounded operator and against the f32 x, the fixed
   64-iteration time, forced half-steps (the product+axpy kernels), and the
   launches per iteration of each pair solve;
9. the three iteration megakernels (LSQR in f32 and bf16, LSMR, CRAIG)
   against their plain twins on the card: one call of K = 8 iterations
   from the same setup on the phase-7 operator (2^23, packed), and on a
   one-sided band and a ragged rectangular shape at 2^20, and offsets of
   +-m/2 at 2^16; each call's route (the staged phases at the main shape,
   the direct ones at +-m/2; at one grid both agree within MK_TOL, held at
   the ragged shape); the kernels' and the twins' times per call;
10. solves through the megakernels: ``lsqr``, ``lsmr`` and ``craig`` with
   ``megakernel=True`` against the regular (pair) path on the card, in f32
   and bf16, the LSQR answer checked in f64; fixed 64-iteration LSQR runs
   with and without the megakernel at 2^23 and 2^19 (ms and CUDA launches
   per iteration; the megakernel's own launches, by name, one per K
   iterations); ``cgls`` (regular, and ``pair=True``) checked in f64.

11. the general-sparsity kernels against their twins on the card:
   ``jdia_matvec`` on a jittered-diagonal pattern at m = n = 2^22 (6
   entries per row around five diagonals, 12 added on the main diagonal,
   packed through ``auto_operator``) and at 1,000,003 x 700,001; the three
   BlockELL kernels at m = n = 2^18 (128 x 128 blocks, 3 per block row), at
   100,003 x 70,001 and at a tall 76,763 x 1,485 whose transpose packing
   (kt > 96 blocks per block column) overflows the windowed kernel's
   window (the products split its 12 long block rows across CTAs); each
   product and the pair called twice must give the same bits; kernel, twin
   and ``torch.sparse_csr_tensor`` times (A @ x, or the CSR of A' for a
   transpose packing; beside the pair, CSR A @ x plus the CSR of A' @ u),
   the bytes each must move, at every packing the
   solves take: the products' own rows at the 2^18 forward packing, and
   ``block_ell_matvec_windowed[kt10]`` (the 2^18 transpose),
   ``block_ell_matvec_windowed[tall]`` and ``block_ell_matvec[tall_t]``
   (the tall forward and transpose), each with its own error against the
   twin, and whose launches are those its packing took in phase 12's
   counted solves (counted around the operator's matvec and rmatvec);
12. solves on those operators: JDIA (damped, to 1e-6, checked in f64;
   fixed 64 iterations with the launches per iteration), BlockELL at 2^18
   with the windowed products and with ``pair=True``, the tall BlockELL
   pattern (its adjoint through ``block_ell_matvec``, the operator's route
   for a packing that overflows the window), and an f64 JDIA solve at 2^16
   against ``scipy.sparse.linalg.lsqr``;
13. the routes: ``plan_general`` reorders a scrambled 2^18 JDIA pattern back
   to JDIA and its solve matches the unscrambled one; a Zipf power-law
   pattern at 2^19 goes to HYB and solves; a tall unstructured f32 pattern
   at 2^16 x 2^12 goes to HYB at 8 entries per row (the WCOO packer's
   refusal, as in JAX) and to WCOO at 4, and solves;
14. the WCOO and WWCOO kernels (forward, adjoint, pair) against their twins
   at the JAX package's benchmark shapes (``bench.py``'s Zipf(1.1)
   pattern, m = 2^21, 10,485,760 entries: WCOO at n = 2048, RWCOO at
   n = 65,536, built by ``auto_operator``) and at ragged shapes with
   duplicates and empty rows; kernel, twin and ``torch.sparse_csr_tensor``
   times (A and A'), the bytes each must move, the routed RWCOO pair; a
   WWCOO packing whose 98,304 column positions a chunk exceed one block's
   shared memory (a band at 2^15 x 262,144: the adjoint's windows); every
   adjoint and pair (WCOO, RWCOO's hot panel and cold stream, WWCOO) called
   twice on the same inputs must give the same bits;
15. solves on the two benchmark operators: damped (DAMP) to 1e-6 through
   the pair kernels, checked in f64 and against the COO operator's solve
   (the damped objective, within a limit that solves on planted faults
   exceed; x over the first 2 iterations), fixed 64
   iterations with the launches, kernel time and device idle share per
   iteration, and 64 with ``pair=False`` (the separate products); each
   operator's products against the f64 triplets at three vectors, a check
   that sees bf16-rounded values; a second solve of each must stop at the
   same itn with bit-equal x (no kernel of either path adds with atomics);
16. the complex pair ``zdia_pair`` against its twin at the JAX package's
   complex benchmark shape (``bench.py``'s zdia stage: m = n = 2^21, 5
   diagonals, N(0, 1) planes), a ragged rectangular shape (the staged
   kernel, the same bits over two calls) and a +-1500 band at 2^20 (two
   launches); the ZDIA products against the complex128 COO
   triplets; ``torch.sparse_csr_tensor`` A @ x plus the CSR of A^H @ u;
17. complex solves: the benchmark's triplets (+12 on the diagonal) through
   ``auto_operator`` (ZDIA), damped (DAMP) to 1e-6 through ``zdia_pair``,
   checked in complex128 and against ``scipy.sparse.linalg.lsqr``; fixed
   64 iterations with the launches and the device's idle share; ``lsmr``,
   ``cgls`` (pair=True) and ``craig`` against their pair=False runs;
   complex128 at 2^16 against scipy; a ZJDIA solve at 2^20;
18. the streaming ceiling: ``stream_copy`` against its twin and ``x.mul_``
   bit for bit at the ceiling's shape and at a ragged length;
   ``stream_ceiling`` at ``bench.py``'s roofline shape (1024 x 2^18 f32,
   1 GiB, 20 chained in-place copies after a warm-up) in GB/s beside the
   data sheet's 3.35 TB/s; kernel, twin and ``x.mul_`` times at that shape,
   the kernel and ``x.mul_`` in five turns;
19. the operator algebra, preconditioning, I/O and solver utilities, LSRN,
   refinement and hybrid regularization on phase 2's operator (2^23, 11
   diagonals, shared f32 stripes): ``lsqr``, ``lsmr`` and ``cgls`` warm
   started with damp 0.01 from an 8-iteration x (the stacked [A; damp I],
   two products an iteration), within 1e-3 of the cold solve and at
   optimality 1e-4; ``column_scaled`` (equal to ``right_preconditioned``
   by a diagonal) solving the damped problem in x; ``tikhonov`` with a
   first-difference L; ``lsqr_refined`` with the host f64 CSR at damp 0.01
   and 0 (f64 ratio <= 1e-10 and 100 times below the plain f32 solve's);
   ``lsqr_checkpointed`` in segments of 16 through a state file, bit-equal
   to the uninterrupted solve; ``debug_log`` at 2^20 printing the rows of
   the throttle rule; ``lsrn`` on phase 15's WCOO Zipf operator, its damped
   objective within 3e-8 of the COO solve's; ``hybrid_lsqr`` (k = 32,
   reorthogonalized) against ``lsqr`` at its GCV lambda; a 2^20 x 11 f64
   band through ``scipy.io.mmwrite`` and ``from_matrix_market`` (the packed
   DIA operator) and ``lsqr_scipy`` against ``scipy.sparse.linalg.lsqr``;
   ``product_rate``;
20. the solves over rows on phase 2's operator: ``lsqr_multidamp`` over 8
   damps (0 to 1.0; one pair launch an iteration for all of them) and
   ``lsmr_multidamp`` over 4, each damp's istop, itn and x bit for bit its
   standalone pair solve, with the sweep's launch profile (as phase 6);
   ``lsqr_batch`` of 4 right-hand sides with their own damps, column for
   column against ``lsqr``; at 2^20 the sweep on the plain products,
   ``lsqr_batch`` with pair=False (the half-step), ``lsmr_batch`` and
   ``cgls_batch`` against their standalone solves, ``reg_sweep`` with the
   computed residual (against f64 products), ``discrepancy_damp``,
   ``lcurve_corner`` and ``gcv_damp``, and ``lsqr_grad`` on an f64 band
   (directional derivatives in b and in one stripe against central
   differences);
21. the sharded solvers (``lsqr_tpu_torch.parallel``): (a) one rank on
   NCCL, ``lsqr_sharded_dia`` on phase 2's band (2^23, 11 diagonals, pair
   mode) for a fixed 64 iterations against the unsharded solve; (b) four
   ranks on gloo, spawned processes that share this card:
   ``lsqr_sharded_dia`` on the same band, ``lsqr_sharded_wcoo`` on phase
   14's Zipf pattern (2^21 x 2048) to 1e-6, ``lsqr_sharded_2d`` on a (2, 2)
   mesh (the band's triplets at 2^20) and ``lsqr_sharded_zdia`` on phase
   16's complex band (2^21, 5 diagonals), each against its unsharded solve
   on the card (the WCOO one by its damped objective), all ranks' x bit for
   bit equal, ``wcoo_pair`` launched on every rank; wall ms and collectives
   an iteration. Gloo stages each all-reduce through the host, so (b)'s
   times say nothing of NCCL across cards;
22. gradients to the operators' stored values (``lsqr_grad``) at full
   width: phase 11's JDIA (2^22) and BlockELL (2^18, the forward through
   the pair) operators, phase 13's HYB (Zipf(2), 2^19), phase 14's WCOO
   (2^21 x 2048) and RWCOO (2^21 x 65,536) operators and the damped warm
   start's [A; damp I] over a band of phase 2's shape (2^23, 11 diagonals):
   damped at GRAD_DAMP times the largest singular value, the forward solve
   cut at GRAD_ITNLIM iterations and the backward's conjugate gradients
   left to stop on their own, the loss <x, w>; the directional derivative
   in the direction v * w(i, j) of the triplet values (w a hash of the
   coordinates, so each stored value's direction is itself times the weight
   of its position) through the layout's leaves, against the same through
   the COO operator of the same triplets on the card, within GRAD_BAND,
   which the same reading with the adjoint share dropped must exceed; the
   forward's istop and itn, CG's iterations, forward and backward ms, and
   the kernels the backward launched (each layout's product kernels).

Every solve of phases 2-5, 7, 8, 10, 12, 13, 15, 17 and 19-22 runs with the launch
counts reset just before it and read just after, and so does a direct call
of the kernels no solver calls (the two variants of the fused half-step,
phase 1) and the ceiling's chain (phase 18); each path must launch the
kernels it runs, and every kernel variant must have launched on some path.
The second-to-last line of output is a JSON object describing each kernel
(its time, its twin's, the least time the card could take for the bytes or
operations it must handle, and a PyTorch library call's time where one
computes the same function; the fused half-step's two variants also their
direct kernel's, ``direct_ms``), and the BlockELL packings timed apart; the
last line is {"ok": true, "device": {...}}.
"""

import inspect
import json
import os
import subprocess
import sys
import time

M_MAIN = 2 ** 23
OFFSETS = tuple(range(-5, 6))
WIDE = (2 ** 20, 2 ** 20, (-1500, 0, 1500))
DAMP = 0.01
TOL = 1e-5  # f32 kernel vs twin, relative to the max: summation order only
BF16_TOL = 1e-2  # bf16 results (the packed axpy's): one bf16 ulp is 2^-8
SHARED = "lsqr_tpu_torch/csrc/dia_shared.cu"
PACKED = "lsqr_tpu_torch/csrc/dia_packed.cu"
MEGA = "lsqr_tpu_torch/csrc/megakernel.cu"
JDIA = "lsqr_tpu_torch/csrc/jdia.cu"
BELL = "lsqr_tpu_torch/csrc/block_ell.cu"
WCOO = "lsqr_tpu_torch/csrc/wcoo.cu"
WWCOO = "lsqr_tpu_torch/csrc/wwcoo.cu"
ZDIA = "lsqr_tpu_torch/csrc/zdia.cu"
STREAM = "lsqr_tpu_torch/csrc/stream_copy.cu"
#: the staged pair of both layouts (csrc/dia_packed.cu and csrc/dia_shared.cu
#: include it): the source of the pairs' staged variants
STAGED_PAIR = "lsqr_tpu_torch/csrc/dia_pair_staged.cuh"
#: the staged product of both layouts (included likewise): the source of the
#: products' f32 and bf16 variants (f64 takes the direct kernel) and of the
#: fused half-step's two variants (its kernel with y)
STAGED_PRODUCT = "lsqr_tpu_torch/csrc/dia_product_staged.cuh"
M_JDIA = 2 ** 22  # phase 11-12's jittered-diagonal size
M_BELL = 2 ** 18  # phase 11-12's BlockELL size
M_PLAN = 2 ** 18  # phase 13's scrambled pattern
#: RCM's order (the reference's, scipy's) recovers a JDIA fit of 0.98 on this
#: seed's pattern; on others it can fall below 0.95 (PERF.md, Findings)
PLAN_SEED = 4
M_ZIPF = 2 ** 19  # phase 13's power-law pattern
JDIA_RAGGED = (1_000_003, 700_001)
BELL_RAGGED = (100_003, 70_001)
#: 600 block rows over 12 block columns: about 150 blocks per block column,
#: more than the 96 the windowed kernel's window holds
BELL_TALL = (76_763, 1_485)
#: the JAX package's WCOO and RWCOO benchmark shapes (bench.py:118-123): m rows,
#: the entries of bench.py:336-339 at n and at the wide n
ZIPF_M, ZIPF_N, ZIPF_WIDE_N, ZIPF_NNZ = 2 ** 21, 2048, 65536, 10 * 2 ** 20
WCOO_RAGGED = (100_003, 3_001)
RWCOO_RAGGED = (100_003, 12_345)
COO_TOL = 1e-4  # WCOO/WWCOO kernels vs twins: summation order
#: phase 15: the damped objective of each solve against the COO operator's
#: solve, relative; set between the largest sound reading (3.2e-9, 2.4e-6)
#: and the least reading of a planted fault that it must catch (one subtile
#: zeroed: 8.6e-8, 3.4e-5; PERF.md, Findings)
OBJ_TOL = {"wcoo": 3e-8, "rwcoo": 1.5e-5}
#: the planted faults each limit must catch (bf16 values are logged: the
#: solve checks do not see them)
CAUGHT = {"wcoo": ("chunk", "subtile"), "rwcoo": ("chunk", "subtile", "cold dropped")}
#: phase 14's WWCOO band (one chunk's 98,304 positions exceed one block's
#: shared memory): m, n, entries a row on as many of each row's 8 columns
WWCOO_BAND = (2 ** 15, 262_144, 6, 8)
#: the H100 SXM's device-memory rate and non-tensor-core peaks (NVIDIA's data
#: sheet), for the least time a kernel could take
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 2: 67e12, 8: 34e12}  # by stripe bytes: f32, bf16 (f32 math), f64
MK_K = 8  # iterations per megakernel call in phase 9
MK_SIDE = 2 ** 20  # phase 9's one-sided and ragged shapes
#: phase 9's band whose vector window fits no staged tile (offsets of
#: +-m/2): the megakernels' direct route
MK_FAR = (2 ** 16, (-2 ** 15, 0, 2 ** 15))
M_SMALL = 2 ** 19  # phase 10's second timing size, the JAX megakernel's size class
#: phase 4's band whose shared pair takes the unstaged kernel: m = n, 81
#: diagonals (no staged tile's two stages fit one SM in f32 or bf16), and
#: what is added on the main diagonal (the band's singular values stay
#: within about 40 +- 2 sqrt(81))
MANY = (2 ** 20, tuple(range(-40, 41)), 40.0)
MK_TOL = 1e-4  # megakernel vs twin after MK_K iterations, relative
STREAM_TURNS = 5  # phase 18: stream_copy and x.mul_ timed in turns
M_IO = 2 ** 20  # phase 19's debug_log and Matrix Market size
REFINE_M = 2 ** 23  # phase 19's refinement size: the main shape's host CSR
REFINE_ITNLIM = 200  # phase 19: the refinement's f32 solves stop at their guards before
CKPT_SEG = 16  # phase 19's checkpoint segments
HYBRID_K = 32  # phase 19's bidiagonalization steps
TIKHONOV_LAM = 0.1  # phase 19's lam for the first-difference L
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "dia_pair_shared": (SHARED, "lsqr_tpu/ops/pallas_spmv.py:1969"),
    "dia_product_shared": (SHARED, "lsqr_tpu/ops/pallas_spmv.py:1653"),
    "dia_product_shared_axpy": (SHARED, "lsqr_tpu/ops/pallas_spmv.py:2081"),
    "dia_pair": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:1418"),
    "dia_matvec": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:452"),
    "dia_matvec_axpy": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:690"),
    "dia_fused_halfstep": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:582"),
    "lsqr_megakernel": (MEGA, "lsqr_tpu/ops/megakernel.py:411"),
    "lsmr_megakernel": (MEGA, "lsqr_tpu/ops/megakernel_lsmr.py:332"),
    "craig_megakernel": (MEGA, "lsqr_tpu/ops/megakernel_craig.py:195"),
    "jdia_matvec": (JDIA, "lsqr_tpu/ops/pallas_spmv.py:885"),
    "block_ell_matvec": (BELL, "lsqr_tpu/ops/pallas_spmv.py:76"),
    "block_ell_matvec_windowed": (BELL, "lsqr_tpu/ops/pallas_spmv.py:196"),
    "block_ell_pair_windowed": (BELL, "lsqr_tpu/ops/pallas_spmv.py:323"),
    "wcoo_forward": (WCOO, "lsqr_tpu/ops/pallas_wcoo.py:388"),
    "wcoo_adjoint": (WCOO, "lsqr_tpu/ops/pallas_wcoo.py:396"),
    "wcoo_pair": (WCOO, "lsqr_tpu/ops/pallas_wcoo.py:404"),
    "wwcoo_forward": (WWCOO, "lsqr_tpu/ops/pallas_wwcoo.py:402"),
    "wwcoo_adjoint": (WWCOO, "lsqr_tpu/ops/pallas_wwcoo.py:410"),
    "wwcoo_pair": (WWCOO, "lsqr_tpu/ops/pallas_wwcoo.py:418"),
    "dia_fused_halfstep_v2": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:1124"),
    "dia_fused_halfstep_v3": (PACKED, "lsqr_tpu/ops/pallas_spmv.py:1070"),
    "zdia_pair": (ZDIA, "lsqr_tpu/ops/pallas_spmv.py:2363"),
    "stream_copy": (STREAM, "bench.py:211"),
}
#: the kernels no solver calls (neither in JAX): their path is the direct call
DIRECT = ("dia_fused_halfstep_v2", "dia_fused_halfstep_v3")
#: the kernels whose result has the stripes' dtype (2 bytes for bf16 stripes)
STRIPE_DTYPE_OUT = ("dia_matvec_axpy", "dia_fused_halfstep", "dia_fused_halfstep_v2",
                    "dia_fused_halfstep_v3")
#: phases 16-17: the JAX package's complex benchmark (bench.py:127-129,
#: :382-419): m = n = 2^21, 5 diagonals (-2..2), N(0, 1) real and imaginary
#: planes; 12 added on the diagonal for the solves
M_ZDIA = 2 ** 21
ZDIA_RAGGED = (300_001, 200_003, (-60, -3, 0, 5))
M_ZJDIA = 2 ** 20  # phase 17's complex jittered pattern (phase 11's, complex values)
#: phase 15: each card product of the Zipf operators against the f64
#: triplets, max |error| / max |product|: 5x above the largest f32 reading
#: (6.0e-6, the RWCOO adjoint's atomics), 80x below bf16-rounded values'
#: (2.4e-3; PERF.md, Findings)
PRODUCT_TOL = 3e-5
#: profiles of a megakernel solve pair made before phase_launches gives up on
#: a profiler that loses events
PROFILE_ATTEMPTS = 3
#: grid-wide barriers per iteration of each megakernel (csrc/megakernel.cu)
BARRIERS = {"lsqr": 3, "lsmr": 3, "craig": 2}
#: f32 vector passes of length m = n per iteration of each megakernel: the
#: fewest the algorithm needs under its grid-wide barriers (the phase bodies
#: of csrc/megakernel.cu), each vector a phase reads or writes counted once.
#: The adjoint follows the beta barrier and reads u and v and writes v (3).
#: The update needs only scalars known at the alpha barrier, so it shares
#: one phase, and its read of v, with the next iteration's forward (reads u
#: and v, writes u): LSQR's update adds x and w read and written (4 more,
#: 7 with the forward), LSMR's h, hbar and x (6 more, 9), CRAIG's x update
#: x read and written (2 more, 5; its own p0 runs the two without a
#: barrier). LSQR 10, LSMR 12, CRAIG 8
MK_PASSES = {"lsqr_megakernel": 10, "lsmr_megakernel": 12, "craig_megakernel": 8}
#: f32 vectors each call reads or writes, in units of (m, n) lengths
VECTORS = {"dia_product_shared": (1, 1), "dia_matvec": (1, 1),
           "dia_product_shared_axpy": (2, 1), "dia_matvec_axpy": (2, 1),
           "dia_fused_halfstep": (2, 1), "dia_fused_halfstep_v2": (2, 1),
           "dia_fused_halfstep_v3": (2, 1), "dia_pair_shared": (2, 2), "dia_pair": (2, 2)}


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def sh(*cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def wide(t):
    """t in f64, or in complex128 when it is complex."""
    import torch

    return t.to(torch.complex128) if t.is_complex() else t.double()


def rel(got, ref):
    got, ref = wide(got), wide(ref)
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def absdiff(got, ref):
    return float((wide(got) - wide(ref)).abs().max())


def time_ms(fn, reps=20):
    """Mean device time of one call (CUDA events around ``reps`` calls after
    a warm-up call). The card first spins (``torch.cuda._sleep``, counted in
    cycles of at most 2 GHz) for 1.5 times as long as the host took to
    queue one call, times ``reps``, plus 1 ms (at most 0.2 s), so the events
    see the calls' kernels back to back and not the host's Python between
    them; a call that waits for the card itself is timed as before."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host + 1e-3, 0.2) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, esize=4):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    device-memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[esize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def perf_entry(ms, plain_ms, nbytes, flops, esize=4, library_ms=None):
    return dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops, esize=esize,
                library_ms=library_ms)


def report(name, entry, card):
    ms, nbytes = entry["ms"], entry["bytes"]
    lib = entry["library_ms"]
    least = bound(nbytes, entry["flops"], entry["esize"])[0]
    log(f"  {name:30s} kernel {ms:.4f} ms ({nbytes / (ms * 1e6):.1f} GB/s of the "
        f"{nbytes / 1e6:.0f} MB it must move; bound {least:.4f} ms), "
        f"twin {entry['plain_ms']:.4f} ms, library "
        f"{'none' if lib is None else f'{lib:.4f} ms'}  [{card}]")


def csr_of(rows, cols, vals, m, n):
    """torch.sparse_csr_tensor of COO triplets (tensors on the card; no
    duplicates), sorted on the card."""
    import warnings

    import torch

    _, order = torch.sort(rows * n + cols)
    crow = torch.zeros(m + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[order], vals[order], size=(m, n),
                                       check_invariants=False)


def stripe_triplets(stripes, offsets, m, n):
    """(rows, cols, vals) on the card of the entries of row-aligned stripes
    (nd, m) inside the m x n matrix."""
    import torch

    i = torch.arange(m, device=stripes.device)
    cols = i[None, :] + torch.tensor(offsets, device=stripes.device)[:, None]
    ok = (cols >= 0) & (cols < n)
    return i[None, :].expand_as(cols)[ok], cols[ok], stripes[ok]


def stripes_csr(data, offsets, m, n):
    """The CSR of row-aligned stripes (nd, m): the same banded matrix."""
    return csr_of(*stripe_triplets(data, offsets, m, n), m, n)


def random_stripes(m, n, offsets, device, seed, boost=0.0, dtype=None):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randn((len(offsets), m), generator=g, device=device, dtype=dtype)
    data[offsets.index(0)] += boost
    return data, torch.randn(m, generator=g, device=device, dtype=dtype), g


def base(variant):
    return variant.split("[")[0]


def counted(fn):
    """(fn's result, kernel launches by variant while it ran): one path of
    the main program, with every count set to 0 just before it."""
    from lsqr_tpu_torch.ops import spmv

    spmv.reset_launch_counts()
    out = fn()
    return out, spmv.launch_counts(by_variant=True)


# ---------------------------------------------------------------------------


def dia_operators(data, m, n, ks, storage):
    """(shared, packed) operators of these stripes in ``storage``."""
    import lsqr_tpu_torch as lt

    return (lt.dia_shared_operator(m, n, ks, data, storage_dtype=storage),
            lt.dia_operator_device(m, n, ks, data, storage_dtype=storage))


def product_calls(As, Ap, v, y):
    """{variant: (wrapper, stripes, vector, keywords)} of every call of the
    two products (rows 5 and 2): the shared forward and ``[adjoint]``, the
    packed data forward, ``[t]`` (tdata forward, the operator's adjoint)
    and ``[column]`` (data's column side, the pair's wide-halo route); the
    kernels read the offsets from the operators' device copies."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    sfx = "" if As.dp.dtype == torch.float32 else "[bf16]"
    kw = dict(offsets=As.offsets, m=As.m, n=As.n)
    skw, pkw = dict(kw, offsets_t=As.offsets_t), dict(kw, offsets_t=Ap.offsets_t)
    return {
        f"dia_product_shared{sfx}": (spmv.dia_product_shared, As.dp, v,
                                     dict(skw, adjoint=False)),
        f"dia_product_shared{sfx}[adjoint]": (spmv.dia_product_shared, As.dp, y,
                                              dict(skw, adjoint=True)),
        f"dia_matvec{sfx}": (spmv.dia_matvec, Ap.data, v, dict(pkw, adjoint=False)),
        f"dia_matvec{sfx}[t]": (spmv.dia_matvec, Ap.tdata, y, dict(
            offsets=Ap.toffsets, m=Ap.n, n=Ap.m, offsets_t=Ap.toffsets_t, adjoint=False)),
        f"dia_matvec{sfx}[column]": (spmv.dia_matvec, Ap.data, y, dict(pkw, adjoint=True)),
    }


def halfsteps_match_direct(Ap, v, y, label):
    """The two variants of the fused half-step (v2, v3) on data and tdata,
    through the route the wrappers take, against their direct kernel
    (``tile=0``): out bit-equal, ssq within TOL. Returns (the tile,
    {variant: the direct route's call on data, for timing})."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    dev = Ap.data.device
    c1, c2 = torch.tensor(0.8, device=dev), torch.tensor(1.1, device=dev)
    sfx = "" if Ap.data.dtype == torch.float32 else "[bf16]"
    tile = spmv._halfstep_rule(Ap.data, Ap.offsets)
    sides = {"": (Ap.data, y, v, dict(offsets=Ap.offsets, m=Ap.m, n=Ap.n,
                                         offsets_t=Ap.offsets_t)),
             "[t]": (Ap.tdata, v, y, dict(offsets=Ap.toffsets, m=Ap.n, n=Ap.m,
                                          offsets_t=Ap.toffsets_t))}
    direct = {}
    for fn in (spmv.dia_fused_halfstep_v2, spmv.dia_fused_halfstep_v3):
        for side, (stripes, yy, vec, kw) in sides.items():
            out, ssq = fn(stripes, yy, vec, c1, c2, **kw)
            d_out, d_ssq = spmv._halfstep_launch(fn, stripes, yy, vec, c1, c2, tile=0, **kw)
            torch.cuda.synchronize()
            same, r = torch.equal(out, d_out), rel(ssq, d_ssq)
            name = f"{fn.__name__}{sfx}{side}"
            log(f"  {name:34s} {label}: {f'staged tiles of {tile}' if tile else 'direct'}, "
                f"out bit-equal to the direct kernel {same}, ssq rel {r:.2e}")
            check(same and r <= TOL, f"{name} {label}: the staged route differs from the "
                  f"direct kernel (out equal {same}, ssq rel {r:.2e})")
        stripes, yy, vec, kw = sides[""]
        direct[fn.__name__ + sfx] = (
            lambda fn=fn, a=(stripes, yy, vec), kw=kw:
            spmv._halfstep_launch(fn, *a, c1, c2, tile=0, **kw))
    return tile, direct


def products_match_direct(As, Ap, v, y, label):
    """Every call of the two products (``product_calls``, the route the
    wrappers take) bit-equal to the direct kernel (``tile=0``: one thread
    an output, the parent's design)."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    tile = spmv._product_rule(As.dp, As.offsets)
    for name, (wrapper, stripes, vec, kw) in product_calls(As, Ap, v, y).items():
        got = wrapper(stripes, vec, **kw)
        ref = spmv._product_launch(wrapper, stripes, vec, tile=0, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        log(f"  {name:34s} {label}: {f'staged tiles of {tile}' if tile else 'direct'}, "
            f"bit-equal to the direct kernel {same}")
        check(same, f"{name} {label}: the staged route differs from the direct kernel")
    return tile


#: the calls of rows 5 and 2 and of the half-step timed besides their first
#: (``kernel_calls``' lists): variant tag, index in the list, and whether
#: the library call is the CSR of A' (else none)
OTHER_CALLS = {"dia_product_shared": (("[adjoint]", 1, True),),
               "dia_matvec": (("[t]", 1, True), ("[column]", 2, True)),
               "dia_product_shared_axpy": (("[adjoint]", 1, False),)}


def kernel_calls(dev, As, Ap, v, y):
    """{variant: [(kernel call, twin call), ...]} of every kernel taking
    the stripes of these operators (f32 or bf16 storage)."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    storage = As.dp.dtype
    m, n, ks = As.m, As.n, As.offsets
    sfx = "" if storage == torch.float32 else "[bf16]"
    c1 = torch.tensor(0.8, device=dev)
    c2 = torch.tensor(1.1, device=dev)
    kw = dict(offsets=ks, m=m, n=n)
    tkw = dict(offsets=Ap.toffsets, m=n, n=m)
    # the kernels read the offsets from the device copies the operators hold
    # (as in a solve); without them each call would copy them to the card
    skw = dict(kw, offsets_t=As.offsets_t)
    pkw = dict(kw, offsets_t=Ap.offsets_t)
    ptkw = dict(tkw, offsets_t=Ap.toffsets_t)
    dp, pd, pt = As.dp, Ap.data, Ap.tdata
    products = product_calls(As, Ap, v, y)
    twins = {spmv.dia_product_shared: spmv.dia_product_shared_plain,
             spmv.dia_matvec: spmv.dia_matvec_plain}

    def product(name):
        wrapper, stripes, vec, pkw_ = products[name]
        tkw_ = {k: a for k, a in pkw_.items() if k != "offsets_t"}
        return (lambda: wrapper(stripes, vec, **pkw_),
                lambda: twins[wrapper](stripes, vec, **tkw_))

    calls = {
        "dia_product_shared": [product(f"dia_product_shared{sfx}"),
                               product(f"dia_product_shared{sfx}[adjoint]")],
        "dia_product_shared_axpy": [
            (lambda a=a: spmv.dia_product_shared_axpy(dp, y if a else v, v if a else y,
                                                      c1, c2, adjoint=a, **skw),
             lambda a=a: spmv.dia_product_shared_axpy_plain(dp, y if a else v,
                                                            v if a else y, c1, c2,
                                                            adjoint=a, **kw))
            for a in (False, True)],
        "dia_pair_shared": [
            (lambda: spmv.dia_pair_shared(dp, v, y, c1, c2, **skw),
             lambda: spmv.dia_pair_shared_plain(dp, v, y, c1, c2, **kw))],
        "dia_matvec": [product(f"dia_matvec{sfx}{tag}") for tag in ("", "[t]", "[column]")],
        "dia_matvec_axpy": [
            (lambda: spmv.dia_matvec_axpy(pd, y, v, c1, c2, **pkw),
             lambda: spmv.dia_matvec_axpy_plain(pd, y, v, c1, c2, **kw)),
            (lambda: spmv.dia_matvec_axpy(pt, v, y, c1, c2, **ptkw),
             lambda: spmv.dia_matvec_axpy_plain(pt, v, y, c1, c2, **tkw)),
            # the f32 result the operators' half-steps take (bf16 stripes)
            (lambda: spmv.dia_matvec_axpy(pd, y, v, c1, c2, out_dtype=torch.float32, **pkw),
             lambda: spmv.dia_matvec_axpy_plain(pd, y, v, c1, c2, out_dtype=torch.float32,
                                                **kw))],
        "dia_pair": [
            (lambda: spmv.dia_pair(pd, y, v, c1, c2, **pkw),
             lambda: spmv.dia_pair_plain(pd, y, v, c1, c2, **kw))],
    }
    if storage == torch.float32:
        calls["dia_fused_halfstep"] = [
            (lambda: spmv.dia_fused_halfstep(pd, y, v, c1, c2, **pkw),
             lambda: spmv.dia_fused_halfstep_plain(pd, y, v, c1, c2, **kw)),
            (lambda: spmv.dia_fused_halfstep(pt, v, y, c1, c2, **ptkw),
             lambda: spmv.dia_fused_halfstep_plain(pt, v, y, c1, c2, **tkw))]
    # the two variants of the fused half-step: v2 with both values of
    # ssq_out (a TPU memory space; the same kernel here), v3; on both sides
    calls["dia_fused_halfstep_v2"] = [
        (lambda s=s, a=a: spmv.dia_fused_halfstep_v2(*a[0], c1, c2, ssq_out=s, **a[1]),
         lambda s=s, a=a: spmv.dia_fused_halfstep_v2_plain(*a[0], c1, c2, ssq_out=s,
                                                           **a[2]))
        for a in (((pd, y, v), pkw, kw), ((pt, v, y), ptkw, tkw)) for s in ("vmem", "smem")]
    calls["dia_fused_halfstep_v3"] = [
        (lambda a=a: spmv.dia_fused_halfstep_v3(*a[0], c1, c2, **a[1]),
         lambda a=a: spmv.dia_fused_halfstep_v3_plain(*a[0], c1, c2, **a[2]))
        for a in (((pd, y, v), pkw, kw), ((pt, v, y), ptkw, tkw))]
    out = {name + sfx: pairs for name, pairs in calls.items()}
    if As.H <= spmv.PAIR_MAX_HALO:  # the shared pair's unstaged kernel, called
        # directly (the route where no staged tile fits); above the halo both
        # routes are two launches
        out.update(unstaged_calls(dp, v, y, c1, c2, skw, kw))
    return out


def unstaged_calls(dp, v, y, c1, c2, skw, kw):
    """{the shared pair's unstaged variant: [(its kernel, called directly
    whatever the route, twin call)]} for these shared stripes."""
    from lsqr_tpu_torch.ops import spmv

    return {f"dia_pair_shared[{spmv.UNSTAGED[dp.dtype]}]": [
        (lambda: spmv._dia_pair_shared_launch(dp, v, y, c1, c2, tile=0, **skw),
         lambda: spmv.dia_pair_shared_plain(dp, v, y, c1, c2, **kw))]}


def hold(calls, errs, m, n, ks, bound):
    """Run every (kernel, twin) call and hold the outputs to ``bound``."""
    import torch

    for name, pairs in calls.items():
        for kernel, plain in pairs:
            got, ref = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"{name}: {a.dtype}{tuple(a.shape)} vs twin {b.dtype}{tuple(b.shape)}")
                r = rel(a, b)
                errs[name] = max(errs.get(name, 0.0), absdiff(a, b))
                tol = BF16_TOL if a.dtype == torch.bfloat16 else bound
                log(f"  {name:30s} m={m} n={n} nd={len(ks)} out {tuple(a.shape)} "
                    f"{str(a.dtype)[6:]}: max rel err {r:.3e}")
                check(r <= tol, f"{name} disagrees with its twin: {r:.3e} > {tol}")


def pair_routes_agree(calls, storage, label):
    """The shared pair's route at these stripes, called twice, and its
    unstaged kernel where ``calls`` holds it (``kernel_calls``' first
    pairs) give the same bits."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    sfx = "" if storage == torch.float32 else "[bf16]"
    route = calls["dia_pair_shared" + sfx][0][0]
    others = [("a second call", route)]
    unstaged = calls.get(f"dia_pair_shared[{spmv.UNSTAGED[storage]}]")
    if unstaged:
        others.append(("the unstaged kernel", unstaged[0][0]))
    first = route()
    for tag, fn in others:
        got = fn()
        same = all(torch.equal(a, b) for a, b in zip(got, first))
        log(f"  dia_pair_shared{sfx} {label}: {tag} bit-equal {same}")
        check(same, f"dia_pair_shared{sfx} {label}: {tag} differs in u or z")


def dia_perf(name, ms, plain_ms, m, n, nd, esize, lib=None):
    """The perf entry of a DIA kernel variant: the bytes it must move (the
    stripes once, its f32 or f64 vectors, a bf16 result where it has one)
    and its 2 flops per stripe element and product."""
    vm, vn = VECTORS[base(name)]
    moved = nd * m * esize + (vm * m + vn * n) * (8 if esize == 8 else 4)
    if esize == 2 and base(name) in STRIPE_DTYPE_OUT:
        moved -= 2 * m  # out is bf16
    flops = 2 * nd * m * (2 if "pair" in name else 1)
    return perf_entry(ms, plain_ms, moved, flops, esize, lib)


def phase_pair_routes(dev, m, errs, card):
    """Phase 1 at m = n (2^19 on the card), 11 diagonals: the shared
    pair's staged route (checked to be the one taken) and its unstaged
    kernel against the twin and each other (the same bits), f32 and bf16
    stripes, timed beside their bound: {variant: perf entry}."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    data, y, g = random_stripes(m, m, OFFSETS, dev, seed=19)
    v = torch.randn(m, generator=g, device=dev)
    out = {}
    for storage in (torch.float32, torch.bfloat16):
        As, Ap = dia_operators(data, m, m, OFFSETS, storage)
        calls = {k: pairs for k, pairs in kernel_calls(dev, As, Ap, v, y).items()
                 if base(k) == "dia_pair_shared"}
        hold(calls, errs, m, m, OFFSETS, TOL)
        tile = spmv.pair_tile(dev, storage, len(OFFSETS), *spmv._halos(OFFSETS))
        check(tile > 0, f"m={m}: the shared pair must take the staged route")
        pair_routes_agree(calls, storage, f"m={m} n={m} nd={len(OFFSETS)}")
        for name, pairs in calls.items():
            out[name] = dia_perf(name, time_ms(pairs[0][0]), time_ms(pairs[0][1]), m, m,
                                 len(OFFSETS), storage.itemsize)
            report(f"{name} m={m}", out[name], card)
    del data, y, v
    torch.cuda.empty_cache()
    return out


def library_ms(csr, x, kernel_out):
    """The time of ``csr @ x`` (cuSPARSE), after checking that it computes
    what the kernel computed."""
    err = rel(csr @ x, kernel_out)
    check(err <= 1e-5, f"the library product disagrees with the kernel: {err:.3e}")
    return time_ms(lambda: csr @ x)


def phase_kernels(dev, shapes, errs, paths):
    """Phase 1: every kernel against its twin on the card; returns
    {variant: (kernel ms, twin ms, m, n, nd, stripe bytes per element,
    library ms or None, direct kernel ms or None)} of the first call of
    each, at the first (main-path) shape for f32 and bf16 and at the second
    for f64, and of the other calls of the products and the half-step
    (OTHER_CALLS: ``<variant>[adjoint]``, ``[t]``, ``[column]``, each with
    its (dim_out, dim_in) or, for the packed column side, its stripes' (m,
    n)). The library call is
    ``torch.sparse_csr_tensor @ x`` of the same matrix (of A' for the
    products' other calls), for the products in f32 and f64. At every shape,
    f32 and bf16, each call of the two products is held bit for bit to the
    direct kernel; the main shape's must take the staged route. At the main
    shape the kernels no solver calls (DIRECT) run once more as a counted
    path of their own, the direct call. The fused half-step's two variants
    (DIRECT) are held to their direct kernel at every shape, f32 and bf16
    (``halfsteps_match_direct``); the main shape's must take the staged
    route, and their direct kernel is timed there too: the last item of
    their entries, None for the others."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    times = {}
    for si, (m, n, ks) in enumerate(shapes):
        data, y, g = random_stripes(m, n, ks, dev, seed=si)
        v = torch.randn(n, generator=g, device=dev)
        for storage in (torch.float32, torch.bfloat16):
            As, Ap = dia_operators(data, m, n, ks, storage)
            tile = products_match_direct(As, Ap, v, y, f"m={m} n={n} nd={len(ks)}")
            check(si != 0 or tile > 0, "the main shape's products must take the staged route")
            tile, direct_calls = halfsteps_match_direct(Ap, v, y, f"m={m} n={n} nd={len(ks)}")
            check(si != 0 or tile > 0,
                  "the main shape's fused half-steps must take the staged route")
            if si and storage == torch.bfloat16:  # held to the twins at the main shape
                del As, Ap
                continue
            calls = kernel_calls(dev, As, Ap, v, y)
            hold(calls, errs, m, n, ks, TOL)
            tile = spmv.pair_tile(data.device, storage, len(ks), *spmv._halos(ks))
            ring = spmv._ring_fits(data.device, storage, len(ks), *spmv._halos(ks))
            route = spmv.pair_shared_route(max(abs(k) for k in ks), tile, ring)
            log(f"  dia_pair m={m} n={n} nd={len(ks)} {str(storage)[6:]} stripes: "
                + (f"staged tiles of {tile}" if tile else "the two-launch route")
                + f"; dia_pair_shared: {route}")
            check(si != 0 or route == "staged",
                  f"the main shape's shared pair must take the staged route, not {route}")
            pair_routes_agree(calls, storage, f"m={m} n={n} nd={len(ks)}")
            if si == 0:
                csr, csr_t = (None, None)
                if storage == torch.float32:
                    rows, cols, vals = stripe_triplets(data, ks, m, n)
                    csr, csr_t = csr_of(rows, cols, vals, m, n), csr_of(cols, rows, vals, n, m)
                    del rows, cols, vals
                for name, pairs in calls.items():
                    lib = None
                    if csr is not None and name in ("dia_product_shared", "dia_matvec"):
                        lib = library_ms(csr, v, pairs[0][0]())
                    direct_ms = (time_ms(direct_calls[name]) if name in direct_calls
                                 else None)
                    times[name] = (time_ms(pairs[0][0]), time_ms(pairs[0][1]), m, n,
                                   len(ks), storage.itemsize, lib, direct_ms)
                    for tag, i, transposed in OTHER_CALLS.get(base(name), ()):
                        lib = (library_ms(csr_t, y, pairs[i][0]())
                               if csr_t is not None and transposed else None)
                        # the packed column side reads data's (m, n) stripes
                        shape = (m, n) if tag == "[column]" else (n, m)
                        times[name + tag] = (time_ms(pairs[i][0]), time_ms(pairs[i][1]),
                                             *shape, len(ks), storage.itemsize, lib, None)
                direct = [fn for name, pairs in calls.items() if base(name) in DIRECT
                          for fn, _ in pairs]
                _, delta = counted(lambda: [fn() for fn in direct])
                paths.append(delta)
                log(f"  the direct path ({str(storage)[6:]} stripes): "
                    f"{({k: v for k, v in delta.items() if v})}")
                check(sum(delta.values()) == len(direct) and all(
                    delta[k] > 0 for name in DIRECT
                    for k in [name + ("" if storage == torch.float32 else "[bf16]")]),
                      f"the direct path: expected one launch per call: {delta}")
                del csr, csr_t
            del calls, As, Ap
        if si == 1:  # the f64 products (f64 solves on the card use them);
            # full-width f64 values: products of f32 values would be exact
            import lsqr_tpu_torch as lt

            d64 = torch.randn(data.shape, generator=g, device=dev, dtype=torch.float64)
            x64 = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
            y64 = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
            As = lt.dia_shared_operator(m, n, ks, d64)
            Ap = lt.dia_operator_device(m, n, ks, d64)
            kw = dict(offsets=ks, m=m, n=n)
            tkw = dict(offsets=Ap.toffsets, m=n, n=m)
            skw = dict(kw, offsets_t=As.offsets_t)
            calls = {
                "dia_product_shared[f64]": [
                    (lambda: spmv.dia_product_shared(As.dp, x64, adjoint=False, **skw),
                     lambda: spmv.dia_product_shared_plain(As.dp, x64, adjoint=False, **kw)),
                    (lambda: spmv.dia_product_shared(As.dp, y64, adjoint=True, **skw),
                     lambda: spmv.dia_product_shared_plain(As.dp, y64, adjoint=True, **kw))],
                "dia_matvec[f64]": [
                    (lambda: spmv.dia_matvec(Ap.data, x64, offsets_t=Ap.offsets_t, **kw),
                     lambda: spmv.dia_matvec_plain(Ap.data, x64, **kw)),
                    (lambda: spmv.dia_matvec(Ap.tdata, y64, offsets_t=Ap.toffsets_t, **tkw),
                     lambda: spmv.dia_matvec_plain(Ap.tdata, y64, **tkw))],
            }
            hold(calls, errs, m, n, ks, 1e-12)
            csr = stripes_csr(d64, ks, m, n)
            for name, pairs in calls.items():
                times[name] = (time_ms(pairs[0][0]), time_ms(pairs[0][1]), m, n,
                               len(ks), 8, library_ms(csr, x64, pairs[0][0]()), None)
            del calls, As, Ap, d64, csr
        del data, y, v
        torch.cuda.empty_cache()
    return times


def timed_solve(A, b, label, card, **kw):
    """One lsqr solve as a counted path: (result, launches by variant,
    wall seconds)."""
    import torch

    import lsqr_tpu_torch as lt

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.lsqr(A, b, DAMP, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (res, secs), delta = counted(run)
    itn, istop = int(res.itn), int(res.istop)
    check(bool(torch.isfinite(res.x).all()) and res.x.shape == (A.n,), f"{label}: bad x")
    launched = {k: v for k, v in delta.items() if v}
    log(f"  {label}: istop={istop} itn={itn} rnorm={float(res.rnorm):.6e} "
        f"arnorm={float(res.arnorm):.6e} wall={secs * 1e3:.3f} ms "
        f"({secs * 1e3 / max(itn, 1):.4f} ms/iteration incl. setup, {card}) "
        f"launches={launched}")
    return res, delta, secs


def iterations_run(itn, seg):
    """Iterations a masked-segment solve runs: itn plus the masked rest."""
    return -(-itn // seg) * seg


def optimality(forward, adjoint, fro, b, x, damp=DAMP):
    """||A'r - damp^2 x|| / (||A||_F ||(r; damp x)||) in f64 with r = b - A x,
    from f64 products (xcheck's test3, lsqr.f90:1089-1094)."""
    import torch

    x64 = wide(x)
    r = wide(b) - forward(x64)
    grad = adjoint(r) - damp ** 2 * x64
    rho = torch.sqrt(r.norm() ** 2 + (damp * x64.norm()) ** 2)
    return float(grad.norm() / (fro * rho))


def packed_optimality(A, b, x):
    """:func:`optimality` of a DIAOperator, from its stripes in f64 (the
    column side of data gives the adjoint without an f64 tdata)."""
    from lsqr_tpu_torch.ops.spmv import dia_matvec_plain

    d64 = A.data.double()
    kw = dict(offsets=A.offsets, m=A.m, n=A.n)
    ratio = optimality(lambda x: dia_matvec_plain(d64, x, **kw),
                       lambda r: dia_matvec_plain(d64, r, adjoint=True, **kw),
                       d64.norm(), b, x)
    del d64
    return ratio


def shared_optimality(A, b, x):
    from lsqr_tpu_torch.ops.spmv import dia_product_shared_plain

    dp64 = A.dp.double()
    kw = dict(offsets=A.offsets, m=A.m, n=A.n)
    ratio = optimality(lambda x: dia_product_shared_plain(dp64, x, adjoint=False, **kw),
                       lambda r: dia_product_shared_plain(dp64, r, adjoint=True, **kw),
                       dp64.norm(), b, x)
    del dp64
    return ratio


def phase_main_solve(dev, m, card, paths):
    """Phase 2-3: the main-path solves at m = n (2^23 on the card)."""
    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_shared_operator(m, m, OFFSETS, data)
    del data
    check(A.prefers_pair, "the f32 operator on the card must take pair mode")
    seg = lt.LSQROptions().loop_segment
    out = {}

    def solve(label, **kw):
        res, delta, secs = timed_solve(A, b, label, card, **kw)
        paths.append(delta)
        return res, delta, secs

    # (a) to the machine-precision guards, at most 64 iterations
    res, delta, _ = solve("(a) itnlim=64, atol=btol=conlim=0", itnlim=64, atol=0.0,
                          btol=0.0, conlim=0.0)
    check(int(res.istop) in (1, 2, 3, 5) and int(res.itn) <= 64, "(a) bad stop")
    check(int(res.istop) != 5 or int(res.itn) == 64, "(a) istop 5 before itnlim")
    check(delta["dia_pair_shared"] == 64 and delta["dia_product_shared"] == 1,
          f"(a) expected 64 pair launches (itn + masked) and one setup product: {delta}")

    # fixed length: nconv > itnlim keeps the solve going to itnlim
    kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    solve("warm-up 64 iterations", **kw)
    res, delta, secs = solve("fixed 64 iterations", **kw)
    check(int(res.itn) == 64 and delta["dia_pair_shared"] == 64, "fixed run: itn != 64")
    out["ms_per_iteration_fixed64"] = secs * 1e3 / 64

    # (b) to atol = btol = 1e-6
    res_b, delta, secs = solve("(b) atol=btol=1e-6", atol=1e-6, btol=1e-6)
    itn_b = int(res_b.itn)
    check(int(res_b.istop) in (1, 2, 3), f"(b) istop {int(res_b.istop)}")
    body = iterations_run(itn_b, seg)
    check(delta["dia_pair_shared"] == body,
          f"(b) pair launches {delta['dia_pair_shared']} != itn + masked = {body}")
    out["solve_b"] = dict(istop=int(res_b.istop), itn=itn_b, ms=secs * 1e3)

    # independent check of (b), in f64 with the twins: the damped normal
    # equations' residual
    ratio = shared_optimality(A, b, res_b.x)
    log(f"  (b) independent check ||A'r - damp^2 x|| / (||A||_F ||(r; damp x)||)"
        f" = {ratio:.3e}")
    check(ratio <= 1e-4, f"(b) independent optimality check {ratio:.3e} > 1e-4")
    out["optimality_b"] = ratio

    # phase 3: pair=False goes through the product+axpy kernel
    res_c, delta, secs = solve("(b) pair=False", atol=1e-6, btol=1e-6, pair=False)
    check(int(res_c.istop) == int(res_b.istop), "pair=False: istop differs")
    check(abs(int(res_c.itn) - itn_b) <= 2, "pair=False: itn differs by more than 2")
    body = iterations_run(int(res_c.itn), seg)
    check(delta["dia_product_shared_axpy"] == 2 * body and delta["dia_pair_shared"] == 0,
          f"pair=False: expected {2 * body} axpy launches: {delta}")
    check(rel(res_c.x, res_b.x) <= 1e-4, "pair=False: x differs")
    out["solve_pair_false"] = dict(istop=int(res_c.istop), itn=int(res_c.itn), ms=secs * 1e3)
    return A, b, res_b.x, out


def phase_auto_operator(dev, m, paths):
    """Phase 4: COO triplets -> auto_operator on the card -> a short solve,
    against the same solve on the host (the twins)."""
    import numpy as np
    import torch

    import lsqr_tpu_torch as lt

    rng = np.random.default_rng(4)
    i = np.arange(m)
    rows, cols, vals = [], [], []
    for k in OFFSETS:
        ok = (i + k >= 0) & (i + k < m)
        rows.append(i[ok])
        cols.append(i[ok] + k)
        vals.append(rng.standard_normal(ok.sum()).astype(np.float32) + (12.0 if k == 0 else 0.0))
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    b = rng.standard_normal(m).astype(np.float32)
    A = lt.auto_operator(m, m, vals, rows, cols, device=dev)
    check(isinstance(A, lt.DIASharedOperator) and A.dp.device.type == dev.type
          and A.offsets == OFFSETS,
          f"auto_operator chose {type(A).__name__}")
    res, delta = counted(lambda: lt.lsqr(A, b, DAMP, atol=1e-6, btol=1e-6))
    paths.append(delta)
    check(delta["dia_pair_shared"] > 0, f"auto_operator solve: no pair launches {delta}")
    ref = lt.lsqr(lt.auto_operator(m, m, vals, rows, cols, device="cpu"), b, DAMP,
                  atol=1e-6, btol=1e-6)
    err = rel(res.x.cpu(), ref.x)
    log(f"  auto_operator -> {type(A).__name__} on {A.dp.device}: istop={int(res.istop)} "
        f"itn={int(res.itn)}; host twin solve istop={int(ref.istop)} itn={int(ref.itn)}; "
        f"x rel diff {err:.3e}")
    check(int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 2,
          "auto_operator solve differs from the host solve")
    check(err <= 1e-4 and bool(torch.isfinite(res.x).all()), "auto_operator solve: x differs")


def halfstep_many(A, v, y, c1, c2, errs, card):
    """Phase 4: the half-step (forward and adjoint) on the many-diagonal
    shared stripes ``A`` against its twin, the same bits over two calls and
    from the direct kernel (one thread an output), timed beside its bound:
    {direction: perf entry with its bound}."""
    import torch

    from lsqr_tpu_torch.ops import spmv

    m, ks = A.m, A.offsets
    name = "dia_product_shared_axpy" + ("" if A.dp.dtype == torch.float32 else "[bf16]")
    kw = dict(offsets=ks, m=m, n=m)
    tile = spmv.axpy_tile(len(ks), *spmv._halos(ks), A.dp.dtype.itemsize,
                          *spmv._smem_limits(A.dp.device))
    log(f"  {name} m={m} nd={len(ks)}: staged tiles of {tile}")
    check(tile > 0, f"{name} at {len(ks)} diagonals must take the staged kernel")
    calls = {name: [
        (lambda a=a: spmv.dia_product_shared_axpy(A.dp, y if a else v, v if a else y, c1, c2,
                                                  adjoint=a, offsets_t=A.offsets_t, **kw),
         lambda a=a: spmv.dia_product_shared_axpy_plain(A.dp, y if a else v, v if a else y,
                                                        c1, c2, adjoint=a, **kw))
        for a in (False, True)]}
    hold(calls, errs, m, m, ks, TOL)
    out = {}
    for a, (kernel, plain) in zip(("forward", "adjoint"), calls[name]):
        direct = spmv._axpy_launch(A.dp, y if a == "adjoint" else v, v if a == "adjoint" else y,
                                   c1, c2, adjoint=a == "adjoint", offsets_t=A.offsets_t,
                                   tile=0, **kw)
        first, again = kernel(), kernel()
        same = bool(torch.equal(first, again) and torch.equal(first, direct))
        log(f"  {name} {a}: a second call and the direct kernel bit-equal {same}")
        check(same, f"{name} m={m} nd={len(ks)} {a}: not the same bits")
        entry = dia_perf(name, time_ms(kernel), time_ms(plain, reps=3), m, m, len(ks),
                         A.dp.dtype.itemsize)
        report(f"{name} m={m} nd={len(ks)} {a}", entry, card)
        out[a] = dict(entry, bound_ms=bound(entry["bytes"], entry["flops"], entry["esize"])[0])
    return out


def phase_unstaged_solves(dev, errs, card, paths):
    """Phase 4: solves on the shared layout whose pair takes the unstaged
    route, the ring kernel (MANY: no staged tile's two stages fit one SM),
    f32 and bf16 stripes, to atol = btol = 1e-6, checked in f64 and against
    the same solve with the pair as two launches (istop and itn equal).
    First the pair at these stripes: the wrapper (one launch, on the
    unstaged route) and the ring kernel called directly against the twin,
    the same bits over two calls, and its time beside its bound (f32: and
    the two CSR calls); then the half-step there (``halfstep_many``).
    Returns (solves, {variant: perf entry})."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    m, ks, boost = MANY
    data, b, g = random_stripes(m, m, ks, dev, seed=104, boost=boost)
    v = torch.randn(m, generator=g, device=dev)
    c1 = torch.tensor(0.8, device=dev)
    c2 = torch.tensor(1.1, device=dev)
    seg = lt.LSQROptions().loop_segment
    out, perf = {}, {}
    for storage in (torch.float32, torch.bfloat16):
        A = lt.dia_shared_operator(m, m, ks, data, storage_dtype=storage)
        tag = str(storage)[6:]
        tile = spmv.pair_tile(dev, storage, len(ks), *spmv._halos(ks))
        ring = spmv._ring_fits(dev, storage, len(ks), *spmv._halos(ks))
        check(spmv.pair_shared_route(A.H, tile, ring) == "unstaged",
              f"{len(ks)} diagonals, {tag}: expected the unstaged route (tile {tile})")
        sfx = "" if storage == torch.float32 else "[bf16]"
        kw = dict(offsets=ks, m=m, n=m)
        calls = {"dia_pair_shared" + sfx: [
            (lambda: spmv.dia_pair_shared(A.dp, v, b, c1, c2, offsets_t=A.offsets_t, **kw),
             lambda: spmv.dia_pair_shared_plain(A.dp, v, b, c1, c2, **kw))],
            **unstaged_calls(A.dp, v, b, c1, c2, dict(kw, offsets_t=A.offsets_t), kw)}
        hold(calls, errs, m, m, ks, TOL)
        _, delta = counted(calls["dia_pair_shared" + sfx][0][0])  # a comparison: not a path
        check({k: c for k, c in delta.items() if c} == {
            f"dia_pair_shared[{spmv.UNSTAGED[storage]}]": 1},
              f"{len(ks)} diagonals {tag}: the wrapper must launch the unstaged kernel "
              f"once: {delta}")
        pair_routes_agree(calls, storage, f"m={m} n={m} nd={len(ks)}")
        out[f"halfstep {tag}"] = halfstep_many(A, v, b, c1, c2, errs, card)
        unstaged = f"dia_pair_shared[{spmv.UNSTAGED[storage]}]"
        kernel, plain = calls[unstaged][0]
        lib = None
        if storage == torch.float32:  # CSR A @ x, then the CSR of A' @ u
            r_, c_, v_ = stripe_triplets(data, ks, m, m)
            csr, csr_t = csr_of(r_, c_, v_, m, m), csr_of(c_, r_, v_, m, m)
            u, z = kernel()
            parts = (library_ms(csr, v * c1, u + c2 * b), library_ms(csr_t, u, z))
            lib = sum(parts)
            log(f"  library: two calls, CSR A @ x {parts[0]:.4f} ms plus the CSR of A' @ u "
                f"{parts[1]:.4f} ms")
            del r_, c_, v_, csr, csr_t, u, z
        perf[unstaged] = dia_perf(unstaged, time_ms(kernel), time_ms(plain, reps=3), m, m,
                                  len(ks), storage.itemsize, lib)
        report(f"{unstaged} m={m} nd={len(ks)}", perf[unstaged], card)
        del calls
        res, delta, secs = timed_solve(A, b, f"{len(ks)} diagonals {tag} (b)", card,
                                       atol=1e-6, btol=1e-6)
        paths.append(delta)
        body = iterations_run(int(res.itn), seg)
        check(int(res.istop) in (1, 2, 3), f"{len(ks)} diagonals {tag}: bad stop")
        check(delta[unstaged] == body and delta["dia_pair_shared" + sfx] == 0,
              f"{len(ks)} diagonals {tag}: expected {body} unstaged pair launches: {delta}")
        ratio = shared_optimality(A, b, res.x)  # bf16: against the rounded operator
        log(f"  {len(ks)} diagonals {tag}: independent check {ratio:.3e}")
        check(ratio <= 1e-4, f"{len(ks)} diagonals {tag}: optimality check {ratio:.3e}")
        # the same solve with the pair as two launches (rows 2-3's kernels,
        # which sum in the order of the ring kernel and of the kernel it
        # replaced): the same istop and itn
        kw2 = dict(kw, offsets_t=A.offsets_t)

        def two_launches(*, y, win, c1, c2):
            u = spmv.dia_product_shared_axpy(A.dp, win, y, c1, c2, adjoint=False, **kw2)
            return u, spmv.dia_product_shared(A.dp, u, adjoint=True, **kw2)

        object.__setattr__(A, "fused_pair", two_launches)
        ref = lt.lsqr(A, b, DAMP, atol=1e-6, btol=1e-6)
        object.__delattr__(A, "fused_pair")
        same = bool(torch.equal(res.x, ref.x))
        log(f"  {len(ks)} diagonals {tag}: istop {int(res.istop)} itn {int(res.itn)}; with "
            f"the pair as two launches istop {int(ref.istop)} itn {int(ref.itn)}, x "
            f"bit-equal {same} (rel diff {rel(res.x, ref.x):.3e})")
        check((int(res.istop), int(res.itn)) == (int(ref.istop), int(ref.itn)),
              f"{len(ks)} diagonals {tag}: istop/itn differ from the two-launch solve")
        out[tag] = dict(istop=int(res.istop), itn=int(res.itn), ms=secs * 1e3,
                        optimality=ratio, x_bit_equal_to_two_launches=same)
        del A, ref
    del data, b, v
    torch.cuda.empty_cache()
    return out, perf


def scipy_istop(istop, damped):
    """scipy's lsqr taxonomy mapped to the reference's (lsqr.f90:520-538)."""
    mapped = {0: 0, 1: 1, 2: 2, 3: 4, 4: 1, 5: 2, 6: 4, 7: 5}[istop]
    return 3 if (damped and mapped == 2) else mapped


def phase_f64(dev, m, paths):
    """Phase 5: f64 on the card against scipy (shared layout, and the packed
    one through auto_operator), and the README 3x3."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg
    import torch

    import lsqr_tpu_torch as lt

    rng = np.random.default_rng(5)
    data = rng.standard_normal((len(OFFSETS), m))
    data[OFFSETS.index(0)] += 12.0
    b = rng.standard_normal(m)
    i = np.arange(m)
    ok = [(i + k >= 0) & (i + k < m) for k in OFFSETS]
    vals = np.concatenate([data[d][ok[d]] for d in range(len(OFFSETS))])
    rows = np.concatenate([i[ok[d]] for d in range(len(OFFSETS))])
    cols = np.concatenate([i[ok[d]] + k for d, k in enumerate(OFFSETS)])
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    tol = dict(atol=1e-10, btol=1e-10, conlim=1e8)
    ref = scipy.sparse.linalg.lsqr(S, b, damp=DAMP, iter_lim=2 * m, **tol)
    istop_ref, itn_ref = scipy_istop(ref[1], DAMP > 0), ref[2]

    for label, A, kernel in (
            ("shared", lt.dia_shared_operator(m, m, OFFSETS, data, device=dev),
             "dia_product_shared[f64]"),
            ("auto_operator", lt.auto_operator(m, m, vals, rows, cols, device=dev),
             "dia_matvec[f64]")):
        if label == "auto_operator":
            check(isinstance(A, lt.DIAOperator) and A.data.device.type == dev.type
                  and A.dtype == torch.float64,
                  f"auto_operator chose {type(A).__name__} for f64 on the card")
        res, launched = counted(lambda: lt.lsqr(A, b, DAMP, itnlim=2 * m, **tol))
        paths.append(launched)
        err = float(np.abs(res.x.cpu().numpy() - ref[0]).max() / np.abs(ref[0]).max())
        log(f"  f64 m=n={m} {label} -> {type(A).__name__}: port istop={int(res.istop)} "
            f"itn={int(res.itn)}; scipy istop={ref[1]} (= {istop_ref}) itn={itn_ref}; "
            f"x rel diff {err:.3e}; launches {({k: v for k, v in launched.items() if v})}")
        check(res.x.dtype == torch.float64 and res.x.device.type == dev.type,
              "the f64 solve left the card or f64")
        check(int(res.istop) == istop_ref and abs(int(res.itn) - itn_ref) <= 1,
              f"f64 {label}: istop/itn differ from scipy")
        check(err <= 1e-8, f"f64 {label}: x differs from scipy by {err:.3e}")
        check(launched[kernel] > 0 and launched["dia_pair_shared"] == 0
              and launched["dia_pair"] == 0,
              f"f64 {label} solves run unfused through the f64 product kernel")

    solver = lt.LSQRSolver(3, 3, [1.0, 4.0, 7.0, 2.0, 5.0, 88.0, 3.0, 66.0, 9.0],
                           [0, 1, 2, 0, 1, 2, 0, 1, 2], [0, 0, 0, 1, 1, 1, 2, 2, 2],
                           device=dev)
    r3 = solver.solve([1.0, 2.0, 3.0])
    x3 = r3.x.cpu().numpy()
    log(f"  README 3x3 on {r3.x.device}: istop={int(r3.istop)} x={x3.tolist()}")
    check(int(r3.istop) == 1 and np.allclose(x3, [1.242424, -0.06060606, -0.04040404],
                                               rtol=1e-5), "README 3x3")


def profile_run(A, b, itnlim, solve=None, **extra):
    """One fixed ``itnlim``-iteration LSQR solve (or ``solve(A, b, damp,
    **kw)``'s) under the profiler, after an unprofiled one: (device events,
    runtime launch calls, device ms, {kernel name: (events, device ms)},
    {wrapper: launches it counted in the profiled solve})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import spmv

    kw = dict(itnlim=itnlim, atol=0.0, btol=0.0, conlim=0.0, nconv=itnlim + 1, **extra)
    solve = solve or lt.lsqr
    solve(A, b, DAMP, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        before = spmv.launch_counts()
        solve(A, b, DAMP, **kw)
        torch.cuda.synchronize()
        after = spmv.launch_counts()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launch_calls = [e for e in events if "LaunchKernel" in e.name]
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    return (len(kernels), len(launch_calls), sum(t for _, t in by_name.values()), by_name,
            {k: after[k] - before[k] for k in after})


def phase_launches(A, b, own=None, solve=None, **extra):
    """Phase 6 (and 7, 8, 10, 19, 20): CUDA launches per iteration of a
    solve (the pair solve, or ``extra``'s, or ``solve``'s: see
    :func:`profile_run`), from the profiler: (device events of a
    128-iteration run - a 64-iteration run) / 64, with the kernel time per
    iteration likewise.

    ``own`` = (kernel name, iterations per launch) names a kernel that must
    launch once per that many iterations: the megakernel's own events, by
    name, must differ by exactly 64 / K between the two runs. The totals
    are logged but not held there: they differ by four device events (two
    launches and two state copies), and a stray set of small torch kernels
    in one run can cancel that (``tools/launch_profile_counts.py``). A
    profile in which the profiler saw fewer of that kernel's device events
    than its wrapper launched lost events (a run seen with 20 device events
    where the shorter one had 80): the pair is profiled again, up to
    ``PROFILE_ATTEMPTS`` times, and each run's events must equal its
    launches."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        counts = {itnlim: profile_run(A, b, itnlim, solve, **extra) for itnlim in (64, 128)}
        if own is None:
            break
        seen = {it: (sum(c for kernel, (c, _) in counts[it][3].items() if own[0] in kernel),
                     counts[it][4][own[0]]) for it in counts}
        if all(events >= launched for events, launched in seen.values()):
            break
        log(f"  attempt {attempt}: the profiler lost {own[0]} events (events, launches "
            f"by run: {seen}; device events {counts[64][0]} / {counts[128][0]})")
    per_iter = (counts[128][0] - counts[64][0]) / 64
    calls = (counts[128][1] - counts[64][1]) / 64
    busy = (counts[128][2] - counts[64][2]) / 64
    log(f"  device events per iteration: {per_iter:.2f} ({counts[64][0]} / {counts[128][0]} "
        f"in the 64- / 128-iteration runs; runtime launch calls seen: {calls:.2f}); "
        f"kernel time per iteration {busy:.4f} ms")
    out = dict(kernels_per_iteration=per_iter, kernel_ms_per_iteration=busy)
    if own is None:
        check(per_iter > 0, "the profiler saw no more CUDA kernels in 128 iterations "
              "than in 64")
    else:
        name, k = own
        mine = [sum(c for kernel, (c, _) in counts[it][3].items() if name in kernel)
                for it in (64, 128)]
        log(f"  {name} events: {mine[0]} / {mine[1]} in the 64- / 128-iteration runs "
            f"(one launch per {k} iterations: a difference of {64 // k})")
        check(all(mine[i] == counts[it][4][name] for i, it in enumerate((64, 128))),
              f"{name}: the profiler saw {mine} events where the wrapper launched "
              f"{[counts[it][4][name] for it in (64, 128)]}")
        check(mine[1] - mine[0] == 64 // k,
              f"{name}: {mine[1] - mine[0]} more launches in 128 iterations than in 64, "
              f"not {64 // k}")
        out[f"{name}_per_iteration"] = (mine[1] - mine[0]) / 64
    top = sorted(counts[128][3].items(), key=lambda kv: -kv[1][1])[:10]
    for kname, (n, t) in top:  # the 128-iteration run, setup included
        log(f"    {t / 128:9.4f} ms/it  {n / 128:6.2f} launches/it  {kname[:90]}")
    return out


def phase_packed_solve(dev, m, x_shared, card, paths):
    """Phase 7: the phase-2 problem on the packed layout, same stripes."""
    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_operator_device(m, m, OFFSETS, data)
    del data
    check(isinstance(A, lt.DIAOperator) and A.prefers_pair and A.prefers_fused,
          "the packed f32 operator on the card must prefer pair and fused modes")
    seg = lt.LSQROptions().loop_segment
    out = {}

    def solve(label, op=None, rhs=None, **kw):
        res, delta, secs = timed_solve(op or A, b if rhs is None else rhs,
                                       f"packed {label}", card, **kw)
        paths.append(delta)
        return res, delta, secs

    kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    solve("warm-up 64 iterations", **kw)
    res, delta, secs = solve("fixed 64 iterations", **kw)
    check(int(res.itn) == 64 and delta["dia_pair"] == 64 and delta["dia_matvec"] == 1,
          f"packed fixed run: expected 64 pair launches and one setup product: {delta}")
    out["ms_per_iteration_fixed64"] = secs * 1e3 / 64

    res_b, delta, secs = solve("(b) atol=btol=1e-6", atol=1e-6, btol=1e-6)
    itn_b, istop_b = int(res_b.itn), int(res_b.istop)
    check(istop_b in (1, 2, 3), f"packed (b) istop {istop_b}")
    check(delta["dia_pair"] == iterations_run(itn_b, seg),
          f"packed (b): pair launches {delta['dia_pair']} != itn + masked")
    ratio = packed_optimality(A, b, res_b.x)
    err = rel(res_b.x, x_shared)
    log(f"  packed (b) independent check {ratio:.3e}; x rel diff to the shared solve "
        f"{err:.3e}")
    check(ratio <= 1e-4, f"packed (b) independent optimality check {ratio:.3e} > 1e-4")
    check(err <= 1e-4, f"packed (b): x differs from the shared layout's by {err:.3e}")
    out["solve_b"] = dict(istop=istop_b, itn=itn_b, ms=secs * 1e3, optimality=ratio,
                          x_rel_to_shared=err)

    res_c, delta, secs = solve("(b) pair=False", atol=1e-6, btol=1e-6, pair=False)
    body = iterations_run(int(res_c.itn), seg)
    check(int(res_c.istop) == istop_b and abs(int(res_c.itn) - itn_b) <= 2,
          "packed pair=False: istop/itn differ")
    check(delta["dia_fused_halfstep"] == 2 * body and delta["dia_pair"] == 0,
          f"packed pair=False: expected {2 * body} fused half-steps: {delta}")
    check(rel(res_c.x, res_b.x) <= 1e-4, "packed pair=False: x differs")
    out["solve_pair_false"] = dict(istop=int(res_c.istop), itn=int(res_c.itn), ms=secs * 1e3)

    res_d, delta, secs = solve("(b) fused=False", atol=1e-6, btol=1e-6, fused=False)
    body = iterations_run(int(res_d.itn), seg)
    check(int(res_d.istop) == istop_b and abs(int(res_d.itn) - itn_b) <= 2,
          "packed fused=False: istop/itn differ")
    check(delta["dia_matvec"] == 2 * body + 1 and delta["dia_pair"] == 0,
          f"packed fused=False: expected two products per iteration run: {delta}")
    check(rel(res_d.x, res_b.x) <= 1e-4, "packed fused=False: x differs")
    out["solve_fused_false"] = dict(istop=int(res_d.istop), itn=int(res_d.itn),
                                    ms=secs * 1e3)

    log("  launch profile of the packed pair solve:")
    out["launch_profile"] = phase_launches(A, b)
    A = None

    # a band wider than the pair kernel's halo: two launches per pair
    mw, nw, ks = WIDE
    data, bw, _ = random_stripes(mw, nw, ks, dev, seed=107, boost=12.0)
    Aw = lt.dia_operator_device(mw, nw, ks, data)
    del data
    res_w, delta, secs = solve(f"wide band {ks} m=n={mw} (b)", op=Aw, rhs=bw,
                               atol=1e-6, btol=1e-6)
    body = iterations_run(int(res_w.itn), seg)
    check(int(res_w.istop) in (1, 2, 3), "wide band: bad stop")
    check(delta["dia_pair"] == 0 and delta["dia_matvec_axpy"] == body
          and delta["dia_matvec"] == body + 1,
          f"wide band: expected the two-launch pair route: {delta}")
    ratio = packed_optimality(Aw, bw, res_w.x)
    log(f"  wide band independent check {ratio:.3e}")
    check(ratio <= 1e-4, f"wide band: optimality check {ratio:.3e} > 1e-4")
    out["solve_wide"] = dict(istop=int(res_w.istop), itn=int(res_w.itn), ms=secs * 1e3,
                             optimality=ratio)
    return out


def phase_bf16(dev, m, x_f32, card, paths):
    """Phase 8: bf16 stripe storage on both layouts at m = n (2^23)."""
    import torch

    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    seg = lt.LSQROptions().loop_segment
    out = {}
    for label, build, pair, axpy, optimal in (
            ("packed", lt.dia_operator_device, "dia_pair[bf16]", "dia_matvec_axpy[bf16]",
             packed_optimality),
            ("shared", lt.dia_shared_operator, "dia_pair_shared[bf16]",
             "dia_product_shared_axpy[bf16]", shared_optimality)):
        A = build(m, m, OFFSETS, data, storage_dtype=torch.bfloat16)
        check(A.is_bf16_storage and A.prefers_pair and not A.prefers_fused,
              f"bf16 {label}: must prefer the pair and not the fused half-step")

        def solve(tag, **kw):
            res, delta, secs = timed_solve(A, b, f"bf16 {label} {tag}", card, **kw)
            paths.append(delta)
            return res, delta, secs

        kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
        solve("warm-up 64 iterations", **kw)
        res, delta, secs = solve("fixed 64 iterations", **kw)
        check(int(res.itn) == 64 and delta[pair] == 64, f"bf16 {label} fixed run: {delta}")
        ms_fixed = secs * 1e3 / 64

        res_b, delta, secs = solve("(b) atol=btol=1e-6", atol=1e-6, btol=1e-6)
        itn_b, istop_b = int(res_b.itn), int(res_b.istop)
        check(istop_b in (1, 2, 3), f"bf16 {label} (b) istop {istop_b}")
        check(delta[pair] == iterations_run(itn_b, seg) > 0,
              f"bf16 {label} (b): pair launches {delta[pair]} != itn + masked")
        ratio = optimal(A, b, res_b.x)  # against the bf16-rounded operator
        err = rel(res_b.x, x_f32)
        log(f"  bf16 {label} (b): independent check {ratio:.3e}; x rel diff to the f32 "
            f"solve {err:.3e}")
        check(ratio <= 1e-4, f"bf16 {label}: optimality check {ratio:.3e} > 1e-4")
        check(err <= 5e-2, f"bf16 {label}: x differs from the f32 x by {err:.3e}")

        # the half-step on bf16 stripes: not preferred, so forced
        res_c, delta, _ = solve("(b) fused=True, pair=False", atol=1e-6, btol=1e-6,
                                fused=True, pair=False)
        body = iterations_run(int(res_c.itn), seg)
        check(int(res_c.istop) == istop_b and abs(int(res_c.itn) - itn_b) <= 2,
              f"bf16 {label} half-steps: istop/itn differ")
        check(delta[axpy] == 2 * body and delta[pair] == 0,
              f"bf16 {label} half-steps: expected {2 * body} axpy launches: {delta}")
        log(f"  launch profile of the bf16 {label} pair solve:")
        out[label] = dict(ms_per_iteration_fixed64=ms_fixed, istop=istop_b, itn=itn_b,
                          ms=secs * 1e3, optimality=ratio, x_rel_to_f32=err,
                          itn_halfsteps=int(res_c.itn), launch_profile=phase_launches(A, b))
        del A
    return out

def mk_modules():
    """{solver: (its megakernel module, the counted call wrapper)}."""
    from lsqr_tpu_torch.ops import megakernel, megakernel_craig, megakernel_lsmr

    return {"lsqr": (megakernel, megakernel.lsqr_megakernel_call),
            "lsmr": (megakernel_lsmr, megakernel_lsmr.lsmr_megakernel_call),
            "craig": (megakernel_craig, megakernel_craig.craig_megakernel_call)}


def mk_pair(solver, A, b):
    """(kernel call, twin call, kernel vectors+state, twin vectors+state):
    one megakernel call of MK_K iterations from the solver's own setup, on
    two copies of it, so the kernel and its twin start equal."""
    mod, wrapper = mk_modules()[solver]
    kw = {} if solver == "craig" else dict(damp=DAMP)
    vectors, state = getattr(mod, f"{solver}_megakernel_prepare")(A, b, itnlim=10_000, **kw)
    mine = [t.clone() for t in (*vectors, state)]
    twin = [t.clone() for t in (*vectors, state)]
    args = dict(offsets=A.offsets, m=A.m, n=A.n, K=MK_K)
    plain = getattr(mod, f"{solver}_megakernel_plain")
    return (lambda: wrapper(A.data, A.tdata, *mine, offsets_t=A.offsets_t,
                            toffsets_t=A.toffsets_t, **args),
            lambda: plain(A.data, A.tdata, *twin, **args), mine, twin)


def phase_megakernels(dev, m, errs, card):
    """Phase 9: each megakernel against its twin on the card, one call of
    MK_K iterations from the same setup, and the route each call took (the
    staged phases' tile, 0 for the direct route; the grid; the stage
    bytes): the staged route at the main shape, the direct one at MK_FAR;
    at the ragged shape the direct route forced at the staged route's grid
    from the same state agrees within MK_TOL (its threads own other
    outputs, so its sums of squares round differently). Returns {variant:
    (kernel ms per call, twin ms per call)} at the main shape."""
    import torch

    import lsqr_tpu_torch as lt

    times = {}
    shapes = [(m, m, OFFSETS, (torch.float32, torch.bfloat16)),
              (MK_SIDE, MK_SIDE, (0, 1, 2, 3), (torch.float32,)),  # one-sided
              (MK_SIDE + 3, 3 * MK_SIDE // 4 + 5, OFFSETS, (torch.float32,)),  # ragged
              (MK_FAR[0], MK_FAR[0], MK_FAR[1], (torch.float32, torch.bfloat16))]
    for si, (mm, nn, ks, storages) in enumerate(shapes):
        data, b, g = random_stripes(mm, nn, ks, dev, seed=100 if si == 0 else 200 + si,
                                    boost=12.0)
        xt = torch.randn(nn, generator=g, device=dev)
        for storage in storages:
            A = lt.dia_operator_device(mm, nn, ks, data, storage_dtype=storage)
            sfx = "" if storage == torch.float32 else "[bf16]"
            for solver in ("lsqr", "lsmr", "craig"):
                rhs = A.matvec(xt) if solver == "craig" else b  # CRAIG: consistent
                kernel, plain, mine, twin = mk_pair(solver, A, rhs)
                start = [t.clone() for t in mine] if si == 2 else None
                state0 = mine[-1].clone()
                kernel()
                plain()
                torch.cuda.synchronize()
                name = f"{solver}_megakernel{sfx}"
                got, ref = mine[-1].double(), twin[-1].double()
                scale = ref.abs().clamp_min(1e-6)
                worst = float(((got - ref).abs() / scale).max())
                errs[name] = max(errs.get(name, 0.0), absdiff(got, ref))
                for a, r in zip(mine[:-1], twin[:-1]):
                    worst = max(worst, rel(a, r))
                    errs[name] = max(errs[name], absdiff(a, r))
                _, wrapper = mk_modules()[solver]
                log(f"  {name:24s} m={mm} n={nn} ks={ks[0]}..{ks[-1]} K={MK_K}: "
                    f"itn {int(mine[-1][{'lsqr': 15, 'lsmr': 23, 'craig': 7}[solver]])}, "
                    f"max rel err (state and vectors) {worst:.3e}; route: tile "
                    f"{wrapper.tile}, grid {wrapper.blocks} blocks x 256, "
                    f"{wrapper.stage_bytes} bytes of stages, {BARRIERS[solver]} grid "
                    f"barriers per iteration")
                check(worst <= MK_TOL, f"{name} disagrees with its twin: {worst:.3e}")
                far = (mm, ks) == MK_FAR
                check(bool(wrapper.tile) != far, f"{name} at m={mm}, ks={ks[0]}..{ks[-1]}: "
                      f"the {'staged' if far else 'direct'} route (tile {wrapper.tile})")
                if si == 2:  # the routes at one grid from one state
                    wrapper(A.data, A.tdata, *start, offsets=A.offsets, m=mm, n=nn, K=MK_K,
                            offsets_t=A.offsets_t, toffsets_t=A.toffsets_t,
                            _route=(0, wrapper.blocks))
                    torch.cuda.synchronize()
                    got, ref = start[-1].double(), mine[-1].double()
                    apart = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
                    for a, r in zip(start[:-1], mine[:-1]):
                        apart = max(apart, rel(a, r))
                    same = all(torch.equal(a, r) for a, r in zip(start, mine))
                    log(f"    {name}: the direct route at the staged route's grid: max rel "
                        f"diff (state and vectors) {apart:.3e}"
                        f"{' (the same bits)' if same else ''}")
                    check(apart <= MK_TOL, f"{name}: the staged and direct routes differ "
                          f"by {apart:.3e} at one grid")
                if si == 0:
                    # time calls from the same state (restored before each), so
                    # every call runs MK_K live iterations
                    def again(fn, st, s0=state0):
                        st.copy_(s0)
                        fn()
                    ms = time_ms(lambda: again(kernel, mine[-1]), reps=10)
                    plain_ms = time_ms(lambda: again(plain, twin[-1]), reps=2)
                    times[name] = (ms, plain_ms)
                    log(f"    {name}: kernel {ms:.4f} ms per call ({ms / MK_K:.4f} ms per "
                        f"iteration), twin {plain_ms:.4f} ms per call  [{card}]")
                del kernel, plain, mine, twin, start
            del A
        del data, b, xt
        torch.cuda.empty_cache()
    return times


def mk_solve(label, fn, A, b, card, paths, **kw):
    """One counted solve through ``fn`` (lsqr, lsmr, craig or cgls):
    (result, launches by variant, wall seconds)."""
    import torch

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(A, b, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (res, secs), delta = counted(run)
    paths.append(delta)
    check(bool(torch.isfinite(res.x).all()) and res.x.shape == (A.n,), f"{label}: bad x")
    launched = {k: v for k, v in delta.items() if v}
    log(f"  {label}: istop={int(res.istop)} itn={int(res.itn)} wall={secs * 1e3:.3f} ms "
        f"({secs * 1e3 / max(int(res.itn), 1):.4f} ms/iteration incl. setup, {card}) "
        f"launches={launched}")
    return res, delta, secs


def phase_mk_solves(dev, m, card, paths):
    """Phase 10: megakernel solves against the regular path on the card,
    the fixed-length timing with and without the megakernel, and CGLS."""
    import torch

    import lsqr_tpu_torch as lt

    out = {}
    data, b, g = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    xt = torch.randn(m, generator=g, device=dev)
    for storage in (torch.float32, torch.bfloat16):
        A = lt.dia_operator_device(m, m, OFFSETS, data, storage_dtype=storage)
        sfx = "" if storage == torch.float32 else "[bf16]"
        bc = A.matvec(xt)
        for solver, fn, rhs, kw in (
                ("lsqr", lt.lsqr, b, dict(damp=DAMP)),
                ("lsmr", lt.lsmr, b, dict(damp=DAMP)),
                ("craig", lt.craig, bc, {})):
            kw.update(atol=1e-6, btol=1e-6)
            ref, delta, _ = mk_solve(f"{solver}{sfx} regular", fn, A, rhs, card, paths, **kw)
            pair = "dia_pair" + sfx
            check(delta[pair] > 0, f"{solver}{sfx} regular: no {pair} launches {delta}")
            res, delta, secs = mk_solve(f"{solver}{sfx} megakernel=True", fn, A, rhs, card,
                                        paths, megakernel=True, **kw)
            name = f"{solver}_megakernel{sfx}"
            check(delta[name] > 0 and delta[pair] == 0,
                  f"{solver}{sfx}: megakernel=True must launch {name} only: {delta}")
            err = rel(res.x, ref.x)
            log(f"    x rel diff to the regular path {err:.3e}; {delta[name]} launches")
            check(int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 1,
                  f"{solver}{sfx} megakernel: istop/itn differ from the regular path")
            check(err <= 1e-3, f"{solver}{sfx} megakernel: x differs by {err:.3e}")
            entry = dict(istop=int(res.istop), itn=int(res.itn), itn_regular=int(ref.itn),
                         ms=secs * 1e3, x_rel_to_regular=err)
            if solver == "lsqr":
                ratio = packed_optimality(A, b, res.x)
                log(f"    independent check (f64, twins) {ratio:.3e}")
                check(ratio <= 1e-4, f"lsqr{sfx} megakernel: optimality {ratio:.3e}")
                entry["optimality"] = ratio
            out[f"{solver}{sfx}"] = entry
        del A
    torch.cuda.empty_cache()

    # CGLS on the f32 packed operator, regular and pair=True
    A = lt.dia_operator_device(m, m, OFFSETS, data)
    for label, kw, kernel in (("cgls regular", {}, "dia_matvec"),
                              ("cgls pair=True", dict(pair=True), "dia_pair")):
        res, delta, secs = mk_solve(label, lt.cgls, A, b, card, paths, damp=DAMP,
                                    atol=1e-6, btol=1e-6, **kw)
        ratio = packed_optimality(A, b, res.x)
        log(f"    independent check {ratio:.3e}")
        check(int(res.istop) in (1, 2) and delta[kernel] > 0, f"{label}: {delta}")
        check(ratio <= 1e-4, f"{label}: optimality {ratio:.3e} > 1e-4")
        out[label.replace(" ", "_")] = dict(istop=int(res.istop), itn=int(res.itn),
                                            ms=secs * 1e3, optimality=ratio)
    del A, data, b, xt
    torch.cuda.empty_cache()

    # fixed 64 iterations with and without the megakernel, at 2^23 and 2^19;
    # lsqr(megakernel=True) runs K iterations a launch, K the default of
    # lsqr_megakernel's iters_per_call
    k_call = inspect.signature(lt.lsqr_megakernel).parameters["iters_per_call"].default
    for mm in (m, M_SMALL):
        data, b, _ = random_stripes(mm, mm, OFFSETS, dev, seed=100, boost=12.0)
        A = lt.dia_operator_device(mm, mm, OFFSETS, data)
        del data
        row = {}
        for label, extra, own in (("regular", {}, None),
                                  ("megakernel", dict(megakernel=True),
                                   ("lsqr_megakernel", k_call))):
            kw = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65, **extra)
            mk_solve(f"m=n={mm} {label} warm-up 64 iterations", lt.lsqr, A, b, card, paths,
                     damp=DAMP, **kw)
            res, delta, secs = mk_solve(f"m=n={mm} {label} fixed 64 iterations", lt.lsqr, A,
                                        b, card, paths, damp=DAMP, **kw)
            check(int(res.itn) == 64, f"fixed run {label}: itn {int(res.itn)} != 64")
            log(f"  launch profile, m=n={mm} {label}:")
            row[label] = dict(ms_per_iteration=secs * 1e3 / 64,
                              launch_profile=phase_launches(A, b, own, **extra))
        out[f"fixed64_m{mm}"] = row
        del A, b
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 11-13: general sparsity
# ---------------------------------------------------------------------------


def coo_on(dev, vals, rows, cols):
    """COO triplets (numpy) as tensors on the card: (rows, cols, vals)."""
    import torch

    return (torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev))


def coo_optimality(coo, m, n, b, x):
    """:func:`optimality` from the COO triplets on the card, in f64."""
    import torch

    r_, c_, v_ = coo
    v64 = wide(v_)

    def forward(x64):
        return torch.zeros(m, dtype=v64.dtype, device=x64.device).index_add_(
            0, r_, v64 * x64[c_])

    def adjoint(r64):
        return torch.zeros(n, dtype=v64.dtype, device=r64.device).index_add_(
            0, c_, v64.conj() * r64[r_])

    return optimality(forward, adjoint, v64.norm(), b, x)


def jdia_calls(A, x, y):
    """[(kernel call, twin call)] of jdia_matvec on both packings of A."""
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    out = []
    for data, eoff, base, vec, p_lo, m_out in (
            (A.data, A.eoff, A.base, x, A.p_lo, A.m),
            (A.tdata, A.teoff, A.tbase, y, A.tp_lo, A.n)):
        kw = dict(m=m_out, p_lo=p_lo, tm=A.tm)
        out.append((lambda a=(data, eoff, base, vec), kw=kw: sp.jdia_matvec(*a, **kw),
                    lambda a=(data, eoff, base, vec), kw=kw: sp.jdia_matvec_plain(*a, **kw)))
    return out


def fits_window(blocks):
    """Whether a packing's block rows fit the windowed kernel's window."""
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    mb, kb, _, bw = blocks.shape
    return sp.windowed_rows_per_tile(mb, kb, bw) > 0


def bell_calls(A, x, y, c1, c2):
    """{kernel: [(kernel call, twin call)]} of the three BlockELL kernels on
    A's packings (x, y padded to the packings); the windowed kernel on the
    packings that fit its window."""
    from lsqr_tpu_torch.ops import spmv_sparse as sp

    sides = ((A.blocks, A.bcols, x), (A.tblocks, A.tbrows, y))
    return {
        "block_ell_matvec": [(lambda a=a: sp.block_ell_matvec(*a),
                              lambda a=a: sp.block_ell_matvec_plain(*a)) for a in sides],
        "block_ell_matvec_windowed": [(lambda a=a: sp.block_ell_matvec_windowed(*a),
                                       lambda a=a: sp.block_ell_matvec_plain(*a))
                                      for a in sides if fits_window(a[0])],
        "block_ell_pair_windowed": [
            (lambda: sp.block_ell_pair_windowed(A.blocks, A.bcols, x, y, c1, c2),
             lambda: sp.block_ell_pair_plain(A.blocks, A.bcols, x, y, c1, c2))],
    }


def padded_vectors(dev, A, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    nb, mb = A.tblocks.shape[0], A.blocks.shape[0]
    return (torch.randn(nb * A.bw, generator=g, device=dev),
            torch.randn(mb * A.bh, generator=g, device=dev))


def phase_general_kernels(dev, errs, card):
    """Phase 11: jdia_matvec and the three BlockELL kernels against their
    twins at their solve shapes and at ragged ones. Returns (perf entries,
    the 2^22 JDIA operator and its triplets, the 2^18 and the tall BlockELL
    operators and their triplets)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch import native
    from lsqr_tpu_torch.models.synthetic import jittered_band_coo, random_block_coo

    log(f"  host packer: {'g++-built native library' if native.available() else 'numpy fallback'}"
        f" ({native.library_path().name if native.available() else '-'})")
    perf = {}
    g = torch.Generator(device=dev).manual_seed(11)

    # jdia_matvec at 2^22 (through auto_operator, as phase 12 solves it) and ragged
    jdia = None
    for m, n, seed in ((M_JDIA, M_JDIA, 11), (*JDIA_RAGGED, 12)):
        t0 = time.perf_counter()
        trip = jittered_band_coo(m, n, diag=12.0, seed=seed)
        t1 = time.perf_counter()
        A = (lt.auto_operator if m == M_JDIA else lt.jdia_operator)(m, n, *trip, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(isinstance(A, lt.JDIAOperator), f"JDIA pattern packed as {type(A).__name__}")
        dev_mb = sum(t.numel() * t.element_size() for t in (
            A.data, A.eoff, A.base, A.tdata, A.teoff, A.tbase, A.rem_vals, A.rem_rows,
            A.rem_cols)) / 1e6
        log(f"  JDIA m={m} n={n}: {len(trip[0])} entries made in {t1 - t0:.2f} s, packed "
            f"in {t2 - t1:.2f} s (host); ns={A.ns} forward, {A.tdata.shape[0]} adjoint "
            f"slots, tm={A.tm}, fit {A.fit_fraction:.6f} ({A.rem_vals.numel()} in the "
            f"remainder), {dev_mb:.0f} MB on the card")
        x = torch.randn(n, generator=g, device=dev)
        y = torch.randn(m, generator=g, device=dev)
        calls = jdia_calls(A, x, y)
        hold({"jdia_matvec": calls}, errs, m, n, range(A.ns), TOL)
        if m == M_JDIA:
            csr = csr_of(*coo_on(dev, *trip), m, n)
            nbytes = (A.data.numel() * 4 + A.eoff.numel() + A.base.numel() * 4
                      + n * 4 + m * 4)
            perf["jdia_matvec"] = perf_entry(
                time_ms(calls[0][0]), time_ms(calls[0][1], reps=3), nbytes,
                2 * A.data.numel(), library_ms=library_ms(csr, x, A.matvec(x)))
            report("jdia_matvec", perf["jdia_matvec"], card)
            del csr
            jdia = (A, trip)
        del A, calls, x, y
        torch.cuda.empty_cache()

    # the BlockELL kernels at 2^18, ragged, and tall (the transpose packing
    # overflows the windowed kernel's window)
    bell = {}
    c1 = torch.tensor(0.8, device=dev)
    c2 = torch.tensor(1.1, device=dev)
    for m, n, seed in ((M_BELL, M_BELL, 13), (*BELL_RAGGED, 14), (*BELL_TALL, 15)):
        t0 = time.perf_counter()
        trip = random_block_coo(m, n, diag=2.0, seed=seed)
        t1 = time.perf_counter()
        A = lt.block_ell_operator(m, n, *trip, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"  BlockELL m={m} n={n}: {len(trip[0])} entries made in {t1 - t0:.2f} s, "
            f"packed in {t2 - t1:.2f} s (host); kb={A.kb} kt={A.kt}; blocks "
            f"{A.blocks.numel() * 4 / 1e6:.0f} MB, tblocks {A.tblocks.numel() * 4 / 1e6:.0f} MB "
            f"on the card; the windowed kernel takes the forward packing: "
            f"{fits_window(A.blocks)}, the transpose: {fits_window(A.tblocks)}")
        if (m, n) == BELL_TALL:
            check(fits_window(A.blocks) and not fits_window(A.tblocks),
                  f"the tall pattern's transpose (kt={A.kt}) must overflow the window")
        x, y = padded_vectors(dev, A, seed)
        calls = bell_calls(A, x, y, c1, c2)
        hold(calls, errs, m, n, range(A.kb), TOL)
        for name in ("block_ell_matvec", "block_ell_matvec_windowed"):
            for kernel, _ in calls[name]:  # slices added in a fixed order
                check(torch.equal(kernel(), kernel()),
                      f"{name} m={m} n={n}: two calls give different bits")
        pair = calls["block_ell_pair_windowed"][0][0]  # ranks added in a fixed order
        check(all(torch.equal(a, b) for a, b in zip(pair(), pair())),
              f"block_ell_pair_windowed m={m} n={n}: two calls give different bits")
        log(f"  BlockELL m={m} n={n}: both products and the pair bit-equal over two calls")
        if m == M_BELL or (m, n) == BELL_TALL:
            perf.update(bell_perf(A, trip, calls, x, y, errs, card, (c1, c2)))
        if (m, n) in ((M_BELL, M_BELL), BELL_TALL):
            bell[m, n] = (A, trip)
        del A, calls, x, y
        torch.cuda.empty_cache()
    return perf, jdia, bell


#: the BlockELL packings timed apart from their kernel's own row (phase 11),
#: by (pattern, product, kernel): the 2^18 transpose (kt = 10), the tall
#: forward and transpose packings
BELL_PACKINGS = {
    ((M_BELL, M_BELL), "rmatvec", "block_ell_matvec_windowed"):
        "block_ell_matvec_windowed[kt10]",
    (BELL_TALL, "matvec", "block_ell_matvec_windowed"): "block_ell_matvec_windowed[tall]",
    (BELL_TALL, "rmatvec", "block_ell_matvec"): "block_ell_matvec[tall_t]",
}


def bell_perf(A, trip, calls, x, y, errs, card, pair_scalars):
    """Perf entries of the BlockELL kernels on A's packings: at 2^18 the two
    products at the forward packing (their own rows), the windowed one at
    the transpose (kt = 10) and the pair; on the tall pattern the windowed
    product at the forward packing and block_ell_matvec at the transpose
    (kt = 164), the packings the solves take. Each with the bytes it must
    move and the CSR product of the same matrix (A, or A' for a transpose;
    the pair: CSR A @ x plus the CSR of A' @ u, ``pair_scalars`` its c1 and
    c2); a packing's row records its own error against the twin in
    ``errs``."""
    import torch

    dev = x.device
    m, n = A.m, A.n
    coo = coo_on(dev, *trip)
    sides = {"forward": (A.blocks, A.bcols, x, y, csr_of(*coo, m, n), x[:n], A.matvec),
             "transpose": (A.tblocks, A.tbrows, y, x, csr_of(coo[1], coo[0], coo[2], n, m),
                           y[:m], A.rmatvec)}

    def entry(name, call, side):
        blocks, index, vin, vout, csr, vec, product = sides[side]
        if "[" in name:
            errs[name] = absdiff(call[0](), call[1]())
        nbytes = (blocks.numel() + index.numel() + vin.numel() + vout.numel()) * 4
        out = perf_entry(time_ms(call[0]), time_ms(call[1], reps=3), nbytes,
                         2 * blocks.numel(),
                         library_ms=library_ms(csr, vec, product(vec)))
        report(name, out, card)
        return out

    win = calls["block_ell_matvec_windowed"]
    if A.m == M_BELL:
        perf = {"block_ell_matvec": entry("block_ell_matvec", calls["block_ell_matvec"][0],
                                          "forward"),
                "block_ell_matvec_windowed": entry("block_ell_matvec_windowed", win[0],
                                                   "forward"),
                "block_ell_matvec_windowed[kt10]": entry("block_ell_matvec_windowed[kt10]",
                                                         win[1], "transpose")}
        mb, kb = A.bcols.shape
        pair = calls["block_ell_pair_windowed"][0]
        # reads x and y, writes u (y's length) and zp
        io = (A.bcols.numel() + x.numel() + 2 * y.numel() + mb * kb * A.bw) * 4
        # the library: CSR A @ x, then the CSR of A' @ u (two calls)
        c1, c2 = pair_scalars
        u = pair[0]()[0][:m]
        parts = (library_ms(sides["forward"][4], x[:n] * c1, u + c2 * y[:m]),
                 library_ms(sides["transpose"][4], u, A.rmatvec(u)))
        perf["block_ell_pair_windowed"] = perf_entry(
            time_ms(pair[0]), time_ms(pair[1], reps=3), A.blocks.numel() * 4 + io,
            4 * A.blocks.numel(), library_ms=sum(parts))
        report("block_ell_pair_windowed", perf["block_ell_pair_windowed"], card)
        log(f"  library: two calls, CSR A @ x {parts[0]:.4f} ms plus the CSR of A' @ u "
            f"{parts[1]:.4f} ms")
        del u
    else:
        perf = {"block_ell_matvec_windowed[tall]": entry("block_ell_matvec_windowed[tall]",
                                                         win[0], "forward"),
                "block_ell_matvec[tall_t]": entry("block_ell_matvec[tall_t]",
                                                  calls["block_ell_matvec"][1], "transpose")}
    del sides
    torch.cuda.empty_cache()
    return perf


def phase_general_solves(dev, jdia, bell, card, paths):
    """Phase 12: solves on the phase-11 operators, and f64 JDIA against
    scipy."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import jittered_band_coo
    from lsqr_tpu_torch.ops import spmv_sparse

    out = {}
    seg = lt.LSQROptions().loop_segment
    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)

    A, trip = jdia
    check(A.fit_fraction >= 0.95, f"auto_operator's JDIA fit {A.fit_fraction} < 0.95")
    log(f"  auto_operator -> JDIAOperator, fit {A.fit_fraction:.6f}")
    coo = coo_on(dev, trip[0], trip[1], trip[2])
    b = torch.randn(A.m, generator=torch.Generator(device=dev).manual_seed(21), device=dev)
    res, delta, secs = timed_solve(A, b, f"JDIA m=n={A.m} (b) atol=btol=1e-6", card,
                                   atol=1e-6, btol=1e-6)
    paths.append(delta)
    body = iterations_run(int(res.itn), seg)
    check(int(res.istop) in (1, 2, 3), f"JDIA solve istop {int(res.istop)}")
    check(delta["jdia_matvec"] == 2 * body + 1,
          f"JDIA solve: expected two jdia_matvec launches per iteration run: {delta}")
    ratio = coo_optimality(coo, A.m, A.n, b, res.x)
    log(f"  JDIA independent check (f64, COO) {ratio:.3e}")
    check(ratio <= 1e-4, f"JDIA solve: optimality {ratio:.3e} > 1e-4")
    timed_solve(A, b, "JDIA warm-up 64 iterations", card, **fixed)
    res64, delta, secs64 = timed_solve(A, b, "JDIA fixed 64 iterations", card, **fixed)
    paths.append(delta)
    check(int(res64.itn) == 64, "JDIA fixed run: itn != 64")
    log("  launch profile of the JDIA solve:")
    out["jdia"] = dict(m=A.m, fit=A.fit_fraction, istop=int(res.istop), itn=int(res.itn),
                       ms=secs * 1e3, optimality=ratio,
                       ms_per_iteration_fixed64=secs64 * 1e3 / 64,
                       launch_profile=phase_launches(A, b))
    del A, coo, b, jdia, trip
    torch.cuda.empty_cache()

    # BlockELL: the 2^18 operator's products both through the windowed
    # kernel, and its pair; the tall operator's forward product through the
    # windowed kernel and its adjoint through block_ell_matvec
    runs = {}
    on_packing = dict.fromkeys(BELL_PACKINGS.values(), 0)
    products = (spmv_sparse.block_ell_matvec, spmv_sparse.block_ell_matvec_windowed)

    def counted_products(A):
        """Give A a matvec and an rmatvec that count the product launches
        they make by (product, kernel) into the tally they return."""
        tally = {(side, w.kernel_name): 0 for side in ("matvec", "rmatvec")
                 for w in products}

        def install(side):
            product = getattr(A, side)

            def run(v):
                before = [w.launches for w in products]
                out = product(v)
                for w, n in zip(products, before):
                    tally[side, w.kernel_name] += w.launches - n
                return out

            object.__setattr__(A, side, run)

        install("matvec")
        install("rmatvec")
        return tally

    def count_packings(label, key, tally, delta):
        """Set a counted solve's tally against its launch count, add its
        launches to the packings they ran on (``BELL_PACKINGS``), and zero
        the tally."""
        for w in products:
            k = w.kernel_name
            check(tally["matvec", k] + tally["rmatvec", k] == delta[k],
                  f"BlockELL {label}: the products counted {tally}, the solve {delta}")
        for (side, k), n in tally.items():
            packing = BELL_PACKINGS.get((key, side, k))
            if packing:
                on_packing[packing] += n
        tally.update(dict.fromkeys(tally, 0))

    for label, key, kw, kernels in (
            ("windowed", (M_BELL, M_BELL), {}, ("block_ell_matvec_windowed",)),
            ("pair=True", (M_BELL, M_BELL), dict(pair=True), ("block_ell_pair_windowed",)),
            ("tall", BELL_TALL, {}, ("block_ell_matvec_windowed", "block_ell_matvec"))):
        A, trip = bell[key]
        tally = counted_products(A)
        coo = coo_on(dev, trip[0], trip[1], trip[2])
        b = torch.randn(A.m, generator=torch.Generator(device=dev).manual_seed(22),
                        device=dev)
        res, delta, secs = timed_solve(A, b, f"BlockELL {A.m} x {A.n} {label} (b)", card,
                                       atol=1e-6, btol=1e-6, **kw)
        paths.append(delta)
        count_packings(label, key, tally, delta)
        body = iterations_run(int(res.itn), seg)
        # lsqr: one adjoint before the loop, one product each way per iteration
        expect = {("block_ell_pair_windowed",): (body,),
                  ("block_ell_matvec_windowed",): (2 * body + 1,),
                  ("block_ell_matvec_windowed", "block_ell_matvec"): (body, body + 1)}[kernels]
        got = tuple(delta[k] for k in kernels)
        check(got == expect, f"BlockELL {label}: expected {dict(zip(kernels, expect))} "
                             f"launches: {delta}")
        ratio = coo_optimality(coo, A.m, A.n, b, res.x)
        log(f"  BlockELL {label} (kb={A.kb}, kt={A.kt}) independent check (f64, COO) "
            f"{ratio:.3e}")
        check(ratio <= 1e-4, f"BlockELL {label}: optimality {ratio:.3e} > 1e-4")
        timed_solve(A, b, f"BlockELL {label} warm-up 64 iterations", card, **fixed, **kw)
        tally.update(dict.fromkeys(tally, 0))  # the warm-up is not a counted path
        res64, delta, secs64 = timed_solve(A, b, f"BlockELL {label} fixed 64 iterations",
                                           card, **fixed, **kw)
        paths.append(delta)
        count_packings(label, key, tally, delta)
        object.__delattr__(A, "matvec")
        object.__delattr__(A, "rmatvec")
        check(int(res64.itn) == 64, f"BlockELL {label} fixed run: itn != 64")
        log(f"  launch profile of the BlockELL {label} solve:")
        runs[label] = (res, dict(m=A.m, n=A.n, kb=A.kb, kt=A.kt, istop=int(res.istop),
                                 itn=int(res.itn), ms=secs * 1e3, optimality=ratio,
                                 ms_per_iteration_fixed64=secs64 * 1e3 / 64,
                                 launch_profile=phase_launches(A, b, **kw)))
        del A, trip, coo, b
    ref, res = runs["windowed"][0], runs["pair=True"][0]
    err = rel(res.x, ref.x)
    log(f"  BlockELL pair=True: istop {int(res.istop)} itn {int(res.itn)} against "
        f"{int(ref.istop)} {int(ref.itn)}; x rel diff {err:.3e}")
    check(int(res.istop) == int(ref.istop) and abs(int(res.itn) - int(ref.itn)) <= 1,
          "BlockELL pair=True: istop/itn differ from the windowed solve")
    check(err <= 1e-3, f"BlockELL pair=True: x differs by {err:.3e}")
    out["block_ell"] = {label: entry for label, (_, entry) in runs.items()}
    out["block_ell_packing_launches"] = on_packing
    del bell, runs, ref, res
    torch.cuda.empty_cache()

    # f64 JDIA at 2^16 against scipy: the twin on the card (no kernel)
    m = 2 ** 16
    vals, rows, cols = jittered_band_coo(m, m, diag=12.0, seed=23, dtype=np.float64)
    rhs = np.random.default_rng(23).standard_normal(m)
    S = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(m, m))
    tol = dict(atol=1e-10, btol=1e-10, conlim=1e8)
    ref = scipy.sparse.linalg.lsqr(S, rhs, damp=DAMP, iter_lim=2 * m, **tol)
    A = lt.auto_operator(m, m, vals, rows, cols, device=dev)
    check(isinstance(A, lt.JDIAOperator) and A.dtype == torch.float64,
          f"f64 JDIA pattern packed as {type(A).__name__} {A.dtype}")
    res, launched = counted(lambda: lt.lsqr(A, rhs, DAMP, itnlim=2 * m, **tol))
    paths.append(launched)
    err = float(np.abs(res.x.cpu().numpy() - ref[0]).max() / np.abs(ref[0]).max())
    istop_ref = scipy_istop(ref[1], DAMP > 0)
    log(f"  f64 JDIA m=n={m}: port istop={int(res.istop)} itn={int(res.itn)}; scipy "
        f"istop={ref[1]} (= {istop_ref}) itn={ref[2]}; x rel diff {err:.3e}")
    check(int(res.istop) == istop_ref and abs(int(res.itn) - ref[2]) <= 1,
          "f64 JDIA: istop/itn differ from scipy")
    check(err <= 1e-8, f"f64 JDIA: x differs from scipy by {err:.3e}")
    check(launched["jdia_matvec"] == 0 and res.x.dtype == torch.float64,
          "f64 JDIA must run the twin on the card")
    out["jdia_f64"] = dict(istop=int(res.istop), itn=int(res.itn), x_rel_to_scipy=err)
    return out


def phase_routes(dev, card, paths, kept):
    """Phase 13: the reordering planner, HYB, and step 3 on a tall pattern.
    The HYB operator and its triplets go to ``kept["hyb"]`` (phase 22)."""
    import numpy as np
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import jittered_band_coo, zipf_coo

    out = {}
    m = M_PLAN
    vals, rows, cols = jittered_band_coo(m, m, diag=12.0, seed=PLAN_SEED)
    rng = np.random.default_rng(PLAN_SEED)
    rp, cp = rng.permutation(m), rng.permutation(m)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(atol=1e-6, btol=1e-6)
    A0 = lt.auto_operator(m, m, vals, rows, cols, device=dev)
    res0, delta = counted(lambda: lt.lsqr(A0, b, DAMP, **kw))
    paths.append(delta)
    t0 = time.perf_counter()
    plan = lt.plan_general(m, m, vals, rp[rows], cp[cols], device=dev)
    t_plan = time.perf_counter() - t0
    check(isinstance(plan.op, lt.JDIAOperator) and plan.op.fit_fraction >= 0.95
          and not np.array_equal(plan.row_order, np.arange(m)),
          f"plan_general chose {type(plan.op).__name__} without reordering it to JDIA")
    b_scr = np.empty_like(b)
    b_scr[rp] = b
    res, delta = counted(lambda: plan.solve(b_scr, DAMP, **kw))
    paths.append(delta)
    check(delta["jdia_matvec"] > 0, f"the planned solve launched no jdia_matvec: {delta}")
    err = rel(res.x[torch.from_numpy(cp).to(dev)], res0.x)
    log(f"  plan_general m=n={m} scrambled: {type(plan.op).__name__} fit "
        f"{plan.op.fit_fraction:.6f} in {t_plan:.2f} s; istop {int(res.istop)} itn "
        f"{int(res.itn)} against the unscrambled {int(res0.istop)} {int(res0.itn)}; x "
        f"rel diff mapped back {err:.3e}")
    check(int(res.istop) == int(res0.istop), "the planned solve stops otherwise")
    check(err <= 1e-4, f"the planned solve's x differs by {err:.3e}")
    out["plan_general"] = dict(fit=plan.op.fit_fraction, seconds=t_plan, itn=int(res.itn),
                               itn_unscrambled=int(res0.itn), x_rel=err)
    del A0, plan, res, res0
    torch.cuda.empty_cache()

    m = M_ZIPF
    trip = zipf_coo(m, m, seed=32)
    t0 = time.perf_counter()
    A = lt.auto_operator(m, m, *trip, device=dev)
    t_pack = time.perf_counter() - t0
    check(isinstance(A, lt.SumOperator) and [type(op).__name__ for op in A.ops]
          == ["ELLOperator", "COOOperator"], f"the Zipf pattern went to {type(A).__name__}")
    b = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(32), device=dev)
    res, delta, secs = timed_solve(A, b, f"HYB m=n={m} (b)", card, **kw)
    paths.append(delta)
    ratio = coo_optimality(coo_on(dev, *trip), m, m, b, res.x)
    log(f"  Zipf m=n={m}: {len(trip[0])} entries -> HYB (ELL width "
        f"{A.ops[0].vals.shape[1]}, {A.ops[1].nnz} spilled) in {t_pack:.2f} s; "
        f"istop {int(res.istop)} itn {int(res.itn)}; independent check {ratio:.3e}")
    check(int(res.istop) in (1, 2, 3) and ratio <= 1e-4, f"HYB solve: {ratio:.3e}")
    out["hyb"] = dict(nnz=len(trip[0]), width=A.ops[0].vals.shape[1], spilled=A.ops[1].nnz,
                      istop=int(res.istop), itn=int(res.itn), ms=secs * 1e3,
                      optimality=ratio)
    kept["hyb"] = (A, trip)
    del A
    torch.cuda.empty_cache()

    # tall unstructured f32 at 2^16 x 2^12: 8 entries per row overflow the
    # WCOO packer's VMEM guard (HYB, as in JAX); 4 per row take step 3's WCOO
    m, n = 2 ** 16, 2 ** 12
    r = np.random.default_rng(33)
    for per_row, expected in ((8, "SumOperator"), (4, "WCOOOperator")):
        rows, cols = r.integers(0, m, per_row * m), r.integers(0, n, per_row * m)
        vals = r.standard_normal(per_row * m).astype(np.float32)
        A = lt.auto_operator(m, n, vals, rows, cols, device=dev)
        check(type(A).__name__ == expected,
              f"tall {per_row}/row pattern went to {type(A).__name__}, not {expected}")
    b = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(33), device=dev)
    res, delta, secs = timed_solve(A, b, f"tall unstructured f32 {m} x {n} -> WCOO (b)", card,
                                   **kw)
    paths.append(delta)
    ratio = coo_optimality(coo_on(dev, vals, rows, cols), m, n, b, res.x)
    log(f"  tall {m} x {n}: 8 per row -> HYB, 4 per row -> WCOO; istop {int(res.istop)} itn "
        f"{int(res.itn)}; independent check {ratio:.3e}")
    check(int(res.istop) in (1, 2, 3) and ratio <= 1e-4, f"tall WCOO solve: {ratio:.3e}")
    check(delta["wcoo_pair"] > 0, f"the tall WCOO solve launched no wcoo_pair: {delta}")
    out["tall_wcoo"] = dict(istop=int(res.istop), itn=int(res.itn), ms=secs * 1e3,
                            optimality=ratio)
    return out


# ---------------------------------------------------------------------------
# Phases 14-15: unstructured sparsity (WCOO, WWCOO, RWCOO)
# ---------------------------------------------------------------------------


def coo_calls(p, wide, x, y, c1):
    """{wrapper: [(kernel call, twin call)]} of one packing's three kernels:
    the forward with c2 = 0.3 and with c2 = -1 (RWCOO's fold of the hot
    part), the adjoint of y, the pair. The scalars are device tensors, as
    the solvers pass them (a Python number costs a copy to the card that
    waits, which would show in the kernels' times)."""
    import torch

    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    c2s = [torch.tensor(c, device=x.device) for c in (0.3, -1.0)]

    pre = "wwcoo" if wide else "wcoo"
    fwd, adj, pair = (getattr(sw, f"{pre}_{s}") for s in ("forward", "adjoint", "pair"))
    fwd_p, adj_p, pair_p = (getattr(sw, f"{pre}_{s}_plain")
                            for s in ("forward", "adjoint", "pair"))
    return {
        f"{pre}_forward": [(lambda c2=c2: fwd(p, x, c1, c2, y),
                            lambda c2=c2: fwd_p(p, x, c1, c2, y)) for c2 in c2s],
        f"{pre}_adjoint": [(lambda: adj(p, y), lambda: adj_p(p, y))],
        f"{pre}_pair": [(lambda: pair(p, y, x, c1, c2s[0]),
                         lambda: pair_p(p, y, x, c1, c2s[0]))],
    }


def coo_bytes(p, wide, name):
    """Bytes a call must move: 8 per padded slot of each entry copy it reads
    (row-sorted for the forward, column-sorted for the adjoint, both for the
    pair), gpe where it reads the row ends, WWCOO's colmap, the f32 vectors
    (x, y and u for the forward, u and z for the adjoint, all four for the
    pair)."""
    slots = p.nc * p.eb * 1024
    table = p.nc * p.js * 128 * 4 if wide else 0
    fwd = 8 * slots + p.nc * 16384 * 4 + 4 * (p.n + 2 * p.m)
    adj = 8 * slots + 4 * (p.m + p.n)
    return table + {"forward": fwd, "adjoint": adj, "pair": fwd + 8 * slots + 4 * p.n}[
        name.split("_")[1]]


def coo_perf(calls, p, wide, library, card):
    """Perf entries of one packing's three kernels (their first call)."""
    perf = {}
    for name, pairs in calls.items():
        perf[name] = perf_entry(
            time_ms(pairs[0][0]), time_ms(pairs[0][1], reps=3), coo_bytes(p, wide, name),
            2 * p.nc * p.eb * 1024 * (2 if name.endswith("pair") else 1),
            library_ms=library.get(name.split("_")[1]))
        report(name, perf[name], card)
    return perf


def bit_stable(label, p, wide, x, y, c1):
    """The adjoint and pair twice on the same inputs: z and u must be the
    same bits (neither adjoint adds with atomics: WCOO sums fixed partials
    in a fixed order, WWCOO expands each chunk's compacted z in chunk
    order)."""
    import torch

    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    pre = "wwcoo" if wide else "wcoo"
    adj, pair = getattr(sw, f"{pre}_adjoint"), getattr(sw, f"{pre}_pair")
    z1, z2 = adj(p, y), adj(p, y)
    (u1, w1), (u2, w2) = (pair(p, y, x, c1, 0.3) for _ in range(2))
    torch.cuda.synchronize()
    same = [torch.equal(z1, z2), torch.equal(w1, w2), torch.equal(u1, u2)]
    log(f"  {label}: {pre}_adjoint z, {pre}_pair z and u over two calls bit-equal: {same}")
    check(all(same), f"{label}: the {pre} adjoint or pair differs between two calls: {same}")


def wwcoo_design_bytes(p):
    """(the WWCOO adjoint's plan, the bytes its design moves): the column-
    sorted copy (8 per slot), u, the partials written and the listed ones
    read back (one float per split a list entry), the inverse lists, z."""
    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    plan = sw.wwcoo_adjoint_plan(p.vals.device.index, p.js * 128, p.eb, p.nc)
    splits, pairs = plan[3], p.zsrc.numel()
    moved = (8 * p.nc * p.eb * 1024 + 4 * p.m + 4 * p.nc * splits * p.js * 128
             + 4 * pairs * splits + 4 * (pairs + p.n + 1) + 4 * p.n)
    return plan, moved


def stored_bytes(A):
    """Bytes the operator holds on the card: (the kernels' arrays, all of
    it with the COO triplets)."""
    packs = [A.packed] if hasattr(A, "packed") else [A.hot] + ([A.cold] if A.cold else [])
    kernels = sum(p.device_bytes() for p in packs)
    c = A.coo  # the triplets and their fixed-order sums by row and by column
    coo = sum(t.numel() * t.element_size() for t in (
        c.vals, c.rows, c.cols, *(getattr(g, f) for g in (c.by_row, c.by_col)
                                  for f in ("vals", "src", "offsets"))))
    return kernels, kernels + coo


def phase_wcoo_kernels(dev, errs, card):
    """Phase 14: the WCOO and WWCOO kernels against their twins at the JAX
    package's benchmark shapes (through ``auto_operator``, which must pick
    JAX's WCOO and RWCOO) and at ragged ones with duplicates and empty rows;
    ``torch.sparse_csr_tensor @ x`` (and the CSR of A' @ u) beside the
    products. Returns (perf entries, {label: (operator, triplets, pack s)})."""
    import numpy as np
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo

    perf, ops = {}, {}
    g = torch.Generator(device=dev).manual_seed(14)
    c1 = torch.tensor(0.8, device=dev)
    cases = (("wcoo", ZIPF_M, ZIPF_N, ZIPF_NNZ, 0), ("rwcoo", ZIPF_M, ZIPF_WIDE_N, ZIPF_NNZ, 0),
             ("wcoo ragged", *WCOO_RAGGED, 400_000, 15),
             ("rwcoo ragged", *RWCOO_RAGGED, 400_000, 16))
    for label, m, n, nnz, seed in cases:
        t0 = time.perf_counter()
        trip = zipf_column_coo(m, n, nnz, seed=seed)
        if "ragged" in label:  # an empty band of rows, and duplicates
            vals, rows, cols = trip
            rows = np.where((rows > m // 3) & (rows < m // 3 + 1000), rows - 1000, rows)
            rows[-1000:], cols[-1000:] = rows[:1000], cols[:1000]
            trip = (vals, rows, cols)
        t1 = time.perf_counter()
        A = lt.auto_operator(m, n, *trip, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        expected = "WCOOOperator" if label.startswith("wcoo") else "RWCOOOperator"
        check(type(A).__name__ == expected, f"{label} {m} x {n} went to {type(A).__name__}")
        packs = ([("wcoo", A.packed, False)] if expected == "WCOOOperator"
                 else [("hot", A.hot, False), ("cold", A.cold, True)])
        kernel_b, total_b = stored_bytes(A)
        log(f"  {label} m={m} n={n}: {len(trip[0])} entries made in {t1 - t0:.2f} s, "
            f"auto_operator -> {expected} in {t2 - t1:.2f} s (step 2's JDIA attempt, the "
            f"pack and the move); "
            + "; ".join(f"{k}: n={p.n} nc={p.nc} eb={p.eb} slots={p.nc * p.eb * 1024}"
                        + (f" js={p.js} wc/wf/wu/wm/wz={p.wc}/{p.wf}/{p.wu}/{p.wm}/{p.wz}"
                           if wide else f" kb={p.kb} ku={p.ku}")
                        for k, p, wide in packs)
            + f"; on the card {kernel_b / len(trip[0]):.2f} B/entry for the kernels, "
            f"{total_b / len(trip[0]):.2f} with the COO triplets")
        library = {}
        if "ragged" not in label:
            r_, c_, v_ = coo_on(dev, *trip)
            csr, csr_t = csr_of(r_, c_, v_, m, n), csr_of(c_, r_, v_, n, m)
            x = torch.randn(n, generator=g, device=dev)
            y = torch.randn(m, generator=g, device=dev)
            library = {"forward": library_ms(csr, x, A.matvec(x)),
                       "adjoint": library_ms(csr_t, y, A.rmatvec(y))}
            log(f"  {label}: CSR {library['forward']:.4f} ms, CSR of A' "
                f"{library['adjoint']:.4f} ms")
            del csr, csr_t, r_, c_, v_
            if expected == "RWCOOOperator":  # the cold stream's own CSR
                from lsqr_tpu_torch.ops import spmv_wcoo as sw

                cold = ~np.isin(trip[2], A.hotmap.cpu().numpy())
                r_, c_, v_ = coo_on(dev, *(a[cold] for a in trip))
                csr, csr_t = csr_of(r_, c_, v_, m, n), csr_of(c_, r_, v_, n, m)
                x0 = x.new_zeros(0)
                library = {"forward": library_ms(csr, x, sw.wwcoo_forward(A.cold, x, 1.0, 0.0,
                                                                          x0)),
                           "adjoint": library_ms(csr_t, y, sw.wwcoo_adjoint(A.cold, y))}
                log(f"  {label} cold stream ({int(cold.sum())} entries): CSR "
                    f"{library['forward']:.4f} ms, CSR of A' {library['adjoint']:.4f} ms")
                del csr, csr_t, r_, c_, v_
        for k, p, wide in packs:
            x = torch.randn(p.n, generator=g, device=dev)
            y = torch.randn(m, generator=g, device=dev)
            calls = coo_calls(p, wide, x, y, c1)
            hold(calls, errs, m, p.n, range(p.eb), COO_TOL)
            bit_stable(f"{label} {k}", p, wide, x, y, c1)
            if label in ("wcoo", "rwcoo") and k != "hot":
                perf.update(coo_perf(calls, p, wide, library, card))
            if wide and "ragged" not in label:
                plan, moved = wwcoo_design_bytes(p)
                ms = perf["wwcoo_adjoint"]["ms"]
                log(f"  wwcoo_adjoint plan (groups, window, windows, splits) {plan}, D_pad "
                    f"{p.js * 128}, {p.zsrc.numel()} (chunk, column) pairs: the design moves "
                    f"{moved / 1e6:.1f} MB ({moved / (ms * 1e6):.1f} GB/s)  [{card}]")
            if label == "rwcoo" and k == "hot":
                from lsqr_tpu_torch.ops import spmv_wcoo as sw

                ms = time_ms(lambda: sw.wcoo_adjoint(p, y))
                log(f"  rwcoo hot adjoint (wcoo_adjoint, n = {p.n}) {ms:.4f} ms  [{card}]")
                perf["rwcoo_hot_adjoint_ms"] = ms
            del calls, x, y
        if "ragged" not in label:
            t3 = time.perf_counter()  # the packer alone, on the host
            (lt.wcoo_operator if expected == "WCOOOperator" else lt.rwcoo_operator)(
                m, n, *trip, device="cpu")
            pack_s = time.perf_counter() - t3
            log(f"  {label}: the host packer alone {pack_s:.2f} s")
            ops[label] = (A, trip, pack_s)
        del A
        torch.cuda.empty_cache()
    # a WWCOO packing whose D_pad exceeds one block's shared memory: the
    # adjoint's position windows
    m, n, per_row, stride = WWCOO_BAND
    gen = np.random.default_rng(14)
    rows = np.repeat(np.arange(m), per_row)
    cols = rows * stride + np.argsort(gen.random((m, stride)), axis=1)[:, :per_row].ravel()
    A = lt.wwcoo_operator(m, n, gen.standard_normal(rows.size).astype(np.float32), rows, cols,
                          device=dev)
    p = A.packed
    plan, _ = wwcoo_design_bytes(p)
    log(f"  wwcoo band m={m} n={n}: D_pad {p.js * 128} ({p.js * 128 * 4} bytes a chunk), "
        f"adjoint plan (groups, window, windows, splits) {plan}")
    check(plan[2] > 1, f"the WWCOO band must need position windows: {plan}")
    x = torch.randn(n, generator=g, device=dev)
    y = torch.randn(m, generator=g, device=dev)
    hold(coo_calls(p, True, x, y, c1), errs, m, n, range(p.eb), COO_TOL)
    bit_stable("wwcoo band", p, True, x, y, c1)
    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    ms = time_ms(lambda: sw.wwcoo_adjoint(p, y))
    log(f"  wwcoo band adjoint {ms:.4f} ms  [{card}]")
    perf["wwcoo_band_adjoint_ms"] = ms
    del A, p, x, y
    torch.cuda.empty_cache()
    # the RWCOO pipeline end to end: one routed pair against the COO products
    A, trip, _ = ops["rwcoo"]
    coo = lt.coo_operator(A.m, A.n, *trip, device=dev)
    x = torch.randn(A.n, generator=g, device=dev)
    y = torch.randn(A.m, generator=g, device=dev)
    c2 = torch.tensor(0.3, device=dev)
    u, z = A.fused_pair(y=y, win=x, c1=c1, c2=c2)
    u_ref = coo.matvec(x) * c1 - 0.3 * y
    err = max(rel(u, u_ref), rel(z, coo.rmatvec(u_ref)))
    ms = time_ms(lambda: A.fused_pair(y=y, win=x, c1=c1, c2=c2))
    log(f"  RWCOO fused_pair (hot forward, cold pair, hot adjoint, hotmap gather and "
        f"scatter) {ms:.4f} ms, against the COO products {err:.3e}  [{card}]")
    check(err <= COO_TOL, f"the RWCOO pair disagrees with the COO products: {err:.3e}")
    perf["rwcoo_fused_pair_ms"] = ms
    return perf, ops


def objective(coo, m, n, b, x, damp):
    """||A x - b||^2 + damp^2 ||x||^2 in f64 from the COO triplets."""
    import torch

    r_, c_, v_ = coo
    x64 = x.double()
    ax = torch.zeros(m, dtype=torch.float64, device=x.device).index_add_(
        0, r_, v_.double() * x64[c_])
    return float((ax - b.double()).norm() ** 2 + damp ** 2 * x64.norm() ** 2)


def planted_faults(A):
    """Copies of a WCOO or RWCOO operator with a planted fault, each a wrong
    product: "chunk", the entries of one chunk of 16384 rows zeroed in both
    copies (a block of rows the kernels never ran); "subtile", one
    1024-slot subtile zeroed likewise; "bf16", the values rounded to bf16;
    for RWCOO "cold dropped", the operator without its cold stream."""
    import dataclasses

    def zeroed(p, sl):
        vals, vals_r = p.vals.clone(), p.vals_r.clone()
        vals[sl], vals_r[sl] = 0.0, 0.0
        return dataclasses.replace(p, vals=vals, vals_r=vals_r)

    def bf16(p):
        return dataclasses.replace(p, vals=p.vals.bfloat16().float(),
                                   vals_r=p.vals_r.bfloat16().float())

    def faults(p):
        t = p.nc // 2
        return {"chunk": zeroed(p, (t,)), "subtile": zeroed(p, (t, slice(0, 1024))),
                "bf16": bf16(p)}

    if hasattr(A, "packed"):
        return {k: dataclasses.replace(A, packed=p) for k, p in faults(A.packed).items()}
    hot, cold = faults(A.hot), faults(A.cold)
    out = {k: dataclasses.replace(A, hot=hot[k], cold=cold[k]) for k in hot}
    out["cold dropped"] = dataclasses.replace(A, cold=None)
    return out


def product_precision(A, coo, dev):
    """A check that sees the values' precision: the operator's matvec and
    rmatvec at three seeded vectors against the f64 triplets (max |error| /
    max |product|), within PRODUCT_TOL; the same operator with its values
    rounded to bf16 (``planted_faults``) must exceed it."""
    import torch

    r_, c_, v_ = coo
    v64 = v_.double()

    def worst(op):
        g = torch.Generator(device=dev).manual_seed(151)
        errs = []
        for _ in range(3):
            x = torch.randn(A.n, generator=g, device=dev)
            y = torch.randn(A.m, generator=g, device=dev)
            ref_f = torch.zeros(A.m, dtype=torch.float64, device=dev).index_add_(
                0, r_, v64 * x.double()[c_])
            ref_a = torch.zeros(A.n, dtype=torch.float64, device=dev).index_add_(
                0, c_, v64 * y.double()[r_])
            errs += [rel(op.matvec(x), ref_f), rel(op.rmatvec(y), ref_a)]
        return max(errs)

    sound, bf16 = worst(A), worst(planted_faults(A)["bf16"])
    log(f"  products against the f64 triplets at three vectors: {sound:.3e} (limit "
        f"{PRODUCT_TOL}); with bf16-rounded values {bf16:.3e}")
    check(sound <= PRODUCT_TOL, f"the products differ from the f64 triplets by {sound:.3e}")
    check(bf16 > PRODUCT_TOL, f"bf16-rounded values pass the product check: {bf16:.3e}")
    return dict(sound=sound, bf16=bf16)


def phase_wcoo_solves(dev, ops, card, paths):
    """Phase 15: damped solves on the two benchmark operators through their
    pair kernels, checked in f64 and against the same solve on the COO
    operator; fixed 64-iteration runs for the time and launches per
    iteration and the device's idle share."""
    import torch

    import lsqr_tpu_torch as lt

    out = {}
    seg = lt.LSQROptions().loop_segment
    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    tol = dict(atol=1e-6, btol=1e-6)
    for label, pair in (("wcoo", "wcoo_pair"), ("rwcoo", "wwcoo_pair")):
        A, trip, pack_s = ops[label]
        check(A.prefers_pair, f"{label}: the operator on the card must prefer the pair")
        coo_t = coo_on(dev, *trip)
        coo = lt.coo_operator(A.m, A.n, *trip, device=dev)
        b = torch.randn(A.m, generator=torch.Generator(device=dev).manual_seed(15),
                        device=dev)
        res, delta, secs = timed_solve(A, b, f"{label} {A.m} x {A.n} (b) atol=btol=1e-6",
                                       card, **tol)
        paths.append(delta)
        body = iterations_run(int(res.itn), seg)
        check(int(res.istop) in (1, 2, 3), f"{label} solve istop {int(res.istop)}")
        check(delta[pair] == body, f"{label}: expected one {pair} per iteration run: {delta}")
        ratio = coo_optimality(coo_t, A.m, A.n, b, res.x)
        check(ratio <= 1e-4, f"{label} solve: optimality {ratio:.3e} > 1e-4")
        # the same solve again: every kernel of both paths sums in a fixed
        # order, so it stops at the same itn with bit-equal x
        again = lt.lsqr(A, b, DAMP, **tol)
        rerun_equal = bool(torch.equal(again.x, res.x)) and int(again.itn) == int(res.itn)
        log(f"  {label}: a second solve gives {'bit-equal' if rerun_equal else 'different'} "
            f"x (itn {int(again.itn)} and {int(res.itn)})")
        check(rerun_equal, f"{label}: two solves on the same inputs give different x")
        del again
        # the same solve on the COO operator: both are answers to atol, and
        # their damped objectives agree. Their x do not, to 1e-3: the Zipf
        # columns' top singular value stands far from the rest, Golub-Kahan
        # loses orthogonality within a few iterations, and from then on the
        # f32 iterates depend on the summation order (PERF.md, Findings); they
        # agree over the first 2 iterations
        ref = lt.lsqr(coo, b, DAMP, **tol)
        err, coo_itn = rel(res.x, ref.x), int(ref.itn)
        phi, phi_ref = (objective(coo_t, A.m, A.n, b, x, DAMP) for x in (res.x, ref.x))
        phi_err = abs(phi - phi_ref) / phi_ref
        log(f"  {label} independent check (f64, COO) {ratio:.3e}; the COO operator's solve: "
            f"istop {int(ref.istop)} itn {coo_itn}, x rel diff {err:.3e}, damped "
            f"objective rel diff {phi_err:.3e} (limit {OBJ_TOL[label]})")
        check(phi_err <= OBJ_TOL[label], f"{label} solve: objective differs from the COO "
                                         f"solve's by {phi_err:.3e} > {OBJ_TOL[label]}")
        # the same solve on planted faults: the limit must be able to fail
        faults = {}
        for fault, B in planted_faults(A).items():
            res_f = lt.lsqr(B, b, DAMP, **tol)
            faults[fault] = dict(
                objective_rel_to_coo=abs(objective(coo_t, A.m, A.n, b, res_f.x, DAMP)
                                         - phi_ref) / phi_ref,
                optimality=coo_optimality(coo_t, A.m, A.n, b, res_f.x), itn=int(res_f.itn))
            del B, res_f
        log(f"  {label} planted faults, objective rel diff / optimality (itn): "
            + "; ".join(f"{k} {f['objective_rel_to_coo']:.3e} / {f['optimality']:.3e} "
                        f"({f['itn']})" for k, f in faults.items()))
        for fault in CAUGHT[label]:
            check(faults[fault]["objective_rel_to_coo"] > OBJ_TOL[label],
                  f"{label}: the planted fault {fault!r} passes the objective limit")
        timed_solve(A, b, f"{label} warm-up 64 iterations", card, **fixed)
        res64, delta, secs64 = timed_solve(A, b, f"{label} fixed 64 iterations", card, **fixed)
        paths.append(delta)
        check(int(res64.itn) == 64, f"{label} fixed run: itn != 64")
        errs_k = {}
        for k in (2, 8, 64):
            early = dict(fixed, itnlim=k, nconv=k + 1)
            x_k = res64.x if k == 64 else lt.lsqr(A, b, DAMP, **early).x
            errs_k[k] = rel(x_k, lt.lsqr(coo, b, DAMP, **early).x)
        log(f"  {label}: x against the COO operator's over the same 2, 8 and 64 iterations: "
            + ", ".join(f"{e:.3e}" for e in errs_k.values()))
        check(errs_k[2] <= 1e-3, f"{label}: x after 2 iterations differs from the COO "
                                 f"operator's by {errs_k[2]:.3e}")
        del coo, ref
        # pair=False: the separate products, one forward per iteration and
        # one adjoint more (Aᵀb before the loop)
        res_np, delta, _ = timed_solve(A, b, f"{label} pair=False 64 iterations", card,
                                       pair=False, **fixed)
        paths.append(delta)
        products = (("wcoo_forward", "wcoo_adjoint") if label == "wcoo" else
                    ("wcoo_forward", "wcoo_adjoint", "wwcoo_forward", "wwcoo_adjoint"))
        check(all(delta[k] == (64 if k.endswith("forward") else 65) for k in products)
              and delta[pair] == 0, f"{label} pair=False: expected one product each way per "
                                    f"iteration: {delta}")
        precision = product_precision(A, coo_t, dev)
        log(f"  launch profile of the {label} solve:")
        prof = phase_launches(A, b)
        wall = secs64 * 1e3 / 64
        kernel_b, total_b = stored_bytes(A)
        out[label] = dict(m=A.m, n=A.n, nnz=len(trip[0]), istop=int(res.istop),
                          itn=int(res.itn), ms=secs * 1e3, optimality=ratio,
                          x_rel_to_coo=err, coo_itn=coo_itn, x_bit_equal_rerun=rerun_equal,
                          objective_rel_to_coo=phi_err, planted_faults=faults,
                          x_rel_to_coo_fixed={str(k): e for k, e in errs_k.items()},
                          ms_per_iteration_fixed64=wall,
                          device_idle=1 - prof["kernel_ms_per_iteration"] / wall,
                          pack_seconds=pack_s, bytes_per_entry=kernel_b / len(trip[0]),
                          bytes_per_entry_with_coo=total_b / len(trip[0]),
                          product_precision=precision, launch_profile=prof)
        log(f"  {label}: {wall:.4f} ms/iteration, device idle {out[label]['device_idle']:.1%}")
        del A, coo_t, b
        ops.pop(label)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 16-17: complex problems (ZDIA, ZJDIA)
# ---------------------------------------------------------------------------


def complex_products(A, trip, x, y):
    """(rel error of A.matvec(x), of A.rmatvec(y)) against the complex128
    COO triplets (the conjugate for the adjoint), on the card."""
    import torch

    r_, c_, v_ = trip
    v128 = v_.to(torch.complex128)
    ref_f = torch.zeros(A.m, dtype=torch.complex128, device=v_.device).index_add_(
        0, r_, v128 * wide(x)[c_])
    ref_a = torch.zeros(A.n, dtype=torch.complex128, device=v_.device).index_add_(
        0, c_, v128.conj() * wide(y)[r_])
    return rel(A.matvec(x), ref_f), rel(A.rmatvec(y), ref_a)


def phase_complex_kernels(dev, errs, card):
    """Phase 16: zdia_pair against its twin at the JAX package's complex
    benchmark shape (2^21, 5 diagonals), a ragged rectangular shape (both
    the staged kernel, the same bits over two calls) and a +-1500 band at
    2^20 (two launches); the ZDIA products (four dia_matvec
    launches each) against the complex128 COO triplets; beside the pair,
    torch.sparse_csr_tensor's A @ x plus the CSR of A^H @ u (two calls)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import ZDIA_OFFSETS
    from lsqr_tpu_torch.ops import spmv

    perf = {}
    g = torch.Generator(device=dev).manual_seed(16)
    c1 = torch.tensor(0.8, device=dev)
    c2 = torch.tensor(1.1, device=dev)
    for si, (m, n, ks) in enumerate(((M_ZDIA, M_ZDIA, ZDIA_OFFSETS), ZDIA_RAGGED, WIDE)):
        stripes = lt.zdia_stripes(m, n, ks, seed=160 + si, device=dev, generator="torch")
        A = lt.dia_operator_device(m, n, ks, stripes)
        check(isinstance(A, lt.ZDIAOperator) and A.prefers_pair,
              f"complex stripes built {type(A).__name__}")
        y = torch.randn(m, generator=g, device=dev, dtype=torch.complex64)
        win = torch.randn(n, generator=g, device=dev, dtype=torch.complex64)
        kw = dict(offsets=ks, m=m, n=n)
        pair = (lambda: spmv.zdia_pair(A.dr, A.di, y, win, c1, c2, offsets_t=A.offsets_t,
                                       **kw),
                lambda: spmv.zdia_pair_plain(A.dr, A.di, y, win, c1, c2, **kw))
        (u, z), delta = counted(pair[0])
        lo, hi = spmv._halos(ks)
        tile = spmv.zpair_tile(len(ks), lo, hi, *spmv._smem_limits(dev)) \
            if max(lo, hi) <= spmv.PAIR_MAX_HALO else 0
        check(delta["zdia_pair"] == (1 if tile else 2) and sum(delta.values())
              == delta["zdia_pair"], f"zdia_pair m={m} n={n}: launches {delta}")
        check(si == 2 or tile > 0, f"zdia_pair m={m} n={n}: the staged kernel must take it")
        hold({"zdia_pair": [pair]}, errs, m, n, ks, TOL)
        u2, z2 = pair[0]()
        same = bool(torch.equal(u, u2) and torch.equal(z, z2))
        log(f"  zdia_pair m={m} n={n} nd={len(ks)}: "
            + (f"staged tiles of {tile}" if tile else "two launches")
            + f"; a second call bit-equal {same}")
        check(same, f"zdia_pair m={m} n={n}: a second call differs in u or z")
        del u2, z2
        trip = stripe_triplets(stripes, ks, m, n)
        (e_f, e_a), delta = counted(lambda: complex_products(A, trip, win, y))
        launched = {k: v for k, v in delta.items() if v}
        log(f"  ZDIA m={m} n={n} nd={len(ks)}: matvec and rmatvec against the complex128 "
            f"triplets {e_f:.3e}, {e_a:.3e}; launches {launched}")
        check(max(e_f, e_a) <= TOL and delta["dia_matvec"] == 8,
              f"ZDIA products m={m} n={n}: {e_f:.3e}, {e_a:.3e}, {delta}")
        if si == 0:
            r_, c_, v_ = trip
            csr, csr_t = csr_of(r_, c_, v_, m, n), csr_of(c_, r_, v_.conj(), n, m)
            lib = (library_ms(csr, win * c1, u + c2 * y), library_ms(csr_t, u, z))
            nbytes = 2 * len(ks) * m * 4 + 8 * (2 * m + 2 * n)
            perf["zdia_pair"] = perf_entry(time_ms(pair[0]), time_ms(pair[1], reps=5), nbytes,
                                           16 * len(ks) * m, library_ms=sum(lib))
            report("zdia_pair", perf["zdia_pair"], card)
            log(f"  library: two calls, complex64 CSR A @ x {lib[0]:.4f} ms plus the CSR of "
                f"A^H @ u {lib[1]:.4f} ms")
            del csr, csr_t
        del A, stripes, trip, y, win, u, z
        torch.cuda.empty_cache()
    return perf


def phase_complex_solves(dev, card, paths):
    """Phase 17: complex solves. The complex COO triplets of the benchmark
    shape (+12 on the diagonal) through auto_operator (ZDIA), a damped
    solve to 1e-6 through zdia_pair checked in complex128 and against
    scipy on the host, fixed 64 iterations with the launches and the
    device's idle share; lsmr, cgls (pair=True) and craig against their
    pair=False runs; complex128 at 2^16 against scipy; a ZJDIA solve at
    2^20 (phase 11's jittered pattern with complex values)."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import ZDIA_OFFSETS, jittered_band_coo

    out = {}
    seg = lt.LSQROptions().loop_segment
    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    tol = dict(atol=1e-6, btol=1e-6)
    m, ks = M_ZDIA, ZDIA_OFFSETS
    stripes = lt.zdia_stripes(m, m, ks, seed=17, diag=12.0, device=dev, generator="torch")
    trip = stripe_triplets(stripes, ks, m, m)
    del stripes
    rows, cols, vals = (t.cpu().numpy() for t in trip)
    t0 = time.perf_counter()
    A = lt.auto_operator(m, m, vals, rows, cols, device=dev)
    torch.cuda.synchronize()
    t_auto = time.perf_counter() - t0
    check(isinstance(A, lt.ZDIAOperator) and A.offsets == ks and A.prefers_pair
          and A.dtype == torch.complex64,
          f"auto_operator sent the complex banded triplets to {type(A).__name__}")
    log(f"  auto_operator -> ZDIAOperator ({len(vals)} complex64 entries) in {t_auto:.2f} s")
    b = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(171), device=dev,
                    dtype=torch.complex64)
    res, delta, secs = timed_solve(A, b, f"ZDIA m=n={m} (b) atol=btol=1e-6", card, **tol)
    paths.append(delta)
    body = iterations_run(int(res.itn), seg)
    check(int(res.istop) in (1, 2, 3), f"ZDIA solve istop {int(res.istop)}")
    check(delta["zdia_pair"] == body and delta["dia_matvec"] == 4,
          f"ZDIA solve: expected one zdia_pair per iteration run and A^H b: {delta}")
    check(res.x.dtype == torch.complex64 and res.rnorm.dtype == torch.float32,
          "the complex solve's x and estimates have the wrong dtypes")
    ratio = coo_optimality(trip, m, m, b, res.x)
    S = scipy.sparse.csr_matrix((vals.astype(np.complex128), (rows, cols)), shape=(m, m))
    rhs = b.cpu().numpy().astype(np.complex128)
    t0 = time.perf_counter()
    ref = scipy.sparse.linalg.lsqr(S, rhs, damp=DAMP, atol=1e-10, btol=1e-10,
                                   iter_lim=2 * m)
    t_scipy = time.perf_counter() - t0
    err = float(np.abs(res.x.cpu().numpy() - ref[0]).max() / np.abs(ref[0]).max())
    log(f"  ZDIA independent check (complex128, COO) {ratio:.3e}; scipy (complex128, host, "
        f"{t_scipy:.1f} s) istop {ref[1]} itn {ref[2]}: x rel diff {err:.3e}")
    check(ratio <= 1e-4, f"ZDIA solve: optimality {ratio:.3e} > 1e-4")
    check(err <= 1e-3, f"ZDIA solve: x differs from scipy's by {err:.3e}")
    del S
    timed_solve(A, b, "ZDIA warm-up 64 iterations", card, **fixed)
    res64, delta, secs64 = timed_solve(A, b, "ZDIA fixed 64 iterations", card, **fixed)
    paths.append(delta)
    check(int(res64.itn) == 64 and delta["zdia_pair"] == 64, "ZDIA fixed run: itn != 64")
    log("  launch profile of the ZDIA solve:")
    prof = phase_launches(A, b)
    wall = secs64 * 1e3 / 64
    out["zdia"] = dict(m=m, nnz=len(vals), auto_operator_s=t_auto, istop=int(res.istop),
                       itn=int(res.itn), ms=secs * 1e3, optimality=ratio, x_rel_to_scipy=err,
                       scipy_itn=int(ref[2]), ms_per_iteration_fixed64=wall,
                       device_idle=1 - prof["kernel_ms_per_iteration"] / wall,
                       launch_profile=prof)
    log(f"  ZDIA: {wall:.4f} ms/iteration, device idle {out['zdia']['device_idle']:.1%}")

    # the siblings through the pair kernel against their pair=False runs
    for name in ("lsmr", "cgls", "craig"):
        fn = getattr(lt, name)
        args = (A, b) if name == "craig" else (A, b, DAMP)
        kw = dict(tol, pair=True) if name == "cgls" else dict(tol)
        res_p, delta = counted(lambda: fn(*args, **kw))
        paths.append(delta)
        res_r = fn(*args, **dict(kw, pair=False))
        err = rel(res_p.x, res_r.x)
        log(f"  {name}: pair istop {int(res_p.istop)} itn {int(res_p.itn)} "
            f"(zdia_pair {delta['zdia_pair']}), pair=False istop {int(res_r.istop)} itn "
            f"{int(res_r.itn)}; x rel diff {err:.3e}")
        check(delta["zdia_pair"] > 0 and int(res_p.istop) == int(res_r.istop)
              and abs(int(res_p.itn) - int(res_r.itn)) <= 2 and err <= 1e-3,
              f"{name} through zdia_pair differs from its pair=False run")
        out[name] = dict(istop=int(res_p.istop), itn=int(res_p.itn),
                         itn_pair_false=int(res_r.itn), x_rel=err)
    del A, b, trip, rows, cols, vals
    torch.cuda.empty_cache()

    # complex128 at 2^16 against scipy: f64 planes, four dia_matvec[f64] a product
    m2 = 2 ** 16
    st = lt.zdia_stripes(m2, m2, ks, seed=172, diag=12.0, dtype=torch.complex128,
                         device="cpu").numpy()
    A2 = lt.dia_operator(m2, m2, ks, st, device=dev)
    r2, c2_, v2 = (t.cpu().numpy() for t in stripe_triplets(torch.from_numpy(st), ks, m2, m2))
    S2 = scipy.sparse.csr_matrix((v2, (r2, c2_)), shape=(m2, m2))
    g2 = np.random.default_rng(172)
    rhs2 = g2.standard_normal(m2) + 1j * g2.standard_normal(m2)
    tol2 = dict(atol=1e-10, btol=1e-10, conlim=1e8)
    ref2 = scipy.sparse.linalg.lsqr(S2, rhs2, damp=DAMP, iter_lim=2 * m2, **tol2)
    res2, launched = counted(lambda: lt.lsqr(A2, rhs2, DAMP, itnlim=2 * m2, **tol2))
    paths.append(launched)
    err2 = float(np.abs(res2.x.cpu().numpy() - ref2[0]).max() / np.abs(ref2[0]).max())
    istop_ref = scipy_istop(ref2[1], DAMP > 0)
    log(f"  complex128 ZDIA m=n={m2}: port istop={int(res2.istop)} itn={int(res2.itn)}; "
        f"scipy istop={ref2[1]} (= {istop_ref}) itn={ref2[2]}; x rel diff {err2:.3e}; "
        f"launches {({k: v for k, v in launched.items() if v})}")
    check(isinstance(A2, lt.ZDIAOperator) and res2.x.dtype == torch.complex128,
          "the complex128 solve left complex128")
    check(int(res2.istop) == istop_ref and abs(int(res2.itn) - ref2[2]) <= 1,
          "complex128 ZDIA: istop/itn differ from scipy")
    check(err2 <= 1e-8, f"complex128 ZDIA: x differs from scipy by {err2:.3e}")
    check(launched["dia_matvec[f64]"] > 0 and launched["zdia_pair"] == 0,
          "complex128 solves run unfused through the f64 product kernel")
    out["zdia_c128"] = dict(istop=int(res2.istop), itn=int(res2.itn), x_rel_to_scipy=err2)
    del A2, S2

    # ZJDIA at 2^20: phase 11's jittered pattern, complex values
    m3 = M_ZJDIA
    v3, r3, c3 = jittered_band_coo(m3, m3, diag=12.0, seed=173)
    v3 = (v3 + 1j * np.random.default_rng(174).standard_normal(len(v3))).astype(np.complex64)
    t0 = time.perf_counter()
    A3 = lt.auto_operator(m3, m3, v3, r3, c3, device=dev)
    t_auto3 = time.perf_counter() - t0
    check(isinstance(A3, lt.ZJDIAOperator) and A3.fit_fraction >= 0.95
          and A3.dtype == torch.complex64,
          f"the complex jittered pattern went to {type(A3).__name__}")
    log(f"  auto_operator -> ZJDIAOperator ({len(v3)} entries, fit {A3.fit_fraction:.6f}) "
        f"in {t_auto3:.2f} s")
    b3 = torch.randn(m3, generator=torch.Generator(device=dev).manual_seed(175), device=dev,
                     dtype=torch.complex64)
    res3, delta, secs3 = timed_solve(A3, b3, f"ZJDIA m=n={m3} (b) atol=btol=1e-6", card,
                                     **tol)
    paths.append(delta)
    body3 = iterations_run(int(res3.itn), seg)
    check(int(res3.istop) in (1, 2, 3), f"ZJDIA solve istop {int(res3.istop)}")
    check(delta["jdia_matvec"] == 4 * (2 * body3 + 1),
          f"ZJDIA solve: expected four jdia_matvec launches per product: {delta}")
    ratio3 = coo_optimality(coo_on(dev, v3, r3, c3), m3, m3, b3, res3.x)
    log(f"  ZJDIA independent check (complex128, COO) {ratio3:.3e}")
    check(ratio3 <= 1e-4, f"ZJDIA solve: optimality {ratio3:.3e} > 1e-4")
    out["zjdia"] = dict(m=m3, fit=A3.fit_fraction, istop=int(res3.istop),
                        itn=int(res3.itn), ms=secs3 * 1e3, optimality=ratio3)
    return out


# ---------------------------------------------------------------------------
# Phase 18: the streaming ceiling
# ---------------------------------------------------------------------------


def phase_roofline(dev, errs, card, paths):
    """Phase 18: ``stream_copy`` against its twin and ``x.mul_``, bit for
    bit, at ``bench.py``'s roofline shape (the one ``stream_ceiling`` gives
    it) and at a ragged length (the tail launch); ``stream_ceiling`` as a
    counted path; the kernel, its twin and ``x.mul_`` timed at that shape.
    The kernel and ``x.mul_`` are timed in STREAM_TURNS turns (their means
    go into the kernels line). Returns (perf entry, GB/s)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops import roofline

    g = torch.Generator(device=dev).manual_seed(18)
    for shape in ((roofline.ROWS, roofline.COLS), (1_000_003,)):
        x = torch.randn(shape, generator=g, device=dev)
        ref, lib = x.clone(), x.clone()
        for _ in range(3):
            lt.stream_copy(x)
            roofline.stream_copy_plain(ref)
            lib.mul_(roofline.SCALE)
        torch.cuda.synchronize()
        errs["stream_copy"] = max(errs.get("stream_copy", 0.0), absdiff(x, ref))
        same = torch.equal(x, ref) and torch.equal(x, lib)
        log(f"  stream_copy at {tuple(shape)}, 3 calls: bit-equal to its twin "
            f"{torch.equal(x, ref)}, to x.mul_ {torch.equal(x, lib)}")
        check(same, f"stream_copy disagrees with its twin or x.mul_ at {tuple(shape)}")
        del x, ref, lib
        torch.cuda.empty_cache()
    gbs, delta = counted(lambda: lt.stream_ceiling(dev))
    paths.append(delta)
    check(delta["stream_copy"] == roofline.K + 1 and sum(delta.values()) == roofline.K + 1,
          f"the ceiling's chain: expected {roofline.K + 1} stream_copy launches: {delta}")
    log(f"  streaming ceiling ({roofline.ROWS} x {roofline.COLS} f32, {roofline.K} chained "
        f"in-place copies): {gbs:.1f} GB/s, {gbs / (HBM_BYTES_PER_S / 1e9):.1%} of the data "
        f"sheet's {HBM_BYTES_PER_S / 1e9:.0f} GB/s  [{card}]")
    x = torch.randn((roofline.ROWS, roofline.COLS), generator=g, device=dev)
    turns = []  # the kernel and x.mul_ in turns: the two differ by well under 1%
    for turn in range(STREAM_TURNS):
        turns.append((time_ms(lambda: lt.stream_copy(x)),
                      time_ms(lambda: x.mul_(roofline.SCALE))))
        log(f"  turn {turn}: stream_copy {turns[-1][0]:.5f} ms, x.mul_ {turns[-1][1]:.5f} ms")
    copy_ms, mul_ms = (sum(t[i] for t in turns) / len(turns) for i in (0, 1))
    log(f"  stream_copy {copy_ms:.5f} ms, x.mul_ {mul_ms:.5f} ms (means of {len(turns)} "
        f"turns); the kernel at or under x.mul_ in {sum(c <= m for c, m in turns)} turns")
    entry = perf_entry(copy_ms, time_ms(lambda: roofline.stream_copy_plain(x)),
                       2 * x.numel() * 4, x.numel(), library_ms=mul_ms)
    report("stream_copy", entry, card)
    del x
    torch.cuda.empty_cache()
    return entry, gbs


# ---------------------------------------------------------------------------
# Phase 19: the operator algebra, preconditioning, I/O, the solver utilities,
# LSRN, refinement and hybrid regularization on the card
# ---------------------------------------------------------------------------


def shared_f64(A):
    """(forward, adjoint, ||A||_F) of a shared-stripe operator in f64, from
    its stripes through the plain twins."""
    from lsqr_tpu_torch.ops.spmv import dia_product_shared_plain

    dp64 = A.dp.double()
    kw = dict(offsets=A.offsets, m=A.m, n=A.n)
    return (lambda x: dia_product_shared_plain(dp64, x, adjoint=False, **kw),
            lambda r: dia_product_shared_plain(dp64, r, adjoint=True, **kw), dp64.norm())


def ls_ratio(forward, adjoint, fro, b, x, damp):
    """:func:`optimality` for damp > 0; for damp 0 on a square nonsingular
    A (a compatible system: r goes to 0 and the ratio loses its meaning)
    the smaller of LSQR's two stopping tests in f64, ||r|| / (||A||_F ||x||
    + ||b||) and ||A'r|| / (||A||_F ||r||) (lsqr.f90:786-810)."""
    if damp > 0:
        return optimality(forward, adjoint, fro, b, x, damp)
    x64 = wide(x)
    r = wide(b) - forward(x64)
    rn = r.norm()
    test1 = rn / (fro * x64.norm() + wide(b).norm())
    test2 = adjoint(r).norm() / (fro * rn.clamp_min(1e-300))
    return float(min(test1, test2))


def phase_api(dev, m, card, paths):
    """Phase 19: the modules around the solvers on the card, on phase 2's
    operator (m = n = 2^23, 11 diagonals, shared f32 stripes, damp DAMP)
    unless a step names another: the damped warm start of lsqr, lsmr and
    cgls (the stacked [A; damp I], two products an iteration); column
    scaling with right preconditioning; ``tikhonov`` with a first-difference
    L; ``lsqr_refined`` with host f64 products (damp DAMP and 0);
    ``lsqr_checkpointed`` in segments through a state file; ``debug_log``
    at M_IO; ``lsrn`` on phase 15's WCOO Zipf operator; ``hybrid_lsqr`` and
    ``lsqr`` at its GCV lambda; a Matrix Market round trip and
    ``lsqr_scipy`` against scipy in f64 at M_IO; ``product_rate``. Every
    entry point runs as a counted path."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import scipy.io
    import scipy.sparse
    import scipy.sparse.linalg
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo
    from lsqr_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    out = {}
    tol = dict(atol=1e-6, btol=1e-6)

    def run(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, delta = counted(fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths.append(delta)
        log(f"  {label}: wall {secs * 1e3:.1f} ms, launches "
            f"{({k: v for k, v in delta.items() if v})}")
        return res, delta, secs

    def stops(res):
        return dict(istop=int(res.istop), itn=int(res.itn))

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_shared_operator(m, m, OFFSETS, data)
    del data
    fwd, adj, fro = shared_f64(A)

    # (1) damped warm start: x0 from an 8-iteration solve
    warm, cold_x = {}, {}
    for name in ("lsqr", "lsmr", "cgls"):
        fn = getattr(lt, name)
        x8 = fn(A, b, DAMP, itnlim=8).x
        cold = fn(A, b, DAMP, **tol)
        res, delta, secs = run(f"{name} damped warm start",
                               lambda: fn(A, b, DAMP, x0=x8, **tol))
        err = absdiff(res.x, cold.x) / float(cold.x.abs().max())
        ratio = optimality(fwd, adj, fro, b, res.x)
        log(f"    {stops(res)}, the cold solve's {stops(cold)}; x against the cold x "
            f"{err:.3e} of max|x|; optimality {ratio:.3e}")
        check(delta["dia_product_shared"] > 0 and delta["dia_pair_shared"] == 0,
              f"{name} warm start: the stacked operator takes the two products: {delta}")
        check(err <= 1e-3, f"{name} warm start: x differs from the cold solve's by {err:.3e}")
        check(ratio <= 1e-4, f"{name} warm start: optimality {ratio:.3e} > 1e-4")
        warm[name] = dict(stops(res), cold=stops(cold), ms=secs * 1e3, x_rel_to_cold=err,
                          optimality=ratio)
        cold_x[name] = cold.x
    out["warm_start"] = warm

    # (2) column scaling and right preconditioning: x = scale * z of
    # min ||A D z - b||^2 + damp^2 ||D z||^2, the damped problem in x
    S, scale = lt.column_scaled(A)
    R = lt.right_preconditioned(A, lt.diagonal_operator(scale))
    g = torch.Generator(device=dev).manual_seed(191)
    v, y = torch.randn(m, generator=g, device=dev), torch.randn(m, generator=g, device=dev)
    check(torch.equal(S.matvec(v), R.matvec(v)) and torch.equal(S.rmatvec(y), R.rmatvec(y)),
          "column_scaled and right_preconditioned(diag) give different products")
    stacked = lt.vstack_operators([R, lt.scale_operator(lt.diagonal_operator(scale), DAMP)])
    rhs = torch.cat([b, torch.zeros(m, device=dev)])
    res, delta, secs = run("column-scaled damped solve (stacked, damp in x)",
                           lambda: lt.lsqr(stacked, rhs, 0.0, **tol))
    x = scale * res.x
    ratio = optimality(fwd, adj, fro, b, x)
    err = absdiff(x, cold_x["lsqr"]) / float(cold_x["lsqr"].abs().max())
    log(f"    {stops(res)}; optimality of scale * z {ratio:.3e}; x against the unscaled "
        f"solve's {err:.3e} of max|x|; column norms {float(1 / scale.max()):.4f}-"
        f"{float(1 / scale.min()):.4f}")
    check(delta["dia_product_shared"] > 0, f"the scaled solve ran no product kernel: {delta}")
    check(ratio <= 1e-4, f"column scaling: optimality {ratio:.3e} > 1e-4")
    check(err <= 1e-3, f"column scaling: x differs from the unscaled solve's by {err:.3e}")
    out["column_scaled"] = dict(stops(res), ms=secs * 1e3, optimality=ratio, x_rel=err)
    del R, stacked, rhs, v, y

    # (3) tikhonov with L the (m-1) x m first-difference operator
    lam = TIKHONOV_LAM
    ld = torch.zeros((2, m - 1), device=dev)
    ld[0], ld[1] = -1.0, 1.0
    L = lt.dia_shared_operator(m - 1, m, (0, 1), ld)
    del ld
    res, delta, secs = run(f"tikhonov, L first differences, lam {lam}",
                           lambda: lt.tikhonov(A, b, L, lam, **tol))
    lf, la, lfro = shared_f64(L)
    ratio = optimality(lambda x: torch.cat([fwd(x), lam * lf(x)]),
                       lambda r: adj(r[:m]) + lam * la(r[m:]),
                       torch.sqrt(fro ** 2 + lam ** 2 * lfro ** 2),
                       torch.cat([b, torch.zeros(m - 1, device=dev)]), res.x, 0.0)
    log(f"    {stops(res)}; optimality of the stacked system {ratio:.3e}")
    check(delta["dia_product_shared"] > 0, f"tikhonov ran no product kernel: {delta}")
    check(ratio <= 1e-4, f"tikhonov: optimality {ratio:.3e} > 1e-4")
    out["tikhonov"] = dict(stops(res), ms=secs * 1e3, optimality=ratio)
    del L, lf, la

    # (4) mixed-precision refinement, host f64 products of the stored matrix
    if REFINE_M == m:
        Ar, br, rf = A, b, (fwd, adj, fro)
    else:
        d_r, br, _ = random_stripes(REFINE_M, REFINE_M, OFFSETS, dev, seed=100, boost=12.0)
        Ar = lt.dia_shared_operator(REFINE_M, REFINE_M, OFFSETS, d_r)
        del d_r
        rf = shared_f64(Ar)
    t0 = time.perf_counter()
    hmv, hrmv = lt.host_products(Ar)
    host_s = time.perf_counter() - t0
    log(f"  host f64 products of the {Ar.m} x {Ar.n} stored matrix ({Ar.nnz} stored entries): "
        f"built in {host_s:.2f} s")
    b64 = br.double().cpu().numpy()
    refined = dict(m=Ar.m, host_products_s=host_s)
    for damp in (DAMP, 0.0):
        # to the machine-precision guards (at most REFINE_ITNLIM iterations,
        # the inner solves too)
        plain = lt.lsqr(Ar, br, damp, atol=0.0, btol=0.0, conlim=0.0, itnlim=REFINE_ITNLIM)
        res, delta, secs = run(f"lsqr_refined damp {damp}", lambda: lt.lsqr_refined(
            Ar, b64, damp, host_matvec=hmv, host_rmatvec=hrmv, precondition=None,
            itnlim=REFINE_ITNLIM))
        ratio = ls_ratio(*rf, br, torch.from_numpy(res.x).to(dev), damp)
        plain_ratio = ls_ratio(*rf, br, plain.x, damp)
        log(f"    cycles {res.cycles} (converged {res.converged}), ||dx|| {res.dx_norms}; "
            f"f64 ratio {ratio:.3e}; the plain f32 solve's {plain_ratio:.3e} ({stops(plain)})")
        inner = "dia_pair_shared" if damp == 0.0 else "dia_product_shared"
        check(delta[inner] > 0, f"refine damp {damp}: its inner solves ran no {inner}: {delta}")
        check(ratio <= 1e-10, f"refine damp {damp}: f64 ratio {ratio:.3e} > 1e-10")
        check(100 * ratio <= plain_ratio,
              f"refine damp {damp}: {ratio:.3e} not 100 times below the f32 {plain_ratio:.3e}")
        refined[f"damp_{damp}"] = dict(cycles=res.cycles, ms=secs * 1e3, ratio=ratio,
                                       plain_ratio=plain_ratio, plain=stops(plain))
    out["refine"] = refined
    del hmv, hrmv, b64
    if Ar is not A:
        del Ar, br, rf

    # (5) checkpointed solve: segments of CKPT_SEG, interrupted after the
    # first and resumed from the state file
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        whole, delta, secs = run(f"lsqr_checkpointed, segments of {CKPT_SEG}",
                                 lambda: lt.lsqr_checkpointed(A, b, DAMP,
                                                              segment_iters=CKPT_SEG, **tol))

        def stop(seg, carry):
            raise KeyboardInterrupt

        try:
            lt.lsqr_checkpointed(A, b, DAMP, segment_iters=CKPT_SEG, checkpoint_path=path,
                                 on_segment=stop, **tol)
        except KeyboardInterrupt:
            pass
        saved_itn = int(lt.load_state(path, device=dev).itn)
        resumed, _, _ = run("  resumed from the state file",
                            lambda: lt.lsqr_checkpointed(A, b, DAMP, segment_iters=CKPT_SEG,
                                                         resume_from=path, **tol))
    plain = lt.lsqr(A, b, DAMP, pair=False, fused=False, **tol)
    same = [torch.equal(r.x, whole.x) and stops(r) == stops(whole) for r in (resumed, plain)]
    log(f"    {stops(whole)}; saved at itn {saved_itn}; resumed {stops(resumed)}, x bit-equal "
        f"{same[0]}; the uninterrupted lsqr on the same route (two products) bit-equal "
        f"{same[1]}")
    check(saved_itn == CKPT_SEG and int(whole.itn) > CKPT_SEG,
          f"checkpoint: saved at itn {saved_itn} of {int(whole.itn)}")
    check(all(same), "checkpoint: the resumed solve differs from the uninterrupted one")
    out["checkpoint"] = dict(stops(whole), ms=secs * 1e3, saved_itn=saved_itn,
                             bit_equal=same)

    # (6) debug_log at M_IO: the rows the throttle rule selects
    d_io, b_io, _ = random_stripes(M_IO, M_IO, OFFSETS, dev, seed=119, boost=12.0)
    A_io = lt.dia_shared_operator(M_IO, M_IO, OFFSETS, d_io)
    del d_io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, delta = counted(lambda: lt.lsqr(A_io, b_io, DAMP, debug_log=True, itnlim=64,
                                             atol=0.0, btol=0.0, conlim=0.0, nconv=65))
    paths.append(delta)
    printed = [int(line.split()[0]) for line in buf.getvalue().splitlines() if line.strip()]
    # n > 40, no tolerance (atol = btol = conlim = 0), the stop at itnlim:
    # the first and last 10 iterations, every 10th and the last
    expected = sorted(set(range(1, 11)) | set(range(10, 65, 10)) | set(range(54, 65)))
    log(f"  debug_log at {M_IO}: {len(printed)} lines, iterations {printed}; "
        f"{stops(res)}; launches {({k: v for k, v in delta.items() if v})}")
    check(printed == expected, f"debug_log printed {printed}, the rule selects {expected}")
    check(printed[-1] == int(res.itn), "debug_log: the last line is not the result's itn")
    out["debug_log"] = dict(lines=len(printed), last=printed[-1])
    del A_io, b_io

    # (7) LSRN on phase 15's WCOO Zipf operator, against the COO solve
    trip = zipf_column_coo(ZIPF_M, ZIPF_N, ZIPF_NNZ, seed=0)
    Aw = lt.auto_operator(ZIPF_M, ZIPF_N, *trip, device=dev)
    check(type(Aw).__name__ == "WCOOOperator", f"the Zipf pattern went to {type(Aw).__name__}")
    coo_t = coo_on(dev, *trip)
    coo = lt.coo_operator(ZIPF_M, ZIPF_N, *trip, device=dev)
    del trip
    bw = torch.randn(ZIPF_M, generator=torch.Generator(device=dev).manual_seed(15), device=dev)
    plain_w = lt.lsqr(Aw, bw, DAMP, **tol)
    ref = lt.lsqr(coo, bw, DAMP, **tol)
    res, delta, secs = run("lsrn on the WCOO operator", lambda: lt.lsrn(Aw, bw, DAMP, **tol))
    phi, phi_ref = (objective(coo_t, ZIPF_M, ZIPF_N, bw, x, DAMP) for x in (res.x, ref.x))
    phi_err = abs(phi - phi_ref) / phi_ref
    ratio = coo_optimality(coo_t, ZIPF_M, ZIPF_N, bw, res.x)
    log(f"    rank {res.rank}, cond bound {res.cond_bound:.3f}; inner {stops(res.result)} "
        f"against the plain WCOO solve's {stops(plain_w)} and the COO solve's {stops(ref)}; "
        f"damped objective rel diff to the COO solve's {phi_err:.3e} (limit "
        f"{OBJ_TOL['wcoo']}); optimality (f64, COO) {ratio:.3e}")
    check(delta["wcoo_adjoint"] >= 4 * ZIPF_N and delta["wcoo_forward"] > 0,
          f"lsrn: the sketch and the solve ran no WCOO kernels: {delta}")
    check(phi_err <= OBJ_TOL["wcoo"],
          f"lsrn: objective differs from the COO solve's by {phi_err:.3e}")
    check(ratio <= 1e-4, f"lsrn: optimality {ratio:.3e} > 1e-4")
    out["lsrn"] = dict(inner=stops(res.result), plain=stops(plain_w), coo=stops(ref),
                       rank=res.rank, ms=secs * 1e3, objective_rel_to_coo=phi_err,
                       optimality=ratio)
    del Aw, coo, coo_t, bw, res, ref, plain_w
    torch.cuda.empty_cache()

    # (8) hybrid LSQR, then lsqr at its GCV lambda
    # all HYBRID_K steps (stop_window = HYBRID_K), lambda and k at the GCV
    # minimum: the flat-GCV stop (4 steps without a gain of 1e-4 GCV(1))
    # ends this band's run at k ~ 12, before the projection converges
    res, delta, secs = run(f"hybrid_lsqr k={HYBRID_K}, reorthogonalized",
                           lambda: lt.hybrid_lsqr(A, b, k=HYBRID_K, stop_window=HYBRID_K))
    lam = res.lam
    ref, _, _ = run(f"  lsqr at damp = the GCV lambda", lambda: lt.lsqr(A, b, lam, **tol))
    err = absdiff(res.x, ref.x) / float(ref.x.abs().max())
    ratios = [optimality(fwd, adj, fro, b, x, lam) for x in (res.x, ref.x)]
    log(f"    lambda {lam:.6e} at k {res.k} of {res.k_run}; lsqr {stops(ref)}; x against "
        f"lsqr's {err:.3e} of max|x|; optimality at lambda {ratios[0]:.3e} (hybrid), "
        f"{ratios[1]:.3e} (lsqr)")
    check(delta["dia_product_shared"] > 0, f"hybrid ran no product kernel: {delta}")
    check(err <= 1e-3, f"hybrid: x differs from lsqr's at its lambda by {err:.3e}")
    check(max(ratios) <= 1e-4, f"hybrid: optimality at lambda {ratios}")
    out["hybrid"] = dict(lam=lam, k=res.k, k_run=res.k_run, lsqr=stops(ref), ms=secs * 1e3,
                         x_rel=err, optimality=ratios)
    del res, ref

    # (9) Matrix Market: a 2^20 x 11 f64 band written and read back, then
    # lsqr_scipy against scipy.sparse.linalg.lsqr
    rng = np.random.default_rng(19)
    dio = rng.standard_normal((len(OFFSETS), M_IO))
    dio[OFFSETS.index(0)] += 12.0
    i = np.arange(M_IO)
    ok = [(i + k >= 0) & (i + k < M_IO) for k in OFFSETS]
    mat = scipy.sparse.coo_matrix(
        (np.concatenate([dio[d][ok[d]] for d in range(len(OFFSETS))]),
         (np.concatenate([i[o] for o in ok]),
          np.concatenate([i[ok[d]] + k for d, k in enumerate(OFFSETS)]))),
        shape=(M_IO, M_IO)).tocsr()
    del dio
    b_io = rng.standard_normal(M_IO)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "band.mtx")
        t0 = time.perf_counter()
        scipy.io.mmwrite(path, mat)
        t1 = time.perf_counter()
        A_mm = lt.from_matrix_market(path, dtype=torch.float64, device=dev)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    log(f"  Matrix Market {M_IO} x {M_IO}, {mat.nnz} entries, {size / 1e6:.0f} MB: written in "
        f"{t1 - t0:.2f} s, read to {type(A_mm).__name__} ({A_mm.dtype}) in {t2 - t1:.2f} s")
    check(isinstance(A_mm, lt.DIAOperator) and A_mm.dtype == torch.float64
          and A_mm.device.type == dev.type, f"the f64 band read to {type(A_mm).__name__}")
    sk = dict(damp=DAMP, atol=1e-10, btol=1e-10, iter_lim=2 * M_IO)
    ours, delta, secs = run("lsqr_scipy on it", lambda: lt.lsqr_scipy(A_mm, b_io, **sk))
    ref = scipy.sparse.linalg.lsqr(mat, b_io, **sk)
    err = float(np.abs(ours[0] - ref[0]).max() / np.abs(ref[0]).max())
    log(f"    istop {ours[1]} itn {ours[2]}; scipy istop {ref[1]} itn {ref[2]}; x rel diff "
        f"{err:.3e}")
    check(delta["dia_matvec[f64]"] > 0, f"lsqr_scipy ran no f64 product kernel: {delta}")
    check(ours[1] == ref[1] and abs(ours[2] - ref[2]) <= 1, "lsqr_scipy: istop/itn differ")
    check(err <= 1e-8, f"lsqr_scipy: x differs from scipy's by {err:.3e}")
    out["matrix_market"] = dict(write_s=t1 - t0, read_s=t2 - t1, mb=size / 1e6, istop=ours[1],
                                itn=ours[2], scipy_itn=ref[2], x_rel=err)
    del A_mm, mat

    # (10) product_rate on the main operator
    rate, delta = counted(lambda: profiling.product_rate(A, iters=50))
    paths.append(delta)
    log(f"  product_rate (matvec + rmatvec, 50 chained): {rate}  [{card}]")
    # a warm-up chain and the timed one, each 50 forward and 50 adjoint
    check(delta["dia_product_shared"] == 4 * 50, f"product_rate launches: {delta}")
    out["product_rate"] = rate

    # the launch profiles of the stacked and the column-scaled solves
    # (PERF.md section 5) are cut to make room for phases 21 and 22
    del A, S, fwd, adj
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: many right-hand sides, multi-damp sweeps, regularization paths
# and gradients through the solver
# ---------------------------------------------------------------------------

#: phase 20's damp grid on the main operator (k = 8, with 0, DAMP and 1.0),
#: the LSMR sweep's (k = 4) and the per-problem damps of its batches
MD_DAMPS = (0.0, 1e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 1.0)
MD_LSMR_DAMPS = (0.0, 0.01, 0.1, 1.0)
BATCH_DAMPS = (0.0, 0.01, 0.1, 1.0)
M_ROWS = 2 ** 20  # phase 20's second size (pair=False sweep, sibling batches, paths, gradient)
#: phase 20's regularization path at M_ROWS: damps where the residual is
#: well above f32 rounding (the band's singular values lie near 12)
PATH_GRID = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
PATH_TOL = 1e-3  # its computed residual norms against f64 products of the same x
GRAD_TOL = 1e-6  # the gradient's directional derivatives against central differences


def rows_equal(label, res, refs):
    """Each row of a multi-damp or batched solve against its standalone
    solve: (istop, itn) and x bit for bit. Returns the readings; fails unless
    every row equals its solve."""
    import torch

    rows = [dict(istop=int(res.istop[j]), itn=int(res.itn[j]),
                 standalone=[int(ref.istop), int(ref.itn)],
                 bit_equal=bool(torch.equal(res.x[j], ref.x)), x_rel=rel(res.x[j], ref.x))
            for j, ref in enumerate(refs)]
    log(f"    {label}: (istop, itn) {[[r['istop'], r['itn']] for r in rows]}, standalone "
        f"{[r['standalone'] for r in rows]}; x bit-equal {[r['bit_equal'] for r in rows]}")
    for j, r in enumerate(rows):
        check([r["istop"], r["itn"]] == r["standalone"],
              f"{label}: row {j} stops at {[r['istop'], r['itn']]}, its solve at {r['standalone']}")
        check(r["bit_equal"], f"{label}: row {j}'s x differs from its solve's by {r['x_rel']:.3e}")
    return rows


def phase_rows(dev, m, card, paths):
    """Phase 20: the solves over rows on phase 2's operator (m = n = 2^23,
    11 diagonals, shared f32 stripes, seed 100): ``lsqr_multidamp`` over
    MD_DAMPS (one pair launch an iteration for all 8 damps) and
    ``lsmr_multidamp`` over MD_LSMR_DAMPS, each damp against its standalone
    pair solve (istop, itn, x bit for bit), with the multi-damp launch
    profile; ``lsqr_batch`` of 4 right-hand sides with BATCH_DAMPS, column
    for column against ``lsqr``. At M_ROWS: the sweep with pair=False (two
    ``dia_product_shared`` an iteration) against ``lsqr(pair=False,
    fused=False)``; ``lsqr_batch`` with pair=False (the half-step),
    ``lsmr_batch`` and ``cgls_batch`` against their standalone solves;
    ``reg_sweep`` with the computed residual (against f64 products),
    ``discrepancy_damp``, ``lcurve_corner`` and ``gcv_damp``; ``lsqr_grad``
    on an f64 band: directional derivatives in b and in one stripe against
    central differences. Every entry point runs as a counted path."""
    import torch

    import lsqr_tpu_torch as lt

    t_phase = time.perf_counter()
    out = {}
    tol = dict(atol=1e-6, btol=1e-6)
    seg = lt.LSQROptions().loop_segment

    def run(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, delta = counted(fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths.append(delta)
        log(f"  {label}: wall {secs * 1e3:.1f} ms, launches "
            f"{({k: v for k, v in delta.items() if v})}")
        return res, delta, secs

    def standalone(label, solve, args):
        """The standalone solves a solve over rows replaces, each a counted
        path: (results, wall ms of each)."""
        results = [run(f"  {label} {a}", lambda a=a: solve(*a)) for a in args]
        return [r[0] for r in results], [r[2] * 1e3 for r in results]

    data, b, g = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    A = lt.dia_shared_operator(m, m, OFFSETS, data)
    del data

    # (1) lsqr_multidamp, k = 8, on the pair route: a warm-up run (the
    # allocator's first (k, n) blocks), then the timed one
    run("lsqr_multidamp warm-up", lambda: lt.lsqr_multidamp(A, b, MD_DAMPS, **tol))
    res, delta, secs = run(f"lsqr_multidamp k={len(MD_DAMPS)} (pair)",
                           lambda: lt.lsqr_multidamp(A, b, MD_DAMPS, **tol))
    body = iterations_run(int(res.itn.max()), seg)
    check(delta["dia_pair_shared"] == body and delta["dia_product_shared"] == 1,
          f"lsqr_multidamp: expected {body} pair launches (itn + masked, all damps) and one "
          f"setup product: {delta}")
    refs, walls = standalone("lsqr damp", lambda d: lt.lsqr(A, b, d, **tol),
                             [(d,) for d in MD_DAMPS])
    pairs = sum(iterations_run(int(r.itn), seg) for r in refs)
    log(f"    {body} pair launches for the sweep against {pairs} for the 8 solves; wall "
        f"{secs * 1e3:.1f} ms ({secs * 1e3 / body:.3f} ms an iteration run) against "
        f"{sum(walls):.1f} ms  [{card}]")
    out["lsqr_multidamp"] = dict(damps=MD_DAMPS, rows=rows_equal("lsqr_multidamp", res, refs),
                                 ms=secs * 1e3, standalone_ms=walls, pair_launches=body,
                                 standalone_pair_launches=pairs)
    log("  launch profile of lsqr_multidamp k=8 (pair):")
    out["multidamp_profile"] = phase_launches(
        A, b, solve=lambda A_, b_, damp, **kw: lt.lsqr_multidamp(A_, b_, MD_DAMPS, **kw))

    # (2) lsmr_multidamp, k = 4, on the pair route
    res, delta, secs = run(f"lsmr_multidamp k={len(MD_LSMR_DAMPS)} (pair)",
                           lambda: lt.lsmr_multidamp(A, b, MD_LSMR_DAMPS, **tol))
    body = iterations_run(int(res.itn.max()), seg)
    check(delta["dia_pair_shared"] == body and delta["dia_product_shared"] == 1,
          f"lsmr_multidamp: expected {body} pair launches and one setup product: {delta}")
    refs, walls = standalone("lsmr damp", lambda d: lt.lsmr(A, b, d, **tol),
                             [(d,) for d in MD_LSMR_DAMPS])
    out["lsmr_multidamp"] = dict(damps=MD_LSMR_DAMPS, ms=secs * 1e3, standalone_ms=walls,
                                 rows=rows_equal("lsmr_multidamp", res, refs))

    # (3) lsqr_batch: 4 right-hand sides, one damp each, the pair kernel a row
    B = torch.stack([b] + [torch.randn(m, generator=g, device=dev) for _ in range(3)])
    res, delta, secs = run(f"lsqr_batch k={len(BATCH_DAMPS)} (pair)",
                           lambda: lt.lsqr_batch(A, B, BATCH_DAMPS, **tol))
    body = iterations_run(int(res.itn.max()), seg)
    check(delta["dia_pair_shared"] == len(B) * body and delta["dia_product_shared"] == len(B),
          f"lsqr_batch: expected {len(B)} x {body} pair launches and {len(B)} setup products: "
          f"{delta}")
    refs, walls = standalone("lsqr column", lambda j: lt.lsqr(A, B[j], BATCH_DAMPS[j], **tol),
                             [(j,) for j in range(len(B))])
    out["lsqr_batch"] = dict(damps=BATCH_DAMPS, ms=secs * 1e3, standalone_ms=walls,
                             rows=rows_equal("lsqr_batch", res, refs))
    del A, B, b, refs, res
    torch.cuda.empty_cache()

    # (4) at M_ROWS: the sweep on the plain products, the other batches
    d20, b20, g20 = random_stripes(M_ROWS, M_ROWS, OFFSETS, dev, seed=120, boost=12.0)
    A20 = lt.dia_shared_operator(M_ROWS, M_ROWS, OFFSETS, d20)
    del d20
    damps3 = (0.0, DAMP, 1.0)
    res, delta, _ = run("lsqr_multidamp k=3, pair=False",
                        lambda: lt.lsqr_multidamp(A20, b20, damps3, pair=False, **tol))
    body = iterations_run(int(res.itn.max()), seg)
    check(delta["dia_pair_shared"] == 0 and delta["dia_product_shared"] == 2 * body + 1,
          f"pair=False sweep: expected {2 * body + 1} products: {delta}")
    refs, _ = standalone("lsqr pair=False, fused=False, damp",
                         lambda d: lt.lsqr(A20, b20, d, pair=False, fused=False, **tol),
                         [(d,) for d in damps3])
    out["multidamp_pair_false"] = rows_equal("lsqr_multidamp pair=False", res, refs)
    B20 = torch.stack([b20] + [torch.randn(M_ROWS, generator=g20, device=dev)
                               for _ in range(2)])
    batches = {}
    for name, kw, kernel in (("lsqr", dict(pair=False), "dia_product_shared_axpy"),
                             ("lsmr", {}, "dia_pair_shared"),
                             ("cgls", {}, "dia_product_shared")):
        res, delta, _ = run(f"{name}_batch k=3 {kw}",
                            lambda: getattr(lt, name + "_batch")(A20, B20, damps3, **tol, **kw))
        check(delta[kernel] > 0, f"{name}_batch ran no {kernel}: {delta}")
        refs, _ = standalone(f"{name} column", lambda j: getattr(lt, name)(
            A20, B20[j], damps3[j], **tol, **kw), [(j,) for j in range(len(B20))])
        batches[name] = rows_equal(f"{name}_batch", res, refs)
    out["batches_m20"] = batches
    del B20

    # (5) the regularization path, its choices, GCV
    path, delta, _ = run("reg_sweep, computed residual",
                         lambda: lt.reg_sweep(A20, b20, PATH_GRID, exact_residual=True, **tol))
    check(delta["dia_product_shared"] == 1 + len(PATH_GRID) and delta["dia_pair_shared"] > 0,
          f"reg_sweep: expected the pair, a setup product and one product a damp: {delta}")
    est, _, _ = run("reg_sweep, exit estimates", lambda: lt.reg_sweep(A20, b20, PATH_GRID, **tol))
    fwd, _, _ = shared_f64(A20)
    r64 = torch.stack([(wide(b20) - fwd(wide(x))).norm() for x in path.x])
    err, est_err = rel(path.residual_norm, r64), rel(est.residual_norm, r64)
    grows = bool((path.residual_norm[1:] > path.residual_norm[:-1]).all())
    log(f"    residual norms {[f'{float(v):.6e}' for v in path.residual_norm]}: against f64 "
        f"products {err:.3e}, the exit estimates' {est_err:.3e}; growing with damp {grows}")
    check(err <= PATH_TOL and grows, f"reg_sweep: residual {err:.3e} from f64, growing {grows}")
    target = float(torch.sqrt(path.residual_norm[3] * path.residual_norm[4]))
    damp_d, _, path_d = run("discrepancy_damp", lambda: lt.discrepancy_damp(
        A20, b20, target, damps=PATH_GRID, **tol))[0]
    damp_l, _, kappa = lt.lcurve_corner(path)
    gcv_out, delta, _ = run("gcv_damp, 1 probe", lambda: lt.gcv_damp(
        A20, b20, damps=PATH_GRID, probes=1, **tol))
    damp_g, gcv = gcv_out[0], gcv_out[3]
    log(f"    discrepancy (target {target:.6e}): damp {float(damp_d)}; L-curve corner "
        f"{float(damp_l)}, curvature {[f'{float(v):.3e}' for v in kappa]}; GCV damp "
        f"{float(damp_g)}, values {[f'{float(v):.4e}' for v in gcv]}")
    check(float(damp_d) == PATH_GRID[3], f"discrepancy picked {float(damp_d)}, not {PATH_GRID[3]}")
    check(bool(torch.isfinite(kappa[1:-1]).all()) and float(damp_l) in PATH_GRID,
          "lcurve_corner: no finite corner")
    check(bool(torch.isfinite(gcv).all()) and float(damp_g) == PATH_GRID[int(torch.argmin(gcv))],
          "gcv_damp: the choice is not the minimum")
    out["regpath"] = dict(residual_rel_f64=err, estimate_rel_f64=est_err,
                          discrepancy=float(damp_d), lcurve=float(damp_l), gcv=float(damp_g))
    del A20, path, est, path_d, fwd

    # (6) lsqr_grad on an f64 band: directional derivatives against central
    # differences (x is linear in b, so the difference in b is exact)
    f64 = torch.float64
    d64, b64, g64 = random_stripes(M_ROWS, M_ROWS, OFFSETS, dev, seed=121, boost=12.0, dtype=f64)
    weights, db, ds = (torch.randn(M_ROWS, generator=g64, device=dev, dtype=f64)
                       for _ in range(3))
    grad_tol = dict(atol=1e-12, btol=1e-12)
    stripe = OFFSETS.index(2)

    def loss(stripes, vec):
        op = lt.dia_shared_operator(M_ROWS, M_ROWS, OFFSETS, stripes)
        return torch.dot(lt.lsqr_grad(op, vec, DAMP, **grad_tol), weights)

    leaves = (d64.clone().requires_grad_(), b64.clone().requires_grad_())
    (gs, gb), delta, secs = run("lsqr_grad f64, forward and backward",
                                lambda: torch.autograd.grad(loss(*leaves), leaves))
    check(delta["dia_product_shared[f64]"] > 0, f"lsqr_grad ran no f64 product: {delta}")
    pert = torch.zeros_like(d64)
    pert[stripe] = ds
    eps = 1e-4
    with torch.no_grad():
        fd_b = float(loss(d64, b64 + db) - loss(d64, b64 - db)) / 2
        fd_s = float(loss(d64 + eps * pert, b64) - loss(d64 - eps * pert, b64)) / (2 * eps)
    an_b, an_s = float(torch.dot(gb, db)), float(torch.sum(gs * pert))
    errs = [abs(an_b - fd_b) / abs(fd_b), abs(an_s - fd_s) / abs(fd_s)]
    log(f"    d/db: {an_b:.12e} against {fd_b:.12e}; d/d(stripe {OFFSETS[stripe]}): "
        f"{an_s:.12e} against {fd_s:.12e}; relative {errs[0]:.3e}, {errs[1]:.3e}")
    check(max(errs) <= GRAD_TOL, f"lsqr_grad: directional derivatives off by {errs}")
    out["lsqr_grad"] = dict(ms=secs * 1e3, rel_b=errs[0], rel_stripe=errs[1])
    del d64, b64, gs, gb, leaves
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the sharded solvers over torch.distributed
# ---------------------------------------------------------------------------

SHARD_RANKS = 4  # phase 21 (b): gloo ranks on this one card
SHARD_ITN = 16  # (b)'s fixed iterations: 64 on one rank, cut to 16 on four
SHARD_SHORT = 8  # (b)'s timing run: the solve cut to 8 iterations
M_SHARD_2D = 2 ** 20  # (b)'s 2-D COO band
SHARD_TIMEOUT = 600  # seconds (b) waits for its ranks
SHARD_TOL = 1e-3  # sharded against unsharded x, relative (PERF.md section 2's band)


def shard_band(dev, m):
    """Phase 2's band (seed 100, +12 on the diagonal) as a shared operator
    on ``dev``, and its b."""
    import lsqr_tpu_torch as lt

    data, b, _ = random_stripes(m, m, OFFSETS, dev, seed=100, boost=12.0)
    return lt.dia_shared_operator(m, m, OFFSETS, data), b


def shard_problems(dev):
    """Phase 21 (b)'s problems, made from seeds on ``dev`` (the same on every
    rank): {label: (operator, b, solve options, entry, its extra keywords)}."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import ZDIA_OFFSETS, zipf_column_coo

    fixed = dict(itnlim=SHARD_ITN, atol=0.0, btol=0.0, conlim=0.0, nconv=SHARD_ITN + 1)
    A, b = shard_band(dev, M_MAIN)
    band = (A, b, dict(fixed, pair=True), "lsqr_sharded_dia", {})
    trip = zipf_column_coo(ZIPF_M, ZIPF_N, ZIPF_NNZ, seed=0)
    Aw = lt.coo_operator(ZIPF_M, ZIPF_N, *trip, device="cpu")
    bw = torch.randn(ZIPF_M, generator=torch.Generator(device=dev).manual_seed(15), device=dev)
    wcoo = (Aw, bw, dict(atol=1e-6, btol=1e-6), "lsqr_sharded_wcoo", {})
    data, b2, _ = random_stripes(M_SHARD_2D, M_SHARD_2D, OFFSETS, dev, seed=21, boost=12.0)
    rows, cols, vals = (t.cpu().numpy() for t in stripe_triplets(data, OFFSETS, M_SHARD_2D,
                                                                 M_SHARD_2D))
    A2 = lt.coo_operator(M_SHARD_2D, M_SHARD_2D, vals, rows, cols, device="cpu")
    blocks = (A2, b2, fixed, "lsqr_sharded_2d", dict(mesh_shape=(2, 2)))
    stripes = lt.zdia_stripes(M_ZDIA, M_ZDIA, ZDIA_OFFSETS, seed=17, diag=12.0, device=dev,
                              generator="torch")
    Az = lt.zdia_operator_device(M_ZDIA, M_ZDIA, ZDIA_OFFSETS, stripes)
    bz = torch.randn(M_ZDIA, generator=torch.Generator(device=dev).manual_seed(16), device=dev,
                     dtype=torch.complex64)
    zdia = (Az, bz, dict(fixed, pair=True), "lsqr_sharded_zdia", {})
    return {"dia": band, "wcoo": wcoo, "2d": blocks, "zdia": zdia}


def sharded_run(entry, A, b, dev, opts, extra):
    """One sharded solve on this rank: (result, wall s, collectives, launches
    by variant), the counts set to 0 just before it."""
    import torch
    import torch.distributed as dist

    from lsqr_tpu_torch import parallel
    from lsqr_tpu_torch.ops import spmv

    real, calls = dist.all_reduce, []

    def counting(tensor, *a, **kw):
        calls.append(tensor.numel())
        return real(tensor, *a, **kw)

    dist.all_reduce = counting
    try:
        torch.cuda.synchronize()
        spmv.reset_launch_counts()
        t0 = time.perf_counter()
        res = getattr(parallel, entry)(A, b, DAMP, device=dev, **extra, **opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dist.all_reduce = real
    return res, secs, len(calls), spmv.launch_counts(by_variant=True)


def shard_rank(rank, store, device, results):
    """Phase 21 (b)'s rank ``rank`` of SHARD_RANKS, a spawned process on
    ``device`` (the card): its sharded solves of every problem, sent to
    ``results``."""
    import hashlib

    import torch

    from lsqr_tpu_torch.parallel import initialize_distributed

    try:
        initialize_distributed(f"file://{store}", SHARD_RANKS, rank, backend="gloo")
        dev = torch.device(device)
        out = {}
        short = dict(itnlim=SHARD_SHORT, atol=0.0, btol=0.0, conlim=0.0, nconv=SHARD_SHORT + 1)
        for label, (A, b, opts, entry, extra) in shard_problems(dev).items():
            res, secs, collectives, launches = sharded_run(entry, A, b, dev, opts, extra)
            x = res.x.detach()
            # the same solve cut to SHARD_SHORT iterations: the difference is
            # the iterations' wall and collectives, the set-up (partition,
            # packing) left out
            _, secs_short, coll_short, _ = sharded_run(entry, A, b, dev,
                                                       dict(opts, **short), extra)
            ran = iterations_run(int(res.itn), min(int(opts.get("itnlim", 64)), 64))
            out[label] = dict(istop=int(res.istop), itn=int(res.itn), secs=secs,
                              iteration_ms=(secs - secs_short) * 1e3 / (ran - SHARD_SHORT),
                              iteration_collectives=(collectives - coll_short)
                              / (ran - SHARD_SHORT), launches=launches,
                              x_sha=hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(),
                              x=x.cpu().numpy() if rank == 0 else None)
            del A, b, res, x
            torch.cuda.empty_cache()
        results.put((rank, out))
        torch.distributed.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 - the parent fails the run with it
        import traceback

        results.put((rank, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def sharded_one_rank(dev, card, paths, backend="nccl"):
    """Phase 21 (a): a world of one rank in this process (NCCL takes one
    card a rank), lsqr_sharded_dia on phase 2's band against the unsharded
    solve, 64 fixed iterations in pair mode."""
    import socket

    import torch.distributed as dist

    from lsqr_tpu_torch.parallel import initialize_distributed

    fixed = dict(itnlim=64, atol=0.0, btol=0.0, conlim=0.0, nconv=65)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, backend=backend)
    A, b = shard_band(dev, M_MAIN)
    for _ in range(2):  # a warm-up run, then the timed one
        (res, secs, collectives, _), delta = counted(
            lambda: sharded_run("lsqr_sharded_dia", A, b, dev, dict(fixed, pair=True), {}))
    paths.append(delta)
    ref, _, _ = timed_solve(A, b, "unsharded fixed 64 iterations (pair)", card, **fixed)
    err = rel(res.x, ref.x)
    itn = int(res.itn)
    log(f"  (a) lsqr_sharded_dia, 1 rank on {backend}, {M_MAIN} x {len(OFFSETS)} diagonals, pair: "
        f"istop={int(res.istop)} itn={itn}, x against the unsharded solve {err:.3e}; "
        f"{secs * 1e3 / itn:.4f} ms an iteration (setup included), {collectives / itn:.2f} "
        f"all-reduces an iteration; launches {({k: v for k, v in delta.items() if v})}  [{card}]")
    check(int(res.istop) == int(ref.istop) and abs(itn - int(ref.itn)) <= 1,
          "(a) istop/itn differ from the unsharded solve")
    check(err <= SHARD_TOL, f"(a) x differs from the unsharded solve's by {err:.3e}")
    check(delta["dia_pair_shared"] >= itn, f"(a) the sharded solve ran no pair kernel: {delta}")
    dist.destroy_process_group()
    return dict(istop=int(res.istop), itn=itn, x_rel=err, ms_per_iteration=secs * 1e3 / itn,
                collectives_per_iteration=collectives / itn,
                launches={k: v for k, v in delta.items() if v})


def sharded_ranks(dev, card, paths):
    """Phase 21 (b): SHARD_RANKS gloo ranks, spawned processes that share
    ``dev`` (the kernel library built before is loaded, not built, by
    each), every solve held to the unsharded one in this process."""
    import queue
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch import native
    from lsqr_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    _cuda.library()  # built before the spawn: the ranks load them
    native._lib()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=shard_rank,
                             args=(r, os.path.join(tmp, "store"), str(dev), results))
                 for r in range(SHARD_RANKS)]
        for p in procs:
            p.start()
        got = {}
        try:
            deadline = time.perf_counter() + SHARD_TIMEOUT
            while len(got) < SHARD_RANKS:
                try:
                    rank, value = results.get(timeout=max(1.0, deadline - time.perf_counter()))
                except queue.Empty:
                    raise AssertionError(f"(b) ranks {sorted(set(range(SHARD_RANKS)) - set(got))}"
                                         f" did not answer in {SHARD_TIMEOUT} s") from None
                check(not isinstance(value, str), f"(b) rank {rank} failed: {value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        check(all(p.exitcode == 0 for p in procs),
              f"(b) rank exit codes {[p.exitcode for p in procs]}")
    log(f"  (b) {SHARD_RANKS} gloo ranks answered in {time.perf_counter() - t_phase:.1f} s")

    refs = shard_problems(dev)
    out = {}
    for label, (A, b, opts, entry, extra) in refs.items():
        ranks = [got[r][label] for r in range(SHARD_RANKS)]
        first = ranks[0]
        check(len({r["x_sha"] for r in ranks}) == 1, f"(b) {label}: ranks' x differ")
        check(len({(r["istop"], r["itn"]) for r in ranks}) == 1,
              f"(b) {label}: ranks stopped apart")
        for r in ranks:
            paths.append(r["launches"])
        if label == "wcoo":
            check(all(r["launches"]["wcoo_pair"] > 0 for r in ranks),
                  "(b) wcoo: a rank launched no wcoo_pair")
            Aw = lt.wcoo_operator(A.m, A.n, *(t.numpy() for t in (A.vals, A.rows, A.cols)),
                                  device=dev)
            ref = lt.lsqr(Aw, b, DAMP, **opts)
            coo_t = tuple(t.to(dev) for t in (A.rows, A.cols, A.vals))
            phis = [objective(coo_t, A.m, A.n, b, torch.from_numpy(x).to(dev), DAMP)
                    for x in (first["x"], ref.x.cpu().numpy())]
            err = abs(phis[0] - phis[1]) / phis[1]
            check(first["istop"] in (1, 2, 3) and err <= OBJ_TOL["wcoo"],
                  f"(b) wcoo: istop {first['istop']}, objective differs by {err:.3e}")
            del Aw, coo_t
        else:
            if label == "2d":
                A = lt.coo_operator(A.m, A.n, *(t.numpy() for t in (A.vals, A.rows, A.cols)),
                                    device=dev)
            ref = lt.lsqr(A, b, DAMP, **opts)
            err = rel(torch.from_numpy(first["x"]).to(dev), ref.x)
            check(first["istop"] == int(ref.istop) and abs(first["itn"] - int(ref.itn)) <= 1
                  and err <= SHARD_TOL,
                  f"(b) {label}: istop {first['istop']} itn {first['itn']} against "
                  f"{int(ref.istop)} {int(ref.itn)}, x differs by {err:.3e}")
        entry_out = dict(istop=first["istop"], itn=first["itn"], ref_itn=int(ref.itn),
                         x_rel=err, solve_ms=[r["secs"] * 1e3 for r in ranks],
                         ms_per_iteration=[r["iteration_ms"] for r in ranks],
                         collectives_per_iteration=first["iteration_collectives"],
                         launches={k: v for k, v in first["launches"].items() if v})
        out[label] = entry_out
        log(f"  (b) {entry} [{label}]: istop={first['istop']} itn={first['itn']} "
            f"(unsharded {int(ref.itn)}), {'objective' if label == 'wcoo' else 'x'} against "
            f"the unsharded solve {err:.3e}; solve ms by rank (set-up included) "
            f"{np.round(entry_out['solve_ms'], 1).tolist()}, ms an iteration by rank "
            f"{np.round(entry_out['ms_per_iteration'], 3).tolist()}, "
            f"{entry_out['collectives_per_iteration']:.2f} all-reduces an iteration; rank 0's "
            f"launches {entry_out['launches']}  [{card}]")
        del A, b, ref
        torch.cuda.empty_cache()
    return out


def phase_sharded(dev, card, paths):
    """Phase 21: (a) one rank on NCCL in this process, (b) SHARD_RANKS gloo
    ranks spawned on this card, each solve against the unsharded one."""
    t_phase = time.perf_counter()
    out = dict(nccl_1rank=sharded_one_rank(dev, card, paths),
               gloo_ranks=sharded_ranks(dev, card, paths))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 21: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 22: gradients to the operators' stored values at full width
# ---------------------------------------------------------------------------

GRAD_ITNLIM = 64  # phase 22's forward solves (f32 cannot meet atol = 1e-10)
GRAD_ATOL = 1e-6  # their atol = btol; the backward's CG runs to min(atol, 1e-8)
GRAD_DAMP = 0.3  # phase 22's damp, times each operator's largest singular value
#: |the layout's directional derivative - the COO operator's| / |the COO's|:
#: sound readings sit far below it, a gradient without its adjoint share far
#: above it (PERF.md section 6)
GRAD_BAND = 1e-3
#: the kernels each operator's backward pass (normal_cg's products) must launch
GRAD_KERNELS = {"jdia": ("jdia_matvec",), "block_ell": ("block_ell_matvec",),
                "hyb": (), "wcoo": ("wcoo_forward", "wcoo_adjoint"),
                "rwcoo": ("wcoo_forward", "wcoo_adjoint", "wwcoo_forward", "wwcoo_adjoint"),
                "warm_start": ("dia_product_shared",)}


def coordinate_weights(rows, cols):
    """A pseudo-random weight in [-1, 1) of each coordinate (i, j), the same
    wherever the coordinate is stored: the direction v * w(i, j) of a
    matrix's values packs to each stored value times the weight of its
    position (the packers place each value at its coordinates, linearly)."""
    import torch

    h = (rows.long() * 73856093) ^ (cols.long() * 19349663)
    return (h % (1 << 20)).to(torch.float64) / (1 << 19) - 1.0


def packed_positions(A):
    """[(value tensor, its rows, its cols)] of an operator's differentiable
    tensors on their packings: each stored entry's coordinates (padding
    holds 0, so its coordinates do not matter)."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.ops.spmv_sparse import jdia_gather

    dev = A.device
    if isinstance(A, lt.JDIAOperator):
        out = []
        for data, eoff, base, p_lo, m_out, n_out, t in (
                (A.data, A.eoff, A.base, A.p_lo, A.m, A.n, False),
                (A.tdata, A.teoff, A.tbase, A.tp_lo, A.n, A.m, True)):
            own = torch.arange(data.shape[1], device=dev)[None, :].expand_as(data)
            other = jdia_gather(eoff, base, torch.arange(n_out, device=dev, dtype=torch.float64),
                                p_lo=p_lo, tm=A.tm).long()
            out.append((data, other, own) if t else (data, own, other))
        return out + [(A.rem_vals, A.rem_rows, A.rem_cols)]
    if isinstance(A, lt.BlockELLOperator):
        mb, kb, bh, bw = A.blocks.shape
        nb, kt = A.tblocks.shape[:2]
        a = torch.arange(bh, device=dev)
        c = torch.arange(bw, device=dev)
        rows = (torch.arange(mb, device=dev)[:, None, None, None] * bh + a[:, None])
        cols = A.bcols.long()[:, :, None, None] * bw + c
        trows = A.tbrows.long()[:, :, None, None] * bh + a
        tcols = torch.arange(nb, device=dev)[:, None, None, None] * bw + c[:, None]
        return [(A.blocks, rows.expand(mb, kb, bh, bw), cols.expand(mb, kb, bh, bw)),
                (A.tblocks, trows.expand(nb, kt, bw, bh), tcols.expand(nb, kt, bw, bh))]
    if isinstance(A, lt.SumOperator):  # HYB: the ELL part and the COO spill
        E, C = A.ops
        i = torch.arange(E.m, device=dev)[:, None].expand_as(E.cols)
        j = torch.arange(E.n, device=dev)[:, None].expand_as(E.trows)
        return [(E.vals, i, E.cols), (E.tvals, E.trows, j), (C.vals, C.rows, C.cols)]
    if isinstance(A, lt.VStackOperator):  # the warm start's [A; damp I]
        S = A.ops[0]
        nd = len(S.offsets)
        p = torch.arange(S.Lp, device=dev)[None, :].expand(nd, S.Lp) - S.H
        k = torch.tensor(S.offsets, device=dev)[:, None]
        return [(S.dp, p.reshape(-1), (p + k).reshape(-1))]
    return [(A.coo.vals, A.coo.rows, A.coo.cols)]  # WCOO, RWCOO: the triplets


def sigma_max(A, dev, iters=8):
    """A's largest singular value by power iteration on A'A."""
    import torch

    v = torch.randn(A.n, generator=torch.Generator(device=dev).manual_seed(22), device=dev)
    for _ in range(iters):
        v = A.rmatvec(A.matvec(v / v.norm()))
    return float(v.norm()) ** 0.5


def grad_run(A, leaves, b, damp, weights, opts):
    """lsqr_grad's forward and backward on A with the loss <x, weights>:
    (the leaves' gradients, info, forward and backward wall seconds and
    launches)."""
    import torch

    import lsqr_tpu_torch as lt

    info = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for t in leaves:
        t.requires_grad_(True)
    try:
        (x, fwd_s), fwd = counted(lambda: timed(lambda: lt.lsqr_grad(A, b, damp, info=info,
                                                                     **opts)))
        loss = torch.dot(x, weights)
        (grads, bwd_s), bwd = counted(lambda: timed(lambda: torch.autograd.grad(loss, leaves)))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return grads, info, (fwd_s, bwd_s), (fwd, bwd)


def dropped_adjoint_share(run):
    """run() with the gradient's adjoint share (-r s') left out: the planted
    fault the band must catch."""
    from lsqr_tpu_torch import implicit

    real = implicit._value_grads
    implicit._value_grads = lambda A, fwd, adj, want, acc: real(A, fwd, [], want, acc)
    try:
        return run()
    finally:
        implicit._value_grads = real


def grad_check(label, A, coo_of, dev, card, paths, b=None, damp=None, opts=None):
    """One operator of phase 22: the directional derivative of <x, w> in the
    direction v * w(i, j) of its triplet values through A's leaves, against
    the same through the triplets' COO operator (``coo_of(vals)``: the same
    matrix, or the same composite over it, with those COO values), with
    b, damp and the loss unchanged; the same through A with the adjoint
    share dropped. Returns the readings."""
    import torch

    opts = dict(atol=GRAD_ATOL, btol=GRAD_ATOL, itnlim=GRAD_ITNLIM, **(opts or {}))
    g = torch.Generator(device=dev).manual_seed(220)
    if b is None:
        b = torch.randn(A.m, generator=g, device=dev)
    if damp is None:
        damp = GRAD_DAMP * sigma_max(A, dev)
    weights = torch.randn(A.n, generator=g, device=dev)
    positions = packed_positions(A)
    leaves = [t for t, _, _ in positions]

    def reading(grads):
        return sum(float(torch.sum(gr.double() * t.double() * coordinate_weights(r, c)))
                   for gr, (t, r, c) in zip(grads, positions))

    grads, info, (fwd_s, bwd_s), (fwd, bwd) = grad_run(A, leaves, b, damp, weights, opts)
    paths += [fwd, bwd]
    sound = reading(grads)
    del grads
    fault = reading(dropped_adjoint_share(
        lambda: grad_run(A, leaves, b, damp, weights, opts)[0]))
    coo, vals, rows, cols = coo_of()
    (gc,), info_c, _, _ = grad_run(coo, [vals], b, damp, weights,
                                   {k: v for k, v in opts.items() if k != "pair"})
    ref = float(torch.sum(gc.double() * vals.double() * coordinate_weights(rows, cols)))
    del coo, gc
    torch.cuda.empty_cache()
    err, fault_err = abs(sound - ref) / abs(ref), abs(fault - ref) / abs(ref)
    launched = {k: v for k, v in bwd.items() if v}
    log(f"  {label}: damp {float(damp):.4g}; forward istop {info['istop']} itn {info['itn']} "
        f"(COO {info_c['istop']} {info_c['itn']}), CG {info['cg_itn']} iterations (COO "
        f"{info_c['cg_itn']}); forward {fwd_s * 1e3:.3f} ms, backward {bwd_s * 1e3:.3f} ms "
        f"[{card}]; launches forward {({k: v for k, v in fwd.items() if v})}, backward "
        f"{launched}")
    log(f"    directional derivative {sound:.9e} against the COO's {ref:.9e}: {err:.3e}; "
        f"without the adjoint share {fault:.9e}: {fault_err:.3e} (band {GRAD_BAND:g})")
    check(all(torch.isfinite(torch.tensor([sound, ref, fault]))), f"{label}: not finite")
    check(err <= GRAD_BAND, f"{label}: the gradient is off the COO's by {err:.3e}")
    check(fault_err > GRAD_BAND, f"{label}: the band misses a dropped share ({fault_err:.3e})")
    for name in GRAD_KERNELS[label]:
        moved = sum(v for k, v in bwd.items() if base(k).startswith(name))
        check(moved > 0, f"{label}: the backward pass launched no {name}: {launched}")
    return dict(istop=info["istop"], itn=info["itn"], cg_itn=info["cg_itn"],
                cg_itn_coo=info_c["cg_itn"], forward_ms=fwd_s * 1e3, backward_ms=bwd_s * 1e3,
                rel=err, rel_fault=fault_err, damp=float(damp),
                launches_backward=launched)


def phase_grads(dev, kept, card, paths):
    """Phase 22: lsqr_grad on phases 11-15's operators at their full sizes
    (``kept``: label -> (operator, numpy triplets)) and on the damped warm
    start's stack over phase 2's band, each against the COO operator of
    the same triplets."""
    import torch

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.solver import damped_warm_start

    t_phase = time.perf_counter()
    out = {}
    for label, (A, trip) in kept.items():
        def coo_of(trip=trip):
            r_, c_, v_ = coo_on(dev, *trip)
            coo = lt.coo_operator(A.m, A.n, v_, r_, c_, validate=False, device=dev)
            return coo, v_, r_, c_
        opts = dict(pair=True) if label == "block_ell" else None
        out[label] = grad_check(label, A, coo_of, dev, card, paths, opts=opts)
    kept.clear()
    torch.cuda.empty_cache()

    # the warm start's [A; damp I] over phase 2's band: the shared stripes'
    # dp and the diagonal's d (the direction moves the band's values only)
    data, b, g = random_stripes(M_MAIN, M_MAIN, OFFSETS, dev, seed=222, boost=12.0)
    S = lt.dia_shared_operator(M_MAIN, M_MAIN, OFFSETS, data)
    damp = GRAD_DAMP * sigma_max(S, dev)
    x0 = torch.randn(M_MAIN, generator=g, device=dev)
    stacked, rhs = damped_warm_start(S, b, x0, damp)

    def coo_of():
        r_, c_, v_ = stripe_triplets(data, OFFSETS, M_MAIN, M_MAIN)
        coo = lt.coo_operator(M_MAIN, M_MAIN, v_.clone(), r_, c_, validate=False, device=dev)
        return damped_warm_start(coo, b, x0, damp)[0], coo.vals, r_, c_
    out["warm_start"] = grad_check("warm_start", stacked, coo_of, dev, card, paths, b=rhs,
                                   damp=0.0)
    del data, b, S, stacked, rhs, x0
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 22: {out['seconds']:.1f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from lsqr_tpu_torch.ops import _cuda, spmv

    dev = torch.device("cuda")
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    card = smi.splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(sh(_cuda._nvcc(), "--version").splitlines()[-1])
    t_start = t0 = time.perf_counter()

    def phase(label):
        log(f"{label} ({time.perf_counter() - t_start:.0f} s in)")
    lib = _cuda.library()
    log(f"kernel library {lib.path.name}: ready in {time.perf_counter() - t0:.2f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line.lower():
            log("  ptxas:", line.strip())

    phase("phase 1: kernels vs twins")
    errs = {}
    paths = []  # launches by variant of every path run, the direct one included
    times = phase_kernels(dev, [(M_MAIN, M_MAIN, OFFSETS),
                                (300_001, 200_003, (-60, -3, 0, 5)),
                                (200_000, 300_007, (0, 1, 7)), WIDE], errs, paths)
    perf = {}
    for name, (ms, plain_ms, m, n, nd, esize, lib, direct_ms) in times.items():
        perf[name] = dia_perf(name, ms, plain_ms, m, n, nd, esize, lib)
        report(name, perf[name], card)
        if direct_ms is not None:  # the fused half-steps' direct kernel
            perf[name]["direct_ms"] = direct_ms
            log(f"  {name:30s} direct kernel {direct_ms:.4f} ms")
    halfstep, products = ({name: dict(perf[name], bound_ms=bound(
        perf[name]["bytes"], perf[name]["flops"], perf[name]["esize"])[0])
        for name in perf if base(name) in kernels} for kernels in (
            ("dia_product_shared_axpy",), ("dia_product_shared", "dia_matvec")))
    pair_small = phase_pair_routes(dev, M_SMALL, errs, card)

    phase("phases 2-3: main-path solves, shared layout")
    A, b, x_shared, solves = phase_main_solve(dev, M_MAIN, card, paths)
    solves["pair_shared_m" + str(M_SMALL)] = pair_small
    solves["halfstep_main"] = halfstep
    solves["products_main"] = products
    phase("phase 4: auto_operator; the shared pair's unstaged route")
    phase_auto_operator(dev, 2 ** 20, paths)
    solves["unstaged_pair"], many = phase_unstaged_solves(dev, errs, card, paths)
    perf.update(many)  # the ring kernel's rows at the shape its solves take
    phase("phase 5: f64 conformance")
    phase_f64(dev, 2 ** 16, paths)
    phase("phase 6: launches per iteration")
    solves["launch_profile"] = phase_launches(A, b)
    del A, b
    torch.cuda.empty_cache()
    phase("phase 7: the packed layout")
    solves["packed"] = phase_packed_solve(dev, M_MAIN, x_shared, card, paths)
    torch.cuda.empty_cache()
    phase("phase 8: bf16 stripe storage")
    solves["bf16"] = phase_bf16(dev, M_MAIN, x_shared, card, paths)
    torch.cuda.empty_cache()
    phase("phase 9: megakernels vs twins")
    mk_times = phase_megakernels(dev, M_MAIN, errs, card)
    for name, (ms, plain_ms) in mk_times.items():
        # K iterations, each reading both stripe arrays and making its
        # vector passes (neither fits the 50 MB L2)
        esize = 2 if name.endswith("[bf16]") else 4
        per_iter = len(OFFSETS) * 2 * M_MAIN * esize + MK_PASSES[base(name)] * M_MAIN * 4
        perf[name] = perf_entry(ms, plain_ms, MK_K * per_iter,
                                MK_K * 4 * len(OFFSETS) * M_MAIN, esize)
        report(name, perf[name], card)
    phase("phase 10: solves through the megakernels")
    solves["megakernel"] = phase_mk_solves(dev, M_MAIN, card, paths)
    torch.cuda.empty_cache()
    phase("phase 11: general-sparsity kernels vs twins")
    general, jdia, bell = phase_general_kernels(dev, errs, card)
    perf.update(general)
    phase("phase 12: general-sparsity solves")
    solves["general"] = phase_general_solves(dev, jdia, bell, card, paths)
    kept = {"jdia": jdia, "block_ell": bell[M_BELL, M_BELL]}  # phase 22's operators
    del jdia, bell
    torch.cuda.empty_cache()
    phase("phase 13: the routes (plan_general, HYB, step 3)")
    solves["routes"] = phase_routes(dev, card, paths, kept)
    torch.cuda.empty_cache()
    phase("phase 14: WCOO and WWCOO kernels vs twins")
    unstructured, ops = phase_wcoo_kernels(dev, errs, card)
    solves["rwcoo_fused_pair_ms"] = unstructured.pop("rwcoo_fused_pair_ms")
    solves["rwcoo_hot_adjoint_ms"] = unstructured.pop("rwcoo_hot_adjoint_ms")
    solves["wwcoo_band_adjoint_ms"] = unstructured.pop("wwcoo_band_adjoint_ms")
    perf.update(unstructured)
    phase("phase 15: WCOO and RWCOO solves")
    kept.update((label, ops[label][:2]) for label in ("wcoo", "rwcoo"))
    solves["unstructured"] = phase_wcoo_solves(dev, ops, card, paths)
    del ops
    torch.cuda.empty_cache()
    phase("phase 16: complex kernels and operators")
    perf.update(phase_complex_kernels(dev, errs, card))
    phase("phase 17: complex solves")
    solves["complex"] = phase_complex_solves(dev, card, paths)
    phase("phase 18: the streaming ceiling")
    perf["stream_copy"], solves["stream_ceiling_gbs"] = phase_roofline(dev, errs, card, paths)
    phase("phase 19: operator algebra, preconditioning, I/O, utilities, LSRN, refine, hybrid")
    solves["api"] = phase_api(dev, M_MAIN, card, paths)
    phase("phase 20: multi-damp sweeps, batches, regularization paths, gradients")
    solves["rows"] = phase_rows(dev, M_MAIN, card, paths)
    phase("phase 21: sharded solves (1 rank on NCCL, 4 gloo ranks on this card)")
    solves["sharded"] = phase_sharded(dev, card, paths)
    phase("phase 22: gradients to the operators' values (JDIA, BlockELL, HYB, WCOO, RWCOO, "
          "the warm start's stack)")
    solves["grads"] = phase_grads(dev, kept, card, paths)

    launches = {k: sum(p[k] for p in paths) for k in spmv.launch_counts(by_variant=True)}
    log(f"  launches on the direct path and the paths of phases 2-5, 7, 8, 10, 12, 13, 15, "
        f"17-22: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on a path")
    log(json.dumps({"solves": solves, "card": card,
                    "seconds": time.perf_counter() - t_start}))

    # the BlockELL packings timed apart: launches on that packing alone (their
    # kernel's own row counts its launches on every packing)
    packings = solves["general"]["block_ell_packing_launches"]
    for name, count in packings.items():
        check(count > 0, f"{name}: no launch on that packing")
    rows = []
    for name in [*launches, *packings]:
        entry = perf[name]
        bound_ms, bound_by = bound(entry["bytes"], entry["flops"], entry["esize"])
        source = KERNELS[base(name)][0]
        if base(name) in ("dia_pair", "dia_pair_shared") and "unstaged" not in name:
            source = STAGED_PAIR
        elif base(name) in ("dia_matvec", "dia_product_shared", *DIRECT) and "f64" not in name:
            source = STAGED_PRODUCT
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": KERNELS[base(name)][1],
                     "launches": launches[name] if name in launches else packings[name],
                     "max_abs_err": errs[name] if name in errs else errs[base(name)],
                     "ms": entry["ms"],
                     "plain_ms": entry["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": entry["library_ms"]})
        if "direct_ms" in entry:  # the fused half-steps' route where no tile fits
            rows[-1]["direct_ms"] = entry["direct_ms"]
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
