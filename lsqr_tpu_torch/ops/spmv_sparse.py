"""General-sparsity products: the JDIA and BlockELL kernels.

PyTorch counterpart of the JDIA and BlockELL part of
:mod:`lsqr_tpu.ops.pallas_spmv`. Each kernel is written by hand in CUDA C++
and has a plain PyTorch twin beside it in this module:

==========================  ===========================================  ==================
wrapper                     computes                                     source
==========================  ===========================================  ==================
jdia_matvec                 y[i] = sum_s data[s,i] x[i + d(s,tile) + e]  csrc/jdia.cu
block_ell_matvec            y_r = sum_j blocks[r,j] @ x[bcols[r,j]]      csrc/block_ell.cu
block_ell_matvec_windowed   the same (the same kernel)                   csrc/block_ell.cu
block_ell_pair_windowed     u = A(x c1) - c2 y, zp[r,j] = blocks[r,j]' u  csrc/block_ell.cu
==========================  ===========================================  ==================

Each replaces the Pallas kernel of the same name. A wrapper given CPU
tensors runs the twin; given CUDA tensors it launches its kernel or raises,
with no fallback. The kernels take f32 only (f64 operators call the twins
themselves on every device, as the JAX operators take their XLA forms).
The wrappers count their launches with :mod:`.spmv`'s counters
(:func:`~lsqr_tpu_torch.ops.spmv.launch_counts`).

The two BlockELL products share a work plan (:func:`block_ell_plan`): one
CTA per block row, or, where the block rows alone leave the card short of
CTAs (a tall matrix's transpose packing), one per slice of a block row's
blocks, the slices' partial rows added in slice order by a second pass.
The pair runs a cluster of CTAs per block row (:func:`block_ell_pair_plan`),
each rank holding some of the row's blocks, the ranks' partial rows added
in rank order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import spmv

__all__ = [
    "JITTER",
    "jdia_matvec",
    "jdia_gather",
    "jdia_matvec_plain",
    "block_ell_matvec",
    "block_ell_matvec_windowed",
    "block_ell_pair_windowed",
    "block_ell_matvec_plain",
    "block_ell_pair_plain",
    "windowed_rows_per_tile",
    "block_ell_plan",
    "BlockELLPlan",
    "block_ell_pair_plan",
    "PairPlan",
]

#: |e| budget of the jitter offsets (the JAX package's JDIA_JITTER)
JITTER = 32
#: the window of the windowed Pallas kernel's two x-segment buffers: the
#: packings whose block rows fit it take block_ell_matvec_windowed, the others
#: block_ell_matvec (the JAX operator's routing, kept)
WIN_SMEM_BYTES = 96 * 1024
#: the BlockELL products' work units (CTAs) per SM below which a block row's
#: blocks are split into slices (:func:`block_ell_plan`)
UNITS_PER_SM = 4
#: the dynamic shared memory a CTA may have on the H100; a rank of the pair
#: kernel keeps its blocks there when they fit beside their x segments, its
#: partial u and u
PAIR_SMEM_BYTES = 232_448
#: the most CTAs of a pair cluster (the portable cluster size)
PAIR_MAX_RANKS = 8


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def jdia_gather(eoff, base, x, *, p_lo, tm):
    """The x entry each slot position of a JDIA packing multiplies, (ns,
    m_pad): x[i + base[s, i // tm] + JITTER - p_lo + eoff[s, i]], zero
    where that lies outside x (the JAX package's zero-padded x)."""
    ns, m_pad = eoff.shape
    n = x.shape[0]
    rows = torch.arange(m_pad, device=eoff.device)
    d = base[:ns, rows // tm].long() + JITTER            # P_lo + d, per slot and row
    col = rows[None, :] + d + eoff.long() - p_lo          # the column in x
    valid = (col >= 0) & (col < n)
    return torch.where(valid, x[col.clamp(0, max(n - 1, 0))],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def jdia_matvec_plain(data, eoff, base, x, *, m, p_lo, tm):
    """Plain twin of :func:`jdia_matvec`, written from the JAX package's
    ``_jdia_matvec_xla``: the gather of slot values against the padded x
    (:func:`jdia_gather`), summed over the slots."""
    return torch.sum(data * jdia_gather(eoff, base, x, p_lo=p_lo, tm=tm), dim=0)[:m]


def block_ell_matvec_plain(blocks, bcols, x):
    """Plain twin of :func:`block_ell_matvec` and
    :func:`block_ell_matvec_windowed` (the JAX operator's einsum form):
    x (nb*bw,) -> y (mb*bh,)."""
    mb, kb, bh, bw = blocks.shape
    xb = x.reshape(-1, bw)[bcols.long()]                   # (mb, kb, bw)
    return torch.einsum("rkij,rkj->ri", blocks, xb.to(blocks.dtype)).reshape(-1)


def block_ell_pair_plain(blocks, bcols, x, y, c1, c2):
    """Plain twin of :func:`block_ell_pair_windowed`, in the kernel's order
    of sums: each rank's partial rows over its blocks
    (:func:`block_ell_pair_plan`), added in rank order, then - c2*y:
    (u (mb*bh,), zp (mb, kb, bw))."""
    mb, kb, bh, bw = blocks.shape
    dt = blocks.dtype
    c1 = spmv._scalar(c1, dt, blocks.device)
    c2 = spmv._scalar(c2, dt, blocks.device)
    xb = x.to(dt).reshape(-1, bw)[bcols.long()] * c1
    acc = None
    for j0, j1 in block_ell_pair_plan(kb, bh, bw).bounds:
        part = torch.einsum("rkij,rkj->ri", blocks[:, j0:j1], xb[:, j0:j1])
        acc = part if acc is None else acc + part
    ub = acc - c2 * y.to(dt).reshape(mb, bh)
    return ub.reshape(-1), torch.einsum("rkij,ri->rkj", blocks, ub)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _fn(name):
    from . import _cuda

    return getattr(_cuda.library(), name)


def jdia_matvec(data, eoff, base, x, *, m: int, p_lo: int, tm: int):
    """y = A x for a JDIA packing: data (ns, m_pad), eoff (ns, m_pad) int8,
    base (ns_p, nt_p) int32 window starts P_lo + d - JITTER, x (n,) the
    unpadded vector; returns y (m,). Row i of slot s reads
    x[i + base[s, i // tm] + JITTER - p_lo + eoff[s, i]] where that lies in
    [0, n), and 0 elsewhere (the padded x of the JAX kernel, without the
    copy). On CUDA: f32 only."""
    if not data.is_cuda:
        return jdia_matvec_plain(data, eoff, base, x, m=m, p_lo=p_lo, tm=tm)
    ns, m_pad = data.shape
    spmv._check("data", data, torch.float32, data.device, (ns, m_pad))
    spmv._check("eoff", eoff, torch.int8, data.device, (ns, m_pad))
    spmv._check("base", base, torch.int32, data.device, tuple(base.shape))
    spmv._check("x", x, torch.float32, data.device, (x.shape[0],))
    if m > m_pad or m_pad % tm or base.shape[0] < ns or base.shape[1] * tm < m_pad:
        raise ValueError(f"a packing of {m_pad} rows in tiles of {tm} with base "
                         f"{tuple(base.shape)} cannot give {m} rows")
    out = torch.empty(m, dtype=torch.float32, device=data.device)
    if m == 0:
        return out
    spmv._launch(jdia_matvec, _fn("lsqr_jdia_matvec_f32"), data, data.data_ptr(),
                 eoff.data_ptr(), base.data_ptr(), x.data_ptr(), out.data_ptr(), ns,
                 m_pad, base.shape[1], m, x.shape[0], tm, p_lo)
    return out


def _check_blocks(blocks, bcols, x, x_len):
    mb, kb, bh, bw = blocks.shape
    spmv._check("blocks", blocks, torch.float32, blocks.device, tuple(blocks.shape))
    spmv._check("bcols", bcols, torch.int32, blocks.device, (mb, kb))
    spmv._check("x", x, torch.float32, blocks.device, (x_len,))
    if x_len % bw:
        raise ValueError(f"x of length {x_len} is not a whole number of {bw}-wide "
                         "block columns")
    return mb, kb, bh, bw


class BlockELLPlan(NamedTuple):
    """How the BlockELL products cut a packing into work units (one CTA
    each): ``slices`` S per block row, slice s covering blocks
    ``bounds[s]`` = [s*kb // S, (s+1)*kb // S) of every block row (the
    kernels compute the same bounds), and ``scratch`` floats of partial y
    (mb*S*bh; 0 where S = 1 and each unit writes y itself)."""

    slices: int
    bounds: tuple
    scratch: int


def block_ell_plan(mb: int, kb: int, bh: int, sms: int) -> BlockELLPlan:
    """The work plan of :func:`block_ell_matvec` and
    :func:`block_ell_matvec_windowed` for mb block rows of kb (bh-row)
    blocks on a card of ``sms`` SMs: S = 1 where mb already gives
    UNITS_PER_SM CTAs per SM, else the fewest slices (at most kb) that
    do, so a tall matrix's transpose (12 block rows of 164 blocks) is read
    by hundreds of CTAs and not 12. The slices' partial rows are added in
    slice order (no atomics: the same bits in every run)."""
    target = UNITS_PER_SM * sms
    S = 1 if mb >= target or kb <= 1 else min(kb, -(-target // mb))
    bounds = tuple((s * kb // S, (s + 1) * kb // S) for s in range(S))
    return BlockELLPlan(S, bounds, mb * S * bh if S > 1 else 0)


def _product(wrapper, blocks, bcols, x):
    """Launch the BlockELL product kernel on its plan for one of its two
    wrappers (each counts its own launches): y (mb*bh,)."""
    mb, kb, bh, bw = _check_blocks(blocks, bcols, x, x.shape[0])
    out = torch.empty(mb * bh, dtype=torch.float32, device=blocks.device)
    if out.numel() == 0:
        return out
    plan = block_ell_plan(mb, kb, bh, spmv._sm_count(blocks.device.index))
    partial = (torch.empty(plan.scratch, dtype=torch.float32, device=blocks.device)
               if plan.scratch else None)
    spmv._launch(wrapper, _fn("lsqr_block_ell_matvec_f32"), blocks, blocks.data_ptr(), bcols.data_ptr(),
                 x.data_ptr(), out.data_ptr(), 0 if partial is None else partial.data_ptr(),
                 mb, kb, bh, bw, plan.slices)
    return out


def block_ell_matvec(blocks, bcols, x):
    """y = A x for a BlockELL matrix: blocks (mb, kb, bh, bw), bcols
    (mb, kb) int32 block columns, x (nb*bw,); returns y (mb*bh,). Each CTA
    takes a block row, or a slice of one (:func:`block_ell_plan`), and
    streams its blocks straight into registers, several rows a warp at
    once; x segments come from L1/L2. On CUDA: f32 only."""
    if not blocks.is_cuda:
        return block_ell_matvec_plain(blocks, bcols, x)
    return _product(block_ell_matvec, blocks, bcols, x)


def windowed_rows_per_tile(mb: int, kb: int, bw: int, tr: Optional[int] = None) -> int:
    """The windowed Pallas kernel's block rows per tile: ``tr`` (by default
    8, or 1 below 8 block rows, as in JAX) lowered until the two x-segment
    buffers fit WIN_SMEM_BYTES and ``tr`` divides mb. 0 when one block
    row's segments do not fit: the operator then takes
    :func:`block_ell_matvec`, as the JAX operator takes its simple kernel."""
    tr = tr or (8 if mb >= 8 else 1)
    while tr > 0 and 2 * tr * kb * bw * 4 > WIN_SMEM_BYTES:
        tr -= 1
    while tr > 1 and mb % tr:
        tr -= 1
    return tr


def block_ell_matvec_windowed(blocks, bcols, x, *, tr: Optional[int] = None):
    """y = A x for a BlockELL matrix, the packings whose x segments fit the
    windowed Pallas kernel's window (:func:`windowed_rows_per_tile` with
    ``tr``, JAX's tile). The TPU kernel staged x windows in VMEM; on the
    card x lives in L2, and this entry point runs :func:`block_ell_matvec`'s
    kernel and plan, counted under its own name (staging the blocks through
    a shared-memory ring of bulk copies lost at three of the four packings
    the solves take, by 4-13%, and gained under 2% at the fourth: PERF.md).
    Same arguments and result as :func:`block_ell_matvec`; ``tr`` only
    chooses JAX's tile, so it does not move the refusal. On CUDA: f32 only;
    raises ValueError where one block row's segments overflow the window."""
    if not blocks.is_cuda:
        return block_ell_matvec_plain(blocks, bcols, x)
    mb, kb, _, bw = blocks.shape
    if windowed_rows_per_tile(mb, kb, bw, tr) == 0:
        raise ValueError(f"{kb} x-segments of {bw} floats per block row do not fit "
                         f"the windowed kernel's {WIN_SMEM_BYTES}-byte window")
    return _product(block_ell_matvec_windowed, blocks, bcols, x)


def block_ell_pair_windowed(blocks, bcols, x, y, c1, c2):
    """(u, zp) for a BlockELL matrix in one pass over the blocks:
        u = A (x*c1) - c2*y,     zp[r, j] = blocks[r, j]' @ u_r
    with x (nb*bw,), y (mb*bh,), c1, c2 numbers or 0-d tensors (read on the
    device); returns u (mb*bh,) and zp (mb, kb, bw). The caller assembles
    A'u as the sum of the zp rows by bcols. A cluster of CTAs per block row
    (:func:`block_ell_pair_plan`): each rank forms the partial rows of its
    blocks, the partials are added in rank order through distributed shared
    memory, and each rank forms zp for its blocks; a rank keeps its blocks
    in shared memory between the two products where they fit, else reads
    them a second time (from L2). On CUDA: f32 only."""
    if not blocks.is_cuda:
        return block_ell_pair_plain(blocks, bcols, x, y, c1, c2)
    mb, kb, bh, bw = _check_blocks(blocks, bcols, x, x.shape[0])
    spmv._check("y", y, torch.float32, blocks.device, mb * bh)
    c1 = spmv._device_scalar(c1, blocks.device)
    c2 = spmv._device_scalar(c2, blocks.device)
    u = torch.empty(mb * bh, dtype=torch.float32, device=blocks.device)
    zp = torch.empty((mb, kb, bw), dtype=torch.float32, device=blocks.device)
    if u.numel() == 0:
        return u, zp
    smem = torch.cuda.get_device_properties(blocks.device).shared_memory_per_block_optin
    plan = block_ell_pair_plan(kb, bh, bw, smem)
    spmv._launch(block_ell_pair_windowed, _fn("lsqr_block_ell_pair_f32"), blocks,
                 blocks.data_ptr(), bcols.data_ptr(), x.data_ptr(), y.data_ptr(),
                 c1.data_ptr(), c2.data_ptr(), u.data_ptr(), zp.data_ptr(), mb, kb, bh,
                 bw, plan.ranks, int(plan.keep))
    return u, zp


class PairPlan(NamedTuple):
    """How :func:`block_ell_pair_windowed` cuts a block row: a cluster of
    ``ranks`` CTAs, rank s holding blocks ``bounds[s]`` = [s*kb // ranks,
    (s+1)*kb // ranks) (the kernel computes the same bounds); ``keep``
    where each rank holds its blocks in shared memory between the two
    products (beside their x segments, its partial u row and the u row)."""

    ranks: int
    bounds: tuple
    keep: bool


def block_ell_pair_plan(kb: int, bh: int, bw: int, smem: int = PAIR_SMEM_BYTES) -> PairPlan:
    """The pair's plan for block rows of kb (bh x bw) blocks on a card whose
    CTAs may have ``smem`` bytes of dynamic shared memory: one rank a block
    where kb <= PAIR_MAX_RANKS, else PAIR_MAX_RANKS ranks of contiguous
    groups (at most ceil(kb / ranks) blocks each); one rank where kb = 0.
    At kb = 3 and 128 x 128 a rank keeps 67,072 bytes: three CTAs an SM."""
    ranks = max(1, min(kb, PAIR_MAX_RANKS))
    bounds = tuple((s * kb // ranks, (s + 1) * kb // ranks) for s in range(ranks))
    most = -(-kb // ranks)
    return PairPlan(ranks, bounds, 4 * (most * bh * bw + most * bw + 2 * bh) <= smem)


for _wrapper in (jdia_matvec, block_ell_matvec, block_ell_matvec_windowed):
    spmv.register(_wrapper, ("f32",))
spmv.register(block_ell_pair_windowed, ("f32",), work="pair")
