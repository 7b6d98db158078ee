"""Unstructured-sparsity products: the WCOO and WWCOO kernels.

PyTorch counterpart of :mod:`lsqr_tpu.ops.pallas_wcoo` and
:mod:`lsqr_tpu.ops.pallas_wwcoo`. Each kernel is written by hand in CUDA C++
and has a plain PyTorch twin beside it in this module:

==============  ===========================================  ===============
wrapper         computes                                     source
==============  ===========================================  ===============
wcoo_forward    u = A(win) c1 - c2 y, n <= 4096              csrc/wcoo.cu
wcoo_adjoint    z = A' u                                     csrc/wcoo.cu
wcoo_pair       both: u, then z = A' u                       csrc/wcoo.cu
wwcoo_forward   u = A(win) c1 - c2 y, n <= 262,144           csrc/wwcoo.cu
wwcoo_adjoint   z = A' u (compacted columns)                 csrc/wwcoo.cu
wwcoo_pair      both                                         csrc/wwcoo.cu
==============  ===========================================  ===============

Each replaces the Pallas wrapper of the same name. ``packed`` is a
:class:`~lsqr_tpu_torch.ops.wcoo.WCOOPacked` or
:class:`~lsqr_tpu_torch.ops.wwcoo.WWCOOPacked`; y and u may be shorter than
the padded row count ``m_pad`` (the rest reads as 0), and the results are
cut to m and n, as in JAX. A wrapper given a packing on the CPU runs the
twin; on CUDA it launches its kernel or raises, with no fallback. The twins
compute from the same packed arrays as the kernels (the row-sorted copy
and gpe for the forward, the column-sorted copy for the adjoint), so a
layout mistake shows on the CPU too. f32 only, as in JAX.

The WCOO pair is the forward and then the adjoint of its padded u on the
card (csrc/wcoo.cu says why). The WWCOO pair makes one pass over each
chunk's entries for both products where the adjoint's plan has one window
and one split and the chunk's u fits in shared memory beside the plan's
zc (:func:`wwcoo_pair_route`), and takes the forward and the
adjoint's two kernels in turn otherwise, counted as the variant
``wwcoo_pair[sequence]``; every route gives the bits of the forward
followed by the adjoint. Each pair counts one launch per call, as does
each product. Neither adjoint adds with float atomics. The WCOO adjoint sums
per-block partial z (scratch the wrapper allocates,
``ADJOINT_BLOCKS_PER_SM`` blocks per SM) in a fixed order. The WWCOO
adjoint compacts each chunk's z into partials (scratch of nc x S x D_pad
floats, S and the block shape planned by the library from the shape and
the card, :func:`wwcoo_adjoint_plan`) and expands them into z in chunk
order through the packing's inverse column lists. So z is bit-identical
from run to run on both layouts, as u is.
"""

from __future__ import annotations

import functools

import torch

from . import spmv

__all__ = [
    "CR",
    "wwcoo_adjoint_plan",
    "wwcoo_pair_route",
    "wcoo_forward",
    "wcoo_adjoint",
    "wcoo_pair",
    "wwcoo_forward",
    "wwcoo_adjoint",
    "wwcoo_pair",
    "wcoo_forward_plain",
    "wcoo_adjoint_plain",
    "wcoo_pair_plain",
    "wwcoo_forward_plain",
    "wwcoo_adjoint_plain",
    "wwcoo_pair_plain",
]

#: rows per chunk (the TPU kernels' grid step)
CR = 16384
#: bits of the column in the column-sorted index plane: WCOO's idx
#: (col | rowl << 12) and WWCOO's cidx (colc | rowl << 18)
SHIFT = {False: 12, True: 18}
#: blocks of the WCOO adjoint per SM (each adds a range of 1024-slot
#: subtiles into its own z and writes it out as one partial): 8 blocks of
#: 256 threads fill an SM (32 registers a thread, at most 16 KB of shared
#: memory a block); fewer left the H100's memory idle, more only added
#: partials to sum
ADJOINT_BLOCKS_PER_SM = 8


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _padded(v, length):
    """v (f32) zero-padded to ``length``."""
    v = v.to(torch.float32)
    if v.shape[0] == length:
        return v
    return torch.cat([v, v.new_zeros(length - v.shape[0])])


def _columns(packed, cols, wide):
    """Absolute columns of chunk-local column indices (nc, emax): WWCOO's
    pass through each chunk's colmap."""
    cols = cols.long()
    return torch.gather(packed.colmap.long(), 1, cols) if wide else cols


def _forward_plain(packed, win, c1, c2, y, wide):
    """u (m_pad,) = A(win) c1 - c2 y from the row-sorted copy: slot e of
    chunk t belongs to the first row r with gpe[t, r] >= e (none past the
    chunk's last entry)."""
    nc, emax = packed.vals_r.shape
    dev = packed.vals_r.device
    slots = torch.arange(emax, dtype=torch.int32, device=dev).expand(nc, emax).contiguous()
    rows = torch.searchsorted(packed.gpe.contiguous(), slots)
    cols = _columns(packed, packed.col_r, wide)
    n = win.shape[0]
    ok = (rows < CR) & (cols >= 0) & (cols < n)
    win = win.to(torch.float32)
    xv = torch.where(ok, win[cols.clamp(0, max(n - 1, 0))], win.new_zeros(()))
    flat = torch.arange(nc, device=dev)[:, None] * CR + rows
    acc = torch.zeros(packed.m_pad, dtype=torch.float32, device=dev).index_add_(
        0, flat[ok], (packed.vals_r * xv)[ok])
    c1 = spmv._scalar(c1, torch.float32, dev)
    c2 = spmv._scalar(c2, torch.float32, dev)
    return c1 * acc - c2 * _padded(y, packed.m_pad)


def _adjoint_plain(packed, u_pad, wide):
    """z (n,) = A' u from the column-sorted copy, u_pad (m_pad,)."""
    nc, emax = packed.vals.shape
    dev = packed.vals.device
    shift = SHIFT[wide]
    code = (packed.cidx if wide else packed.idx).long() & 0xFFFFFFFF
    cols = _columns(packed, code & ((1 << shift) - 1), wide)
    rows = torch.arange(nc, device=dev)[:, None] * CR + (code >> shift)
    ok = cols < packed.n
    prods = packed.vals * u_pad[rows]
    return torch.zeros(packed.n, dtype=torch.float32, device=dev).index_add_(
        0, cols[ok], prods[ok])


def wcoo_forward_plain(packed, win, c1, c2, y):
    """Plain twin of :func:`wcoo_forward`."""
    return _forward_plain(packed, win, c1, c2, y, False)[:packed.m]


def wcoo_adjoint_plain(packed, u):
    """Plain twin of :func:`wcoo_adjoint`."""
    return _adjoint_plain(packed, _padded(u, packed.m_pad), False)


def wcoo_pair_plain(packed, y, win, c1, c2):
    """Plain twin of :func:`wcoo_pair`."""
    u = _forward_plain(packed, win, c1, c2, y, False)
    return u[:packed.m], _adjoint_plain(packed, u, False)


def wwcoo_forward_plain(packed, win, c1, c2, y):
    """Plain twin of :func:`wwcoo_forward`."""
    return _forward_plain(packed, win, c1, c2, y, True)[:packed.m]


def wwcoo_adjoint_plain(packed, u):
    """Plain twin of :func:`wwcoo_adjoint`."""
    return _adjoint_plain(packed, _padded(u, packed.m_pad), True)


def wwcoo_pair_plain(packed, y, win, c1, c2):
    """Plain twin of :func:`wwcoo_pair`."""
    u = _forward_plain(packed, win, c1, c2, y, True)
    return u[:packed.m], _adjoint_plain(packed, u, True)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _fn(name):
    from . import _cuda

    return getattr(_cuda.library(), name)


def _check_packed(packed, wide):
    """Check the arrays the kernels read; returns their device."""
    dev = packed.vals.device
    nc, emax = packed.nc, packed.eb * 1024
    planes = ("vals", "cidx" if wide else "idx", "vals_r", "col_r")
    for name in planes:
        t = getattr(packed, name)
        spmv._check(name, t, torch.float32 if name.startswith("vals") else torch.int32, dev,
                    (nc, emax))
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the adjoint loads 16 bytes "
                             "a lane)")
    spmv._check("gpe", packed.gpe, torch.int32, dev, (nc, CR))
    if wide:
        spmv._check("colmap", packed.colmap, torch.int32, dev, (nc, packed.js * 128))
        spmv._check("zptr", packed.zptr, torch.int32, dev, (packed.n + 1,))
        spmv._check("zsrc", packed.zsrc, torch.int32, dev, (packed.zsrc.shape[0],))
    if packed.m_pad != nc * CR or packed.m > packed.m_pad:
        raise ValueError(f"{nc} chunks of {CR} rows cannot hold m = {packed.m}")
    return dev


def _vector(name, v, dev, longest, exact=False):
    """Check an f32 vector of at most ``longest`` entries (exactly, when
    ``exact``)."""
    spmv._check(name, v, torch.float32, dev, (v.shape[0],))
    if v.shape[0] > longest or (exact and v.shape[0] != longest):
        raise ValueError(f"{name} has {v.shape[0]} entries, "
                         f"{'not' if exact else 'more than'} {longest}")


def _wide_args(packed, wide):
    return (packed.colmap.data_ptr(), packed.js * 128) if wide else ()


def _lists_args(packed, wide):
    """The WWCOO adjoint's D_pad and inverse column lists."""
    return (packed.js * 128, packed.zptr.data_ptr(), packed.zsrc.data_ptr()) if wide else ()


@functools.lru_cache(maxsize=None)
def wwcoo_adjoint_plan(index, d_pad, eb, nc):
    """The WWCOO adjoint's plan on card ``index`` for nc chunks of eb
    subtiles and d_pad positions: (groups of 8 warps a block, positions a
    window, windows, splits of each chunk's subtiles), from the shape and
    the card only (csrc/chunked_coo.cuh: compact_plan)."""
    import ctypes

    from . import _cuda

    plan = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        _cuda.check(_fn("lsqr_wwcoo_adjoint_plan")(d_pad, eb, nc, plan), "wwcoo_adjoint_plan")
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def wwcoo_pair_route(index, plan):
    """The route :func:`wwcoo_pair` takes on card ``index`` for the
    adjoint's ``plan`` (:func:`wwcoo_adjoint_plan`), as the kernel's library
    chooses it (csrc/chunked_coo.cuh: pair_one_pass): "chunk" (one pass a
    chunk) where the plan has one window and one split and the chunk's u
    fits in shared memory beside the G zc, else "sequence" (the forward,
    then the adjoint's compaction and expansion). The route follows the
    plan, never a failure; both give the same bits."""
    import ctypes

    from . import _cuda

    one = ctypes.c_int(-1)
    groups, wsize, windows, splits = plan
    with torch.cuda.device(index):
        _cuda.check(_fn("lsqr_wwcoo_pair_route")(groups, wsize, windows, splits,
                                                 ctypes.byref(one)), "wwcoo_pair_route")
    return "chunk" if one.value == 1 else "sequence"


def _scratch(packed, dev, wide):
    """The adjoint's arguments between u and z: its partial z and how they
    are laid out, a function of the shape and the card only, so z is summed
    in the same order in every run. WCOO: (blocks, n) f32 and the block
    count; WWCOO: (nc x splits, D_pad) f32 and the plan. Returns
    (arguments, the scratch to keep alive over the launch)."""
    if wide:
        plan = wwcoo_adjoint_plan(dev.index, packed.js * 128, packed.eb, packed.nc)
        partials = torch.empty((packed.nc * plan[3], packed.js * 128), dtype=torch.float32,
                               device=dev)
        return (partials.data_ptr(), *plan), partials
    blocks = min(packed.nc * packed.eb, ADJOINT_BLOCKS_PER_SM * spmv._sm_count(dev.index))
    partials = torch.empty((blocks, packed.n), dtype=torch.float32, device=dev)
    return (partials.data_ptr(), blocks), partials


def _forward(wrapper, packed, win, c1, c2, y, wide):
    dev = _check_packed(packed, wide)
    _vector("win", win, dev, packed.n, exact=True)
    _vector("y", y, dev, packed.m_pad)
    c1 = spmv._device_scalar(c1, dev)
    c2 = spmv._device_scalar(c2, dev)
    u = torch.empty(packed.m_pad, dtype=torch.float32, device=dev)
    name = "lsqr_wwcoo_forward_f32" if wide else "lsqr_wcoo_forward_f32"
    spmv._launch(wrapper, _fn(name), packed.vals_r, packed.vals_r.data_ptr(),
                 packed.col_r.data_ptr(), packed.gpe.data_ptr(), *_wide_args(packed, wide),
                 win.data_ptr(), packed.n, y.data_ptr(), y.shape[0], c1.data_ptr(),
                 c2.data_ptr(), u.data_ptr(), packed.m_pad, packed.eb * 1024)
    return u[:packed.m]


def _adjoint(wrapper, packed, u, wide):
    dev = _check_packed(packed, wide)
    _vector("u", u, dev, packed.m_pad)
    z = torch.empty(packed.n, dtype=torch.float32, device=dev)
    name = "lsqr_wwcoo_adjoint_f32" if wide else "lsqr_wcoo_adjoint_f32"
    index = packed.cidx if wide else packed.idx
    scratch, _keep = _scratch(packed, dev, wide)
    spmv._launch(wrapper, _fn(name), packed.vals, packed.vals.data_ptr(), index.data_ptr(),
                 *_lists_args(packed, wide), u.data_ptr(), u.shape[0], *scratch, z.data_ptr(),
                 packed.n, packed.vals.numel(), packed.eb * 1024)
    return z


def _pair(wrapper, packed, y, win, c1, c2, wide):
    dev = _check_packed(packed, wide)
    _vector("win", win, dev, packed.n, exact=True)
    _vector("y", y, dev, packed.m_pad)
    c1 = spmv._device_scalar(c1, dev)
    c2 = spmv._device_scalar(c2, dev)
    u = torch.empty(packed.m_pad, dtype=torch.float32, device=dev)
    z = torch.empty(packed.n, dtype=torch.float32, device=dev)
    name = "lsqr_wwcoo_pair_f32" if wide else "lsqr_wcoo_pair_f32"
    index = packed.cidx if wide else packed.idx
    scratch, _keep = _scratch(packed, dev, wide)
    variant = None
    if wide and wwcoo_pair_route(dev.index, tuple(scratch[1:])) == "sequence":
        variant = "sequence"  # the plan picks the route (csrc/wwcoo.cu)
    spmv._launch(wrapper, _fn(name), packed.vals_r, packed.vals_r.data_ptr(),
                 packed.col_r.data_ptr(), packed.gpe.data_ptr(), packed.vals.data_ptr(),
                 index.data_ptr(), *_wide_args(packed, wide)[:1],  # colmap
                 *_lists_args(packed, wide),
                 win.data_ptr(), packed.n, y.data_ptr(), y.shape[0], c1.data_ptr(),
                 c2.data_ptr(), u.data_ptr(),
                 *scratch, z.data_ptr(), packed.m_pad, packed.eb * 1024, variant=variant)
    return u[:packed.m], z


def wcoo_forward(packed, win, c1, c2, y):
    """u = A(win) c1 - c2 y for a WCOO packing: win (n,), y (<= m_pad,);
    returns u (m,)."""
    if not packed.vals.is_cuda:
        return wcoo_forward_plain(packed, win, c1, c2, y)
    return _forward(wcoo_forward, packed, win, c1, c2, y, False)


def wcoo_adjoint(packed, u):
    """z = A' u for a WCOO packing: u (<= m_pad,); returns z (n,)."""
    if not packed.vals.is_cuda:
        return wcoo_adjoint_plain(packed, u)
    return _adjoint(wcoo_adjoint, packed, u, False)


def wcoo_pair(packed, y, win, c1, c2):
    """u = A(win) c1 - c2 y and z = A' u (unnormalized); returns (u (m,),
    z (n,))."""
    if not packed.vals.is_cuda:
        return wcoo_pair_plain(packed, y, win, c1, c2)
    return _pair(wcoo_pair, packed, y, win, c1, c2, False)


def wwcoo_forward(packed, win, c1, c2, y):
    """As :func:`wcoo_forward`, for a WWCOO packing."""
    if not packed.vals.is_cuda:
        return wwcoo_forward_plain(packed, win, c1, c2, y)
    return _forward(wwcoo_forward, packed, win, c1, c2, y, True)


def wwcoo_adjoint(packed, u):
    """As :func:`wcoo_adjoint`, for a WWCOO packing."""
    if not packed.vals.is_cuda:
        return wwcoo_adjoint_plain(packed, u)
    return _adjoint(wwcoo_adjoint, packed, u, True)


def wwcoo_pair(packed, y, win, c1, c2):
    """As :func:`wcoo_pair`, for a WWCOO packing."""
    if not packed.vals.is_cuda:
        return wwcoo_pair_plain(packed, y, win, c1, c2)
    return _pair(wwcoo_pair, packed, y, win, c1, c2, True)


for _wrapper in (wcoo_forward, wcoo_adjoint, wcoo_pair, wwcoo_forward, wwcoo_adjoint):
    spmv.register(_wrapper, ("f32",), work="pair" if _wrapper is wcoo_pair else "product")
spmv.register(wwcoo_pair, ("f32", "sequence"), work="pair")
