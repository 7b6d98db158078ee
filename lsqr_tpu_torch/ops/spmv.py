"""DIA products: the ten kernels of the banded paths.

PyTorch counterpart of the DIA part of :mod:`lsqr_tpu.ops.pallas_spmv`.
Each kernel is written by hand in CUDA C++ and has a plain PyTorch twin
beside it in this module:

=========================  =================================  ==================
wrapper                    computes                           source
=========================  =================================  ==================
dia_product_shared         A x or A' y (f32, f64, bf16)       csrc/dia_shared.cu,
                                                              dia_product_staged.cuh
dia_product_shared_axpy    (A or A')(vec*c1) - c2*y           csrc/dia_shared.cu
dia_pair_shared            u = A(vec*c1) - c2*y, z = A' u     csrc/dia_shared.cu,
                                                              dia_pair_staged.cuh
dia_matvec                 A x, packed (f32, f64, bf16)       csrc/dia_packed.cu,
                                                              dia_product_staged.cuh
dia_matvec_axpy            A(win*c1) - c2*y, packed           csrc/dia_packed.cu
dia_fused_halfstep         as dia_matvec_axpy, and sum(out^2) csrc/dia_packed.cu
dia_fused_halfstep_v2      the same in f32 or bf16, the sum   csrc/dia_packed.cu,
                           reduced in the launch              dia_product_staged.cuh
dia_fused_halfstep_v3      the same, the partial sums added   csrc/dia_packed.cu,
                           by the wrapper                     dia_product_staged.cuh
dia_pair                   the pair on packed stripes         csrc/dia_packed.cu,
                                                              dia_pair_staged.cuh
zdia_pair                  the complex pair on two stripe     csrc/zdia.cu
                           planes: u = A(win*c1) - c2*y,
                           z = A^H u
=========================  =================================  ==================

Each replaces the Pallas kernel of the same name. A wrapper given CPU
tensors runs the twin. Given CUDA tensors it launches its kernel or raises:
there is no fallback. Each wrapper counts its launches in its ``launches``
attribute (a plain integer), and per stripe dtype in ``variants``
(:func:`launch_counts`, :func:`reset_launch_counts`); ``dia_pair_shared``
counts its many-diagonal route apart (``UNSTAGED``).

Stripes are f32, f64 where the kernel says so, or bf16: bf16 is a storage
format, so vectors, c1, c2 and the accumulation are f32, and so are the
results, except that ``dia_matvec_axpy`` and ``dia_fused_halfstep`` return
the stripes' dtype as the JAX kernels do (their ``ssq`` stays f32;
``dia_matvec_axpy(out_dtype=torch.float32)`` keeps an f32 result, which the
operators' half-steps and the wide-halo pair take), and so do the two
variants of the fused half-step. ``zdia_pair`` takes f32 planes and
complex64 vectors (read and written as interleaved float2) with real c1, c2.

Shared layout: ``dp`` is the flat ``(nd * Lp,)`` stripe array of
:func:`dia_shared_geometry` with ``dp[d * Lp + H + i] = A[i, i + offsets[d]]``
and zeros elsewhere. Packed layout: ``data`` is ``(nd, m)`` with
``data[d, i] = A[i, i + offsets[d]]``, zero outside the matrix, and no
padding. Both geometries are the JAX package's, so the same bytes serve
both packages.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from .. import tracing

__all__ = [
    "dia_shared_geometry",
    "dia_product_shared",
    "dia_product_shared_axpy",
    "dia_pair_shared",
    "dia_product_shared_plain",
    "dia_product_shared_axpy_plain",
    "dia_pair_shared_plain",
    "dia_matvec",
    "dia_matvec_axpy",
    "dia_fused_halfstep",
    "dia_pair",
    "dia_matvec_plain",
    "dia_matvec_axpy_plain",
    "dia_fused_halfstep_plain",
    "dia_pair_plain",
    "dia_fused_halfstep_v2",
    "dia_fused_halfstep_v3",
    "dia_fused_halfstep_v2_plain",
    "dia_fused_halfstep_v3_plain",
    "zdia_pair",
    "zdia_pair_plain",
    "ZPAIR_BLOCK",
    "launch_counts",
    "reset_launch_counts",
    "register",
    "PAIR_MAX_HALO",
    "pair_tile",
    "pair_shared_route",
    "pair_ring_bytes",
    "axpy_stage_bytes",
    "axpy_tile",
    "product_stage_bytes",
    "product_tile",
    "halfstep_stage_bytes",
    "halfstep_tile",
    "mk_stage_bytes",
    "mk_tile",
    "zpair_stage_bytes",
    "zpair_tile",
    "UNSTAGED",
]

#: the largest halo the one-pass pair kernels take (the staged pairs stage
#: T + lo + hi rows, see :func:`pair_tile`; the shared pair's ring kernel
#: keeps RING_CHUNK + lo + hi, see :func:`pair_ring_bytes`); above it the
#: pair is two launches, the axpy kernel then the product.
PAIR_MAX_HALO = 1024

#: the shared pair's ring kernel (csrc/dia_shared.cu: kRingChunk,
#: kRingAhead): rows a step adds to the ring, and chunks in flight ahead
RING_CHUNK, RING_AHEAD = 128, 0

#: the staged half-step (csrc/dia_shared.cu: kAxpyStages): tiles in shared
#: memory, the one summed included; and its tiles, best first, in two
#: tiers: a tile of at least a block's 256 threads (kAxpyThreads) where one
#: fits, else a smaller one
AXPY_STAGES = 2
AXPY_TILES = ((1024, 512, 256), (128, 64, 32, 16))

#: the staged products of both layouts (csrc/dia_product_staged.cuh:
#: kProductStages): tiles in shared memory, the one summed included; and
#: their tiles, best first, in the half-step's two tiers
PRODUCT_STAGES = 2
PRODUCT_TILES = AXPY_TILES
#: the warps of the staged product's 256-thread block (kProductWarps: the
#: staged fused half-step keeps two tiles' warp sums)
PRODUCT_WARPS = 8

#: the megakernels' staged product phases (csrc/megakernel.cu: kMkStages,
#: kThreads x kMkRows): tiles in shared memory, the one summed included;
#: the tile, two outputs a thread of a 256-thread block; and the kernels'
#: static shared memory (the state, 64 floats, and a block's reduction, 256)
MK_STAGES = 2
MK_TILE = 512
MK_STATIC_BYTES = 4 * (64 + 256)
#: the widest vector window a staged tile takes, in vector reads of the
#: direct route (nd a tile output): T + lo + hi <= MK_SPREAD * nd * T
MK_SPREAD = 3

#: the staged complex pair (csrc/zdia.cu: kZStages), and the spans
#: T + lo + hi of its tiles, best first
ZPAIR_STAGES = 2
ZPAIR_SPANS = (512, 1024, 2048, 4096)

#: the variant under which :func:`dia_pair_shared` counts a launch of its
#: many-diagonal (ring) kernel, by stripe dtype: ``launch_counts(by_variant=True)``
#: names them ``dia_pair_shared[unstaged]`` and
#: ``dia_pair_shared[bf16_unstaged]`` (the route's name: it does not take the
#: staged tiles)
UNSTAGED = {torch.float32: "unstaged", torch.bfloat16: "bf16_unstaged"}

#: kernel-name suffix of each stripe dtype
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def dia_shared_geometry(offsets, m, n, tm_m, tm_n):
    """(H, Lp) of the shared padded stripe array: H = max |k|, and Lp
    covers the last tile's window of either direction for any tile size up
    to max(tm_m, tm_n) (the JAX package's geometry, unchanged)."""
    ks = tuple(offsets)
    H = max(max(ks), -min(ks), 0)
    Lp = 2 * H + max(m, n) + max(tm_m, tm_n) + 1024
    return H, -(-Lp // 1024) * 1024


def _shared_tm(dim):
    """The JAX kernels' tile for a dimension; it fixes Lp, so dp keeps the
    same length in both packages."""
    if dim >= 8_000_000:
        return 65536
    if dim >= 4_000_000:
        return 32768
    if dim >= 8192:
        return 8192
    return 1024 if dim >= 1024 else max(8, dim)


def _geometry(offsets, m, n):
    return dia_shared_geometry(offsets, m, n, _shared_tm(m), _shared_tm(n))


def _acc_dtype(stripes):
    return torch.float32 if stripes.dtype == torch.bfloat16 else stripes.dtype


def _halos(offsets):
    """(lo, hi) = (max(0, -min k), max(0, max k)) of the packed pair."""
    return max(0, -min(offsets)), max(0, max(offsets))


# ---------------------------------------------------------------------------
# Plain twins (written from structured.DIASharedOperator._product_xla,
# structured._dia_matvec_xla, structured.dia_pair_xla and the Pallas kernel
# bodies; same summation order: diagonals in offset order)
# ---------------------------------------------------------------------------


def _slices(dp, vec, offsets, m, n, adjoint):
    """Yield (stripe segment, vector segment) per diagonal, both of length
    dim_out, in the accumulation dtype."""
    H, Lp = _geometry(offsets, m, n)
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    acc = _acc_dtype(dp)
    vecp = torch.zeros(Lp, dtype=acc, device=vec.device)
    vecp[H:H + dim_in] = vec.to(acc)
    for d, k in enumerate(offsets):
        s = (H - k if adjoint else H) + d * Lp
        sv = H - k if adjoint else H + k
        yield dp[s:s + dim_out].to(acc), vecp[sv:sv + dim_out]


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """The SM count of CUDA card ``index`` (the kernels' plans follow it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scalar(c, dtype, device):
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=dtype)
    return torch.tensor(c, dtype=dtype, device=device)


def dia_product_shared_plain(dp, vec, *, offsets, m, n, adjoint):
    """Plain twin of :func:`dia_product_shared`."""
    out = torch.zeros(n if adjoint else m, dtype=_acc_dtype(dp), device=dp.device)
    for seg_d, seg_v in _slices(dp, vec, offsets, m, n, adjoint):
        out = out + seg_d * seg_v
    return out


def dia_product_shared_axpy_plain(dp, vec, y, c1, c2, *, offsets, m, n, adjoint):
    """Plain twin of :func:`dia_product_shared_axpy`."""
    acc_dt = _acc_dtype(dp)
    c1 = _scalar(c1, acc_dt, dp.device)
    c2 = _scalar(c2, acc_dt, dp.device)
    acc = (-c2) * y.to(acc_dt)
    for seg_d, seg_v in _slices(dp, vec, offsets, m, n, adjoint):
        acc = acc + seg_d * (seg_v * c1)
    return acc


def dia_pair_shared_plain(dp, vec, y, c1, c2, *, offsets, m, n):
    """Plain twin of :func:`dia_pair_shared`."""
    u = dia_product_shared_axpy_plain(dp, vec, y, c1, c2, offsets=offsets,
                                      m=m, n=n, adjoint=False)
    return u, dia_product_shared_plain(dp, u, offsets=offsets, m=m, n=n,
                                       adjoint=True)


def _window(vec, s, length):
    """out[j] = vec[j + s] where 0 <= j + s < len(vec), else 0; j < length."""
    out = vec.new_zeros(length)
    lo, hi = max(0, -s), min(length, vec.shape[0] - s)
    if hi > lo:
        out[lo:hi] = vec[lo + s:hi + s]
    return out


def dia_matvec_plain(data, x, *, offsets, m, n, adjoint=False):
    """Plain twin of :func:`dia_matvec`."""
    acc_dt = _acc_dtype(data)
    x = x.to(acc_dt)
    out = torch.zeros(n if adjoint else m, dtype=acc_dt, device=data.device)
    for d, k in enumerate(offsets):
        if adjoint:  # z[j] += data[d, j - k] * x[j - k]
            out = out + _window(data[d].to(acc_dt) * x, -k, n)
        else:        # y[i] += data[d, i] * x[i + k]
            out = out + data[d].to(acc_dt) * _window(x, k, m)
    return out


def _axpy_acc(data, y, win_vec, c1, c2, offsets, m):
    """A (win_vec*c1) - c2*y in the accumulation dtype."""
    acc_dt = _acc_dtype(data)
    xw = win_vec.to(acc_dt) * _scalar(c1, acc_dt, data.device)
    acc = (-_scalar(c2, acc_dt, data.device)) * y.to(acc_dt)
    for d, k in enumerate(offsets):
        acc = acc + data[d].to(acc_dt) * _window(xw, k, m)
    return acc


def dia_matvec_axpy_plain(data, y, win_vec, c1, c2, *, offsets, m, n, out_dtype=None):
    """Plain twin of :func:`dia_matvec_axpy`."""
    return _axpy_acc(data, y, win_vec, c1, c2, offsets, m).to(out_dtype or data.dtype)


def dia_fused_halfstep_plain(data, y, win_vec, c1, c2, *, offsets, m, n):
    """Plain twin of :func:`dia_fused_halfstep`."""
    acc = _axpy_acc(data, y, win_vec, c1, c2, offsets, m)
    return acc.to(data.dtype), torch.sum(acc * acc)


def dia_fused_halfstep_v2_plain(data, y, win_vec, c1, c2, *, offsets, m, n,
                                ssq_out="vmem"):
    """Plain twin of :func:`dia_fused_halfstep_v2`: ``ssq_out`` names a TPU
    memory space and changes nothing here."""
    return dia_fused_halfstep_plain(data, y, win_vec, c1, c2, offsets=offsets, m=m, n=n)


def dia_fused_halfstep_v3_plain(data, y, win_vec, c1, c2, *, offsets, m, n):
    """Plain twin of :func:`dia_fused_halfstep_v3`."""
    return dia_fused_halfstep_plain(data, y, win_vec, c1, c2, offsets=offsets, m=m, n=n)


def dia_pair_plain(data, y, win_vec, c1, c2, *, offsets, m, n):
    """Plain twin of :func:`dia_pair`."""
    u = _axpy_acc(data, y, win_vec, c1, c2, offsets, m)
    return u, dia_matvec_plain(data, u, offsets=offsets, m=m, n=n, adjoint=True)


#: rows per block of :func:`zdia_pair_plain` (the JAX package's _ZPAIR_BLOCK)
ZPAIR_BLOCK = 256 * 1024


def zdia_pair_plain(dr, di, y, win, c1, c2, *, offsets, m, n, block=ZPAIR_BLOCK):
    """Plain twin of :func:`zdia_pair`, written from the JAX package's
    blocked ``zdia_pair_xla`` in its operation order: per block of rows, u
    over the diagonals in offset order on the real and imaginary parts,
    then the conjugate-transpose partials of the block (the planes read
    once for both products), overlap-added into z. f32 planes give
    complex64, f64 planes complex128; c1 and c2 are real."""
    ks = tuple(offsets)
    kmin, kmax = min(ks), max(ks)
    lo = max(0, -kmin)
    dt, dev = dr.dtype, dr.device
    c1, c2 = _scalar(c1, dt, dev), _scalar(c2, dt, dev)
    nb = -(-m // block)
    mp = nb * block
    xp_len = lo + max(n, mp + max(0, kmax))
    xpr, xpi = dr.new_zeros(xp_len), dr.new_zeros(xp_len)
    xpr[lo:lo + n], xpi[lo:lo + n] = win.real.to(dt) * c1, win.imag.to(dt) * c1
    ypr, ypi = dr.new_zeros(mp), dr.new_zeros(mp)
    ypr[:m], ypi[:m] = y.real.to(dt), y.imag.to(dt)
    drp, dip = dr.new_zeros((len(ks), mp)), dr.new_zeros((len(ks), mp))
    drp[:, :m], dip[:, :m] = dr, di
    span = kmax - kmin
    zpr, zpi = dr.new_zeros(xp_len + span), dr.new_zeros(xp_len + span)
    ur, ui = [], []
    for b in range(nb):
        st = b * block
        ubr, ubi = (-c2) * ypr[st:st + block], (-c2) * ypi[st:st + block]
        for d, k in enumerate(ks):
            rj, qj = drp[d, st:st + block], dip[d, st:st + block]
            sr, si = xpr[lo + k + st:lo + k + st + block], xpi[lo + k + st:lo + k + st + block]
            ubr = ubr + rj * sr - qj * si
            ubi = ubi + rj * si + qj * sr
        ur.append(ubr)
        ui.append(ubi)
        # the adjoint's partials while the block's planes are at hand:
        # z[i + k] += conj(A[i, i + k]) u[i]
        zbr, zbi = dr.new_zeros(block + span), dr.new_zeros(block + span)
        for d, k in enumerate(ks):
            rj, qj = drp[d, st:st + block], dip[d, st:st + block]
            zbr[k - kmin:k - kmin + block] += rj * ubr + qj * ubi
            zbi[k - kmin:k - kmin + block] += rj * ubi - qj * ubr
        s0 = st + kmin + lo
        zpr[s0:s0 + block + span] += zbr
        zpi[s0:s0 + block + span] += zbi
    u = torch.complex(torch.cat(ur)[:m], torch.cat(ui)[:m])
    z = torch.complex(zpr[lo:lo + n], zpi[lo:lo + n])
    return u, z


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _offsets_on(stripes, offsets, offsets_t):
    if offsets_t is None:
        offsets_t = torch.tensor(offsets, dtype=torch.int32, device=stripes.device)
    if offsets_t.dtype != torch.int32 or offsets_t.device != stripes.device \
            or offsets_t.shape != (len(offsets),):
        raise ValueError("offsets_t must be an int32 tensor of len(offsets) on "
                         "the stripes' device")
    return offsets_t


def _check(name, t, dtype, device, shape):
    shape = shape if isinstance(shape, tuple) else (shape,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the stripes on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel(name, stripes, dtypes, offsets, tail=""):
    """The library function lsqr_<name>_<suffix><tail> for these stripes,
    after checking their dtype and the number of diagonals."""
    from . import _cuda

    if stripes.dtype not in dtypes:
        raise TypeError(f"stripes of dtype {stripes.dtype}: the kernel takes {dtypes}")
    if not 1 <= len(offsets) <= 1024:
        raise ValueError(f"the kernels take 1 to 1024 diagonals, got {len(offsets)}")
    return getattr(_cuda.library(), f"lsqr_{name}_{_SUFFIX[stripes.dtype]}{tail}")


def _launch(wrapper, fn, stripes, *args, variant=None, **work):
    """Run a launcher, raise on its CUDA error, count the launch (under
    ``variant``, by default the stripes' dtype). While spans are on, one
    launch in ``tracing.SAMPLE`` of the wrapper is a ``kernel`` span
    (:class:`tracing.kernel`); ``work`` overrides the wrapper's declared
    unit (``work=``, ``rows=``) or gives a megakernel launch's
    ``iterations``."""
    from . import _cuda

    variant = variant or _SUFFIX[stripes.dtype]
    stream = torch.cuda.current_stream(stripes.device)
    if tracing.enabled() and wrapper.launches % tracing.SAMPLE == 0:
        with tracing.kernel(wrapper, variant, stream, **work):
            status = fn(*args, stream.cuda_stream)
    else:
        status = fn(*args, stream.cuda_stream)
    _cuda.check(status, wrapper.kernel_name)
    wrapper.launches += 1
    wrapper.variants[variant] += 1


def _device_scalar(c, device):
    c = _scalar(c, torch.float32, device)
    if c.dim() != 0:
        raise ValueError("c1 and c2 must be scalars")
    return c.contiguous()


def _check_shared(dp, offsets, m, n):
    _, Lp = _geometry(offsets, m, n)
    _check("dp", dp, dp.dtype, dp.device, len(offsets) * Lp)


def dia_product_shared(dp, vec, *, offsets: Sequence[int], m: int, n: int,
                       adjoint: bool, offsets_t: Optional[torch.Tensor] = None):
    """y = A x (adjoint=False, vec (n,) -> (m,)) or x = A' y (adjoint=True,
    vec (m,) -> (n,)) from the shared stripes. On CUDA: f32, f64 or bf16
    stripes, with an f32 vector for bf16 and one of the stripes' dtype
    otherwise; f32 and bf16 stripes (``dp`` 16-byte aligned) take the
    staged kernel in tiles of :func:`product_tile` (a vector off the
    16-byte grid is copied), f64 stripes and windows no tile fits the
    direct kernel (one launch either way, the same bits)."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_product_shared_plain(dp, vec, offsets=offsets, m=m, n=n,
                                        adjoint=adjoint)
    return _product_launch(dia_product_shared, dp, vec, offsets=offsets, m=m, n=n,
                           adjoint=adjoint, offsets_t=offsets_t,
                           tile=_product_rule(dp, offsets))


def _product_rule(stripes, offsets):
    """The tile :func:`product_tile` gives these stripes on their card."""
    return product_tile(len(offsets), *_halos(offsets), stripes.dtype.itemsize,
                        *_smem_limits(stripes.device))


def _product_launch(wrapper, stripes, vec, *, offsets: Sequence[int], m: int, n: int,
                    adjoint: bool, offsets_t: Optional[torch.Tensor] = None, tile: int):
    """One launch of a product on CUDA tensors: ``wrapper`` is
    :func:`dia_product_shared` (``stripes`` the shared ``dp``) or
    :func:`dia_matvec` (the packed ``(nd, m)`` stripes, ``adjoint`` its
    column side); the staged kernel in tiles of ``tile``, or the direct
    kernel where ``tile`` is 0. The wrappers pick the tile
    (:func:`product_tile`); a comparison of the two kernels passes 0."""
    offsets = tuple(int(k) for k in offsets)
    shared = wrapper is dia_product_shared
    fn = _kernel(wrapper.kernel_name, stripes,
                 (torch.float32, torch.float64, torch.bfloat16), offsets)
    name, vec_name = ("dp", "vec") if shared else ("data", "x")
    if shared:
        _check_shared(stripes, offsets, m, n)
    else:
        _check("data", stripes, stripes.dtype, stripes.device, (len(offsets), m))
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    acc = _acc_dtype(stripes)
    _check(vec_name, vec, acc, stripes.device, dim_in)
    offsets_t = _offsets_on(stripes, offsets, offsets_t)
    if tile:
        if stripes.dtype == torch.float64:
            raise TypeError("the staged product takes f32 and bf16 stripes; f64 takes tile=0")
        if stripes.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the staged product copies "
                             "it in 16-byte pieces)")
        vec, = _aligned(vec)
    out = torch.empty(dim_out, dtype=acc, device=stripes.device)
    if dim_out == 0:
        return out
    head = (stripes.data_ptr(), vec.data_ptr(), out.data_ptr(), offsets_t.data_ptr(),
            len(offsets))
    if shared:
        H, Lp = _geometry(offsets, m, n)
        head += (Lp, H)
    _launch(wrapper, fn, stripes, *head, dim_out, dim_in, int(adjoint), *_halos(offsets),
            tile)
    return out


def dia_product_shared_axpy(dp, vec, y, c1, c2, *, offsets: Sequence[int],
                            m: int, n: int, adjoint: bool,
                            offsets_t: Optional[torch.Tensor] = None):
    """out = A(vec*c1) - c2*y (adjoint=False) or A'(vec*c1) - c2*y
    (adjoint=True). c1, c2 are numbers or 0-d tensors; on CUDA they stay on
    the device (the kernel reads them through pointers). On CUDA: f32 or
    bf16 stripes (``dp`` 16-byte aligned), f32 vectors; the staged kernel
    in tiles of :func:`axpy_tile` (vectors off the 16-byte grid are
    copied), or, where no tile fits, the direct kernel (one launch
    either way)."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_product_shared_axpy_plain(dp, vec, y, c1, c2, offsets=offsets,
                                             m=m, n=n, adjoint=adjoint)
    tile = axpy_tile(len(offsets), *_halos(offsets), dp.dtype.itemsize,
                     *_smem_limits(dp.device))
    return _axpy_launch(dp, vec, y, c1, c2, offsets=offsets, m=m, n=n, adjoint=adjoint,
                        offsets_t=offsets_t, tile=tile)


def _axpy_launch(dp, vec, y, c1, c2, *, offsets: Sequence[int], m: int, n: int,
                 adjoint: bool, offsets_t: Optional[torch.Tensor] = None, tile: int):
    """One launch of the half-step on CUDA tensors: the staged kernel in
    tiles of ``tile``, or the direct kernel where ``tile`` is 0.
    :func:`dia_product_shared_axpy` picks the tile (:func:`axpy_tile`); a
    comparison of the two kernels passes 0."""
    offsets = tuple(int(k) for k in offsets)
    fn = _kernel("dia_shared_axpy", dp, (torch.float32, torch.bfloat16), offsets)
    _check_shared(dp, offsets, m, n)
    H, Lp = _geometry(offsets, m, n)
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    _check("vec", vec, torch.float32, dp.device, dim_in)
    _check("y", y, torch.float32, dp.device, dim_out)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    c1 = _device_scalar(c1, dp.device)
    c2 = _device_scalar(c2, dp.device)
    lo, hi = _halos(offsets)
    if tile:
        if dp.data_ptr() % 16:
            raise ValueError("dp must be 16-byte aligned (the half-step stages it in "
                             "16-byte copies)")
        vec, y = _aligned(vec, y)
    out = torch.empty(dim_out, dtype=torch.float32, device=dp.device)
    if dim_out == 0:
        return out
    _launch(dia_product_shared_axpy, fn, dp, dp.data_ptr(), vec.data_ptr(),
            y.data_ptr(), c1.data_ptr(), c2.data_ptr(), out.data_ptr(),
            offsets_t.data_ptr(), len(offsets), Lp, H, dim_out, dim_in,
            int(adjoint), lo, hi, tile)
    return out


def pair_ring_bytes(nd, lo, hi, esize):
    """The dynamic shared memory of the shared pair's ring kernel
    (csrc/dia_shared.cu: RingLayout) for nd diagonals, halos lo, hi and
    stripes of ``esize`` bytes: a ring of W = (RING_AHEAD + 1) RING_CHUNK +
    lo + hi rows (rounded up to 16 bytes' worth) of every diagonal, u for
    those rows, a step's x window (RING_CHUNK + lo + hi floats, rounded up
    to 4) and two ints a diagonal (nd rounded up to 4). It takes the pair
    where this fits one block's shared memory."""
    v = 16 // esize
    W = -(-((RING_AHEAD + 1) * RING_CHUNK + lo + hi) // v) * v
    LX = -(-(RING_CHUNK + lo + hi) // 4) * 4
    return -(-nd * W * esize // 16) * 16 + 4 * W + 4 * LX + 8 * -(-nd // 4) * 4


def _round_up(v, q):
    return -(-v // q) * q


def _fit_tile(tiers, nbytes, per_sm, optin, one_block=True):
    """A tile from ``tiers`` (lists of tiles, best first): in the first tier
    that has one, the first tile whose shared memory (``nbytes(T)``) fits
    two blocks an SM (the card keeps 1 KB a block) or, where none in the
    tier does and ``one_block`` allows it, the first that fits one block; 0
    where no tile fits."""
    budgets = (per_sm // 2 - 1024, optin) if one_block else (per_sm // 2 - 1024,)
    for tier in tiers:
        for budget in budgets:
            for T in tier:
                if nbytes(T) <= budget:
                    return T
    return 0


def axpy_stage_bytes(nd, lo, hi, T, esize, stages=AXPY_STAGES):
    """The dynamic shared memory of the staged half-step
    (csrc/dia_shared.cu: AxpyLayout) in tiles of T for nd diagonals, halos
    lo, hi (either direction: their sum counts) and stripes of ``esize``
    bytes: ``stages`` stages of nd rows of T + 16/esize stripe elements,
    the vector window (T + lo + hi floats and 3 in front, rounded up to 4)
    and T floats of y; then nd ints (rounded up to 4)."""
    stage = nd * (T + 16 // esize) * esize + (_round_up(T + lo + hi + 3, 4) + T) * 4
    return stages * stage + 4 * _round_up(nd, 4)


@functools.lru_cache(maxsize=None)
def axpy_tile(nd, lo, hi, esize, per_sm, optin):
    """The staged half-step's tile for a card with ``per_sm`` bytes of
    shared memory an SM and ``optin`` a block: of the tiers of AXPY_TILES,
    the largest tile whose stages fit two blocks an SM, else one block (at
    2^20 x 81 in f32 one block of T = 256 beat two of T = 128: PERF.md); 0
    where none fits (a vector window too wide: lo + hi above about 29,000),
    and :func:`dia_product_shared_axpy` then takes the direct kernel. At
    lo + hi = 0 the rule takes every nd the kernels take (1024) in f32 and
    bf16, with T = 16 from nd = 395 (f32) and 703 (bf16) on the H100."""
    return _fit_tile(AXPY_TILES, lambda T: axpy_stage_bytes(nd, lo, hi, T, esize),
                     per_sm, optin)


def product_stage_bytes(nd, lo, hi, T, esize, stages=PRODUCT_STAGES):
    """The dynamic shared memory of the staged product of both layouts
    (csrc/dia_product_staged.cuh: ProductLayout) in tiles of T for nd
    diagonals, halos lo, hi (either direction: their sum counts) and stripes
    of ``esize`` bytes: ``stages`` stages of nd rows of T + 16/esize stripe
    elements and the vector window (T + lo + hi floats and 3 in front,
    rounded up to 4); then two ints a diagonal (nd rounded up to 4 each):
    the offsets and the rows' 16-byte phases."""
    stage = nd * (T + 16 // esize) * esize + _round_up(T + lo + hi + 3, 4) * 4
    return stages * stage + 8 * _round_up(nd, 4)


@functools.lru_cache(maxsize=None)
def product_tile(nd, lo, hi, esize, per_sm, optin):
    """The staged product's tile (:func:`dia_product_shared`,
    :func:`dia_matvec`) for a card with ``per_sm`` bytes of shared memory an
    SM and ``optin`` a block: of the tiers of PRODUCT_TILES, the largest
    tile whose stages fit two blocks an SM, else one block (the half-step's
    rule, :func:`axpy_tile`); 0 for f64 stripes (``esize`` 8: their vectors
    are f64, which the f32 stages do not take) and where no tile fits (a
    vector window too wide: lo + hi above about 29,000 in f32), and the
    wrappers then take the direct kernel."""
    if esize == 8:
        return 0
    return _fit_tile(PRODUCT_TILES, lambda T: product_stage_bytes(nd, lo, hi, T, esize),
                     per_sm, optin)


def halfstep_stage_bytes(nd, lo, hi, T, esize, stages=PRODUCT_STAGES):
    """The dynamic shared memory of the staged fused half-step
    (:func:`dia_fused_halfstep_v2`, ``_v3``: csrc/dia_product_staged.cuh,
    ProductLayout with a step) in tiles of T: the staged product's
    (:func:`product_stage_bytes`) with T floats of y in each stage, and two
    tiles' warp sums (2 PRODUCT_WARPS floats) after the offsets and
    phases."""
    return (product_stage_bytes(nd, lo, hi, T, esize, stages) + stages * 4 * T
            + 8 * PRODUCT_WARPS)


@functools.lru_cache(maxsize=None)
def halfstep_tile(nd, lo, hi, esize, per_sm, optin):
    """The staged fused half-step's tile on a card with ``per_sm`` bytes of
    shared memory an SM and ``optin`` a block. bf16 stripes: the product's
    rule (:func:`product_tile`) over :func:`halfstep_stage_bytes` and the
    tiers of PRODUCT_TILES. f32 stripes: a tile of the first tier (at
    least a block's 256 threads) whose stages fit two blocks an SM, else 0:
    on the H100 at 2^20 rows the staged f32 route beat the direct kernel by
    up to 10% or matched it within 1.2% from 11 to 53 diagonals (two blocks
    of 256 or more), and lost to it by 12-20% at 61 and 81 (one block) and
    by 22% with two blocks of 128 at 81 (PERF.md, ``tools/product_designs.py``).
    0 also where no tile fits (a vector window
    too wide: lo + hi above about 28,900 in bf16, 11,100 in f32), and the
    two variants then take their direct kernels. Each tile writes one
    partial sum of squares: the wrappers size the slots to ceil(m / T)."""
    nbytes = lambda T: halfstep_stage_bytes(nd, lo, hi, T, esize)  # noqa: E731
    if esize == 4:
        return _fit_tile(PRODUCT_TILES[:1], nbytes, per_sm, optin, one_block=False)
    return _fit_tile(PRODUCT_TILES, nbytes, per_sm, optin)


def mk_stage_bytes(nd, lo, hi, T, esize, stages=MK_STAGES):
    """The dynamic shared memory of the megakernels' staged phases
    (csrc/megakernel.cu: MkLayout) in tiles of T for nd diagonals, halos
    lo, hi (either direction: their sum counts) and stripes of ``esize``
    bytes: ``stages`` stages of nd rows of T + 16/esize stripe elements,
    the vector window (T + lo + hi floats and 3 in front, rounded up to 4)
    and T + 4 floats of y (any vector's 16-byte phase); then four ints a
    diagonal (nd rounded up to 4): each direction's offsets and row
    phases."""
    stage = nd * (T + 16 // esize) * esize + (_round_up(T + lo + hi + 3, 4) + T + 4) * 4
    return stages * stage + 16 * _round_up(nd, 4)


@functools.lru_cache(maxsize=None)
def mk_tile(nd, lo, hi, esize, optin):
    """The megakernels' staged tile on a card whose block may opt in to
    ``optin`` bytes of shared memory: MK_TILE where its stages and the
    kernels' static shared memory fit one block and its vector window (T +
    lo + hi floats a tile, copied from L2) is at most MK_SPREAD times the
    direct route's vector reads (nd a tile output, through L2), else 0 (many
    diagonals, a sparse band whose offsets spread wide, or a window as wide
    as offsets of +-m/2 need), and both product phases then take the direct
    route. On the H100 it takes up to 53 diagonals in f32 and 106 in bf16
    (lo + hi = 0, and the main band's 10). One block an SM is enough: at
    2^20 rows and 31-53 diagonals (one f32 block an SM) the staged LSQR
    megakernel beat the direct one by 23-34% (PERF.md,
    tools/megakernel_designs.py)."""
    fits = mk_stage_bytes(nd, lo, hi, MK_TILE, esize) + MK_STATIC_BYTES <= optin
    dense = MK_TILE + lo + hi <= MK_SPREAD * nd * MK_TILE
    return MK_TILE if fits and dense else 0


def zpair_stage_bytes(nd, lo, hi, T, stages=ZPAIR_STAGES):
    """The dynamic shared memory of the staged complex pair (csrc/zdia.cu:
    ZPairLayout) in tiles of T for nd diagonals and halos lo, hi:
    ``stages`` stages of 2 nd plane rows (the span T + lo + hi and 3 in
    front, rounded up to 4 floats), win (span + lo + hi complex64 and 1 in
    front, rounded up to 2) and y (span and 1, rounded up to 2); u for the
    span (rounded up to 2) and two ints a diagonal (nd rounded up to 4)."""
    span = T + lo + hi
    stage = 2 * nd * _round_up(span + 3, 4) * 4 + (
        _round_up(span + lo + hi + 1, 2) + _round_up(span + 1, 2)) * 8
    return stages * stage + _round_up(span, 2) * 8 + 8 * _round_up(nd, 4)


@functools.lru_cache(maxsize=None)
def zpair_tile(nd, lo, hi, per_sm, optin):
    """The staged complex pair's tile on such a card: T = P - (lo + hi
    rounded up to 4) for the first span P of ZPAIR_SPANS with T >= lo + hi
    whose stages fit two blocks an SM, else one (the smaller span with more
    blocks an SM was the faster at bench.py's zdia shape: PERF.md); 0 where
    none fits (many diagonals, or halos near PAIR_MAX_HALO), and
    :func:`zdia_pair` then takes two launches."""
    halo = _round_up(lo + hi, 4)
    tiles = [P - halo for P in ZPAIR_SPANS if P - halo >= max(lo + hi, 1)]
    return _fit_tile([tiles], lambda T: zpair_stage_bytes(nd, lo, hi, T), per_sm, optin)


@functools.lru_cache(maxsize=None)
def _smem_limits(device):
    """(shared memory an SM, the most one block may opt in to) on ``device``."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_multiprocessor, props.shared_memory_per_block_optin


def _aligned(*ts):
    """The tensors, each copied where it lies off the 16-byte grid (the
    staged kernels copy them in 16-byte pieces)."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def pair_shared_route(H, tile, ring):
    """The route :func:`dia_pair_shared` takes on the card for a band of
    halo H (max |k|), a staged tile (:func:`pair_tile`, 0 where none fits)
    and whether the ring kernel's shared memory fits (``ring``,
    :func:`pair_ring_bytes`): "two launches" where H > PAIR_MAX_HALO or
    neither kernel fits, else "staged" where a tile fits, else "unstaged"
    (the ring kernel)."""
    if H > PAIR_MAX_HALO or not (tile or ring):
        return "two launches"
    return "staged" if tile else "unstaged"


def _ring_fits(device, dtype, nd, lo, hi):
    """Whether the ring kernel's shared memory fits one block on ``device``."""
    return pair_ring_bytes(nd, lo, hi, dtype.itemsize) <= _smem_limits(device)[1]


def dia_pair_shared(dp, vec, y, c1, c2, *, offsets: Sequence[int], m: int,
                    n: int, offsets_t: Optional[torch.Tensor] = None):
    """Both bidiagonalization products in one pass over the stripes:
    u = A(vec*c1) - c2*y with vec (n,), y (m,), and z = A' u. Returns
    (u (m,), z (n,)). On CUDA: f32 or bf16 stripes (``dp`` 16-byte
    aligned), f32 vectors, and one of three routes
    (:func:`pair_shared_route`), each counted:

    * staged, where :func:`pair_tile` gives a tile for the diagonals, the
      one-sided halos lo = max(0, -min k), hi = max(0, max k) and the
      stripes' dtype: the staged pair of csrc/dia_pair_staged.cuh on this
      layout (vector views off the 16-byte grid are copied);
    * unstaged, where no tile fits (many diagonals), H <= PAIR_MAX_HALO and
      the ring kernel's shared memory fits (:func:`pair_ring_bytes`): the
      ring kernel of csrc/dia_shared.cu, counted under ``UNSTAGED``; it
      gives the staged route's bits (same order, same expressions);
    * two launches, where H > PAIR_MAX_HALO or neither fits:
      :func:`dia_product_shared_axpy`, then :func:`dia_product_shared`
      (each counts its own launch)."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_pair_shared_plain(dp, vec, y, c1, c2, offsets=offsets, m=m, n=n)
    _kernel("dia_pair_shared", dp, (torch.float32, torch.bfloat16), offsets)  # the checks
    H, _ = _geometry(offsets, m, n)
    tile = pair_tile(dp.device, dp.dtype, len(offsets), *_halos(offsets))
    ring = not tile and _ring_fits(dp.device, dp.dtype, len(offsets), *_halos(offsets))
    if pair_shared_route(H, tile, ring) == "two launches":
        _check_shared(dp, offsets, m, n)
        offsets_t = _offsets_on(dp, offsets, offsets_t)
        u = dia_product_shared_axpy(dp, vec, y, c1, c2, offsets=offsets, m=m,
                                    n=n, adjoint=False, offsets_t=offsets_t)
        return u, dia_product_shared(dp, u, offsets=offsets, m=m, n=n,
                                     adjoint=True, offsets_t=offsets_t)
    return _dia_pair_shared_launch(dp, vec, y, c1, c2, offsets=offsets, m=m, n=n,
                                   offsets_t=offsets_t, tile=tile)


def _dia_pair_shared_launch(dp, vec, y, c1, c2, *, offsets: Sequence[int], m: int,
                            n: int, offsets_t: Optional[torch.Tensor] = None,
                            tile: int):
    """One launch of the shared pair on CUDA tensors (the kernels refuse
    H > PAIR_MAX_HALO, and the ring kernel a ring past the card's shared
    memory): the staged kernel in tiles of ``tile`` (:func:`pair_tile`), or
    the ring kernel where ``tile`` is 0, counted under ``UNSTAGED``.
    :func:`dia_pair_shared` picks the tile; a comparison of the two kernels
    passes 0 for the ring kernel."""
    offsets = tuple(int(k) for k in offsets)
    fn = _kernel("dia_pair_shared_staged" if tile else "dia_pair_shared", dp,
                 (torch.float32, torch.bfloat16), offsets)
    _check_shared(dp, offsets, m, n)
    H, Lp = _geometry(offsets, m, n)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    _check("vec", vec, torch.float32, dp.device, n)
    _check("y", y, torch.float32, dp.device, m)
    c1 = _device_scalar(c1, dp.device)
    c2 = _device_scalar(c2, dp.device)
    if dp.data_ptr() % 16:
        raise ValueError("dp must be 16-byte aligned (the pair stages it in 16-byte "
                         "copies)")
    if tile:  # the staged kernel stages the vectors too
        vec, y = _aligned(vec, y)
    u = torch.empty(m, dtype=torch.float32, device=dp.device)
    z = torch.empty(n, dtype=torch.float32, device=dp.device)
    if max(m, n) == 0:
        return u, z
    args = (dp.data_ptr(), vec.data_ptr(), y.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            u.data_ptr(), z.data_ptr(), offsets_t.data_ptr(), len(offsets), Lp, H, m, n,
            *_halos(offsets))
    if tile:
        _launch(dia_pair_shared, fn, dp, *args, tile)
    else:
        _launch(dia_pair_shared, fn, dp, *args, variant=UNSTAGED[dp.dtype])
    return u, z


def dia_matvec(data, x, *, offsets: Sequence[int], m: int, n: int,
               adjoint: bool = False, offsets_t: Optional[torch.Tensor] = None):
    """y = A x from the packed stripes ``data`` (nd, m), x (n,) -> (m,).
    The adjoint product of the operator runs this on its transpose stripes
    ``tdata`` with the negated offsets (as in the JAX package);
    ``adjoint=True`` instead reads ``data`` from the column side,
    x (m,) -> A' x (n,). On CUDA: f32, f64 or bf16 stripes, with an f32
    vector for bf16 and one of the stripes' dtype otherwise; f32 and bf16
    stripes (16-byte aligned) take the staged kernel in tiles of
    :func:`product_tile` (a vector off the 16-byte grid is copied), f64
    stripes and windows no tile fits the direct kernel (one launch either
    way, the same bits)."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_matvec_plain(data, x, offsets=offsets, m=m, n=n, adjoint=adjoint)
    return _product_launch(dia_matvec, data, x, offsets=offsets, m=m, n=n, adjoint=adjoint,
                           offsets_t=offsets_t, tile=_product_rule(data, offsets))


def _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n, offsets_t):
    _check("data", data, data.dtype, data.device, (len(offsets), m))
    _check("y", y, torch.float32, data.device, m)
    _check("win_vec", win_vec, torch.float32, data.device, n)
    return (_offsets_on(data, offsets, offsets_t), _device_scalar(c1, data.device),
            _device_scalar(c2, data.device))


def dia_matvec_axpy(data, y, win_vec, c1, c2, *, offsets: Sequence[int], m: int,
                    n: int, offsets_t: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None):
    """out = A (win_vec*c1) - c2*y in one pass over the packed stripes
    ``data`` (nd, m), with y (m,), win_vec (n,). c1, c2 are numbers or 0-d
    tensors (read on the device). On CUDA: f32 or bf16 stripes, f32
    vectors. The result has the stripes' dtype (bf16 for bf16 stripes, the
    f32 sum rounded on the store, as in the JAX kernel), or ``out_dtype``
    (f32 only, for bf16 stripes)."""
    offsets = tuple(int(k) for k in offsets)
    out_dtype = out_dtype or data.dtype
    if out_dtype not in (data.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the stripes' dtype or float32")
    if not data.is_cuda:
        return dia_matvec_axpy_plain(data, y, win_vec, c1, c2, offsets=offsets,
                                     m=m, n=n, out_dtype=out_dtype)
    tail = "_f32out" if out_dtype != data.dtype else ""
    fn = _kernel("dia_matvec_axpy", data, (torch.float32, torch.bfloat16), offsets, tail)
    offsets_t, c1, c2 = _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n,
                                          offsets_t)
    out = torch.empty(m, dtype=out_dtype, device=data.device)
    if m == 0:
        return out
    _launch(dia_matvec_axpy, fn, data, data.data_ptr(), win_vec.data_ptr(),
            y.data_ptr(), c1.data_ptr(), c2.data_ptr(), out.data_ptr(),
            offsets_t.data_ptr(), len(offsets), m, n)
    return out


#: per (device, stream): the fused half-steps' int32 ticket, 0 between launches
_TICKETS: dict = {}
#: the fused half-step kernels' grid cap (kReduceBlocks in csrc/dia_packed.cu)
_REDUCE_BLOCKS = 1024


def _ticket(device):
    """The int32 ticket of the current stream: launches on one stream run
    in order, and each kernel that takes a ticket leaves it at 0."""
    stream = torch.cuda.current_stream(device).cuda_stream
    ticket = _TICKETS.get((device, stream))
    if ticket is None:
        ticket = _TICKETS[(device, stream)] = torch.zeros(1, dtype=torch.int32,
                                                          device=device)
    return ticket


def dia_fused_halfstep(data, y, win_vec, c1, c2, *, offsets: Sequence[int],
                       m: int, n: int, offsets_t: Optional[torch.Tensor] = None):
    """One pass over the packed stripes computing
        out = A (win_vec*c1) - c2*y,     ssq = sum(out**2)
    with data (nd, m), y (m,), win_vec (n,). Returns (out, ssq), ssq an f32
    0-d tensor of the unrounded sum and out in the stripes' dtype (the twin
    takes bf16 stripes too). On CUDA: f32 only; the sum of squares is
    reduced in the same launch, in a fixed order (deterministic)."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_fused_halfstep_plain(data, y, win_vec, c1, c2, offsets=offsets,
                                        m=m, n=n)
    # one thread an output; the last block adds the blocks' partial sums in
    # slot order
    fn = _kernel("dia_fused_halfstep", data, (torch.float32,), offsets)
    offsets_t, c1, c2 = _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n,
                                          offsets_t)
    out = torch.empty(m, dtype=data.dtype, device=data.device)
    if m == 0:
        return out, torch.zeros((), dtype=torch.float32, device=data.device)
    partial = torch.empty(min(-(-m // 256), _REDUCE_BLOCKS), dtype=torch.float32,
                          device=data.device)
    ssq = torch.empty((), dtype=torch.float32, device=data.device)
    _launch(dia_fused_halfstep, fn, data, data.data_ptr(), win_vec.data_ptr(), y.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), out.data_ptr(), partial.data_ptr(),
            _ticket(data.device).data_ptr(), ssq.data_ptr(), offsets_t.data_ptr(),
            len(offsets), m, n, partial.shape[0])
    return out, ssq


def _halfstep_rule(data, offsets):
    """The tile :func:`halfstep_tile` gives these stripes on their card."""
    return halfstep_tile(len(offsets), *_halos(offsets), data.dtype.itemsize,
                         *_smem_limits(data.device))


def dia_fused_halfstep_v2(data, y, win_vec, c1, c2, *, offsets: Sequence[int], m: int,
                          n: int, ssq_out: str = "vmem",
                          offsets_t: Optional[torch.Tensor] = None):
    """As :func:`dia_fused_halfstep` (out = A (win_vec*c1) - c2*y and
    ssq = sum of the unrounded out squared), for f32 or bf16 stripes: out
    in the stripes' dtype, ssq an f32 0-d tensor reduced in the same
    launch. ``ssq_out`` picks a TPU memory space in the JAX kernel; any
    value computes the same here. On CUDA: f32 vectors, ``data`` 16-byte
    aligned; the staged kernel in tiles of :func:`halfstep_tile` (vectors
    off the 16-byte grid are copied), or, where no tile fits, the direct
    kernel (one launch either way, out with the same bits)."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_fused_halfstep_v2_plain(data, y, win_vec, c1, c2, offsets=offsets,
                                           m=m, n=n, ssq_out=ssq_out)
    return _halfstep_launch(dia_fused_halfstep_v2, data, y, win_vec, c1, c2, offsets=offsets,
                            m=m, n=n, offsets_t=offsets_t, tile=_halfstep_rule(data, offsets))


def dia_fused_halfstep_v3(data, y, win_vec, c1, c2, *, offsets: Sequence[int], m: int,
                          n: int, offsets_t: Optional[torch.Tensor] = None):
    """As :func:`dia_fused_halfstep_v2`, but the launch leaves its partial
    sums of squares in slots of their own (no ticket, no block reads
    another's slot), and the wrapper adds the slots with ``torch.sum``, as
    the JAX wrapper adds its per-tile partials: one slot a tile on the
    staged route, one a block on the direct one."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_fused_halfstep_v3_plain(data, y, win_vec, c1, c2, offsets=offsets,
                                           m=m, n=n)
    return _halfstep_launch(dia_fused_halfstep_v3, data, y, win_vec, c1, c2, offsets=offsets,
                            m=m, n=n, offsets_t=offsets_t, tile=_halfstep_rule(data, offsets))


def _halfstep_launch(wrapper, data, y, win_vec, c1, c2, *, offsets: Sequence[int], m: int,
                     n: int, offsets_t: Optional[torch.Tensor] = None, tile: int):
    """One launch of a fused half-step variant (``wrapper`` is
    :func:`dia_fused_halfstep_v2` or ``_v3``) on CUDA tensors: (out, ssq).
    The staged kernel in tiles of ``tile``, one partial sum of squares a
    tile (ceil(m / tile) slots), or the direct kernel where ``tile`` is 0,
    one a block (min(ceil(m / 256), _REDUCE_BLOCKS) slots). The wrappers
    pick the tile (:func:`halfstep_tile`); a comparison of the two kernels
    passes 0."""
    offsets = tuple(int(k) for k in offsets)
    fn = _kernel(wrapper.kernel_name, data, (torch.float32, torch.bfloat16), offsets)
    offsets_t, c1, c2 = _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n,
                                          offsets_t)
    if tile:
        if data.data_ptr() % 16:
            raise ValueError("data must be 16-byte aligned (the staged half-step copies it "
                             "in 16-byte pieces)")
        win_vec, y = _aligned(win_vec, y)
    out = torch.empty(m, dtype=data.dtype, device=data.device)
    if m == 0:
        return out, torch.zeros((), dtype=torch.float32, device=data.device)
    slots = -(-m // tile) if tile else min(-(-m // 256), _REDUCE_BLOCKS)
    partial = torch.empty(slots, dtype=torch.float32, device=data.device)
    head = (data.data_ptr(), win_vec.data_ptr(), y.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            out.data_ptr(), partial.data_ptr())
    tail = (offsets_t.data_ptr(), len(offsets), m, n, slots, *_halos(offsets), tile)
    if wrapper is dia_fused_halfstep_v3:
        _launch(wrapper, fn, data, *head, *tail)
        return out, torch.sum(partial)
    ssq = torch.empty((), dtype=torch.float32, device=data.device)
    _launch(wrapper, fn, data, *head, _ticket(data.device).data_ptr(), ssq.data_ptr(), *tail)
    return out, ssq


def dia_pair(data, y, win_vec, c1, c2, *, offsets: Sequence[int], m: int, n: int,
             offsets_t: Optional[torch.Tensor] = None):
    """Both bidiagonalization products in one pass over the packed stripes:
        u = A (win_vec*c1) - c2*y,     z = A' u
    with data (nd, m), y (m,), win_vec (n,); z comes from the same
    row-aligned stripes read from the column side. Returns (u (m,), z (n,)).
    On CUDA: f32 or bf16 stripes (16-byte aligned), f32 vectors. The kernel
    stages each tile of T indices' stripe rows, x window and y rows in
    shared memory (csrc/dia_packed.cu); T comes from the number of
    diagonals, the halos and the stripes' dtype (:func:`pair_tile`). Where
    no tile fits, or lo = max(0, -min k) or hi = max(0, max k) exceeds
    PAIR_MAX_HALO, the pair is two launches: :func:`dia_matvec_axpy`, then
    :func:`dia_matvec` with ``adjoint=True`` (each counts its own
    launch)."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_pair_plain(data, y, win_vec, c1, c2, offsets=offsets, m=m, n=n)
    fn = _kernel("dia_pair", data, (torch.float32, torch.bfloat16), offsets)
    offsets_t, c1, c2 = _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n,
                                          offsets_t)
    lo, hi = _halos(offsets)
    tile = pair_tile(data.device, data.dtype, len(offsets), lo, hi)
    if tile == 0:
        u = dia_matvec_axpy(data, y, win_vec, c1, c2, offsets=offsets, m=m, n=n,
                            offsets_t=offsets_t, out_dtype=torch.float32)
        return u, dia_matvec(data, u, offsets=offsets, m=m, n=n, adjoint=True,
                             offsets_t=offsets_t)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned (the pair stages it in 16-byte "
                         "copies)")
    win_vec, y = _aligned(win_vec, y)  # the vectors are staged likewise
    u = torch.empty(m, dtype=torch.float32, device=data.device)
    z = torch.empty(n, dtype=torch.float32, device=data.device)
    if max(m, n) == 0:
        return u, z
    _launch(dia_pair, fn, data, data.data_ptr(), win_vec.data_ptr(), y.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), u.data_ptr(), z.data_ptr(),
            offsets_t.data_ptr(), len(offsets), m, n, lo, hi, tile)
    return u, z


@functools.lru_cache(maxsize=None)
def pair_tile(device, dtype, nd, lo, hi):
    """The tile of the staged pair (:func:`dia_pair`, and
    :func:`dia_pair_shared`'s staged route: both stage the same bytes) on
    ``device`` for nd diagonals, halos lo, hi and stripes of ``dtype``:
    T = 1024 k - (lo + hi rounded up to 4) indices for the least k in 1, 2,
    4, 8 with T >= 256 and T >= lo + hi whose two stages fit two blocks an
    SM (else one); 0 where none fits or a halo exceeds PAIR_MAX_HALO. The
    packed pair then takes two launches; the shared pair takes its ring
    kernel where H <= PAIR_MAX_HALO and the ring fits, else two launches
    (:func:`pair_shared_route`)."""
    from . import _cuda

    with torch.cuda.device(device):
        tile = getattr(_cuda.library(), f"lsqr_dia_pair_tile_{_SUFFIX[dtype]}")(nd, lo, hi)
    if tile < 0:
        raise RuntimeError("dia_pair: the card's shared-memory limits could not be read")
    return tile


#: the modes of the zdia_pair kernel (csrc/zdia.cu): the staged one-pass pair
#: with its halo recomputed; u alone; z = A^H u from u
ZPAIR_FUSED, ZPAIR_FORWARD, ZPAIR_ADJOINT = 0, 1, 2


def zdia_pair(dr, di, y, win, c1, c2, *, offsets: Sequence[int], m: int, n: int,
              offsets_t: Optional[torch.Tensor] = None):
    """The complex pair in one pass over the two stripe planes
    ``dr``, ``di`` (nd, m), A[i, i + k_d] = dr[d, i] + i di[d, i]:
        u = A (win*c1) - c2*y,     z = A^H u
    with y (m,) and win (n,) complex64 and REAL scalars c1, c2 (numbers or
    0-d tensors, read on the device). Returns (u (m,), z (n,)) complex64.
    On CUDA: f32 planes (16-byte aligned), one launch of the staged pair in
    tiles of :func:`zpair_tile` (vectors off the 16-byte grid are copied).
    When lo = max(0, -min k) or hi = max(0, max k) exceeds PAIR_MAX_HALO,
    or no tile fits, the pair is two launches of the kernel (u, then z
    from u), each counted."""
    offsets = tuple(int(k) for k in offsets)
    if not dr.is_cuda:
        return zdia_pair_plain(dr, di, y, win, c1, c2, offsets=offsets, m=m, n=n)
    lo, hi = _halos(offsets)
    tile = zpair_tile(len(offsets), lo, hi, *_smem_limits(dr.device)) \
        if max(lo, hi) <= PAIR_MAX_HALO else 0
    return _zdia_pair_launch(dr, di, y, win, c1, c2, offsets=offsets, m=m, n=n,
                             offsets_t=offsets_t, tile=tile)


def _zdia_pair_launch(dr, di, y, win, c1, c2, *, offsets: Sequence[int], m: int, n: int,
                      offsets_t: Optional[torch.Tensor] = None, tile: int):
    """The complex pair on CUDA tensors: one launch of the staged kernel in
    tiles of ``tile`` (the kernel refuses halos above PAIR_MAX_HALO), or two
    launches (u, then z from u) where ``tile`` is 0. :func:`zdia_pair` picks
    the tile (:func:`zpair_tile`); a comparison of the two routes passes 0."""
    offsets = tuple(int(k) for k in offsets)
    fn = _kernel("zdia_pair", dr, (torch.float32,), offsets)
    _check("dr", dr, torch.float32, dr.device, (len(offsets), m))
    _check("di", di, torch.float32, dr.device, (len(offsets), m))
    _check("y", y, torch.complex64, dr.device, m)
    _check("win", win, torch.complex64, dr.device, n)
    offsets_t = _offsets_on(dr, offsets, offsets_t)
    c1, c2 = _device_scalar(c1, dr.device), _device_scalar(c2, dr.device)
    u = torch.empty(m, dtype=torch.complex64, device=dr.device)
    z = torch.empty(n, dtype=torch.complex64, device=dr.device)
    if max(m, n) == 0:
        return u, z
    lo, hi = _halos(offsets)
    if tile:
        if dr.data_ptr() % 16 or di.data_ptr() % 16:
            raise ValueError("dr and di must be 16-byte aligned (the pair stages them in "
                             "16-byte copies)")
        y, win = _aligned(y, win)
    # the kernel reads and writes the complex vectors as interleaved float2
    ptrs = [torch.view_as_real(t).data_ptr() for t in (y, win, u, z)]
    args = (dr.data_ptr(), di.data_ptr(), ptrs[1], ptrs[0], c1.data_ptr(), c2.data_ptr(),
            ptrs[2], ptrs[3], offsets_t.data_ptr(), len(offsets), m, n, lo, hi)
    if tile:
        _launch(zdia_pair, fn, dr, *args, ZPAIR_FUSED, tile)
    else:
        _launch(zdia_pair, fn, dr, *args, ZPAIR_FORWARD, 0, work="product")
        _launch(zdia_pair, fn, dr, *args, ZPAIR_ADJOINT, 0, work="product")
    return u, z


#: every kernel wrapper and the stripe dtypes its kernel takes
KERNELS = {
    dia_pair_shared: ("f32", "bf16", *UNSTAGED.values()),
    dia_product_shared: ("f32", "f64", "bf16"),
    dia_product_shared_axpy: ("f32", "bf16"),
    dia_pair: ("f32", "bf16"),
    dia_matvec: ("f32", "f64", "bf16"),
    dia_matvec_axpy: ("f32", "bf16"),
    dia_fused_halfstep: ("f32",),
    dia_fused_halfstep_v2: ("f32", "bf16"),
    dia_fused_halfstep_v3: ("f32", "bf16"),
    zdia_pair: ("f32",),
}


#: the unit of work of a launch (:class:`tracing.kernel`), per wrapper:
#: "pair" (one right-hand side's A x and A' u), "product" (one of them),
#: "iterations" (K solver iterations, given at each launch) or "copy"
WORK = {dia_pair_shared: "pair", dia_pair: "pair", zdia_pair: "pair"}


def reset_launch_counts() -> None:
    for fn, suffixes in KERNELS.items():
        fn.launches = 0
        fn.variants = dict.fromkeys(suffixes, 0)


def register(wrapper, suffixes, name=None, work="product") -> None:
    """Count a kernel wrapper of another module here too, under ``name``
    (its own ``__name__`` by default), its launches each one ``work``
    (:data:`WORK`); it launches through :func:`_launch`."""
    wrapper.kernel_name = name or wrapper.__name__
    wrapper.work = work
    KERNELS[wrapper] = tuple(suffixes)
    wrapper.launches = 0
    wrapper.variants = dict.fromkeys(suffixes, 0)


for _fn in KERNELS:
    _fn.kernel_name = _fn.__name__
    _fn.work = WORK.get(_fn, "product")
reset_launch_counts()


def launch_counts(by_variant: bool = False) -> dict:
    """{kernel name: launches since the last reset}. With ``by_variant``,
    one entry per stripe dtype a kernel takes: the name for f32,
    ``name[bf16]`` and ``name[f64]`` for the others (and the shared pair's
    unstaged route, ``UNSTAGED``)."""
    if not by_variant:
        return {fn.kernel_name: fn.launches for fn in KERNELS}
    return {(fn.kernel_name if s == "f32" else f"{fn.kernel_name}[{s}]"): count
            for fn in KERNELS for s, count in fn.variants.items()}
