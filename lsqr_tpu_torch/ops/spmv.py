"""DIA products: the seven kernels of the banded paths.

PyTorch counterpart of the DIA part of :mod:`lsqr_tpu.ops.pallas_spmv`.
Each kernel is written by hand in CUDA C++ and has a plain PyTorch twin
beside it in this module:

=========================  =================================  ==================
wrapper                    computes                           source
=========================  =================================  ==================
dia_product_shared         A x or A' y (f32, f64, bf16)       csrc/dia_shared.cu
dia_product_shared_axpy    (A or A')(vec*c1) - c2*y           csrc/dia_shared.cu
dia_pair_shared            u = A(vec*c1) - c2*y, z = A' u     csrc/dia_shared.cu
dia_matvec                 A x, packed (f32, f64, bf16)       csrc/dia_packed.cu
dia_matvec_axpy            A(win*c1) - c2*y, packed           csrc/dia_packed.cu
dia_fused_halfstep         as dia_matvec_axpy, and sum(out^2) csrc/dia_packed.cu
dia_pair                   the pair on packed stripes         csrc/dia_packed.cu
=========================  =================================  ==================

Each replaces the Pallas kernel of the same name. A wrapper given CPU
tensors runs the twin. Given CUDA tensors it launches its kernel or raises:
there is no fallback. Each wrapper counts its launches in its ``launches``
attribute (a plain integer), and per stripe dtype in ``variants``
(:func:`launch_counts`, :func:`reset_launch_counts`).

Stripes are f32, f64 where the kernel says so, or bf16: bf16 is a storage
format, so vectors, c1, c2 and the accumulation are f32, and so are the
results, except that ``dia_matvec_axpy`` and ``dia_fused_halfstep`` return
the stripes' dtype as the JAX kernels do (their ``ssq`` stays f32;
``dia_matvec_axpy(out_dtype=torch.float32)`` keeps an f32 result, which the
operators' half-steps and the wide-halo pair take).

Shared layout: ``dp`` is the flat ``(nd * Lp,)`` stripe array of
:func:`dia_shared_geometry` with ``dp[d * Lp + H + i] = A[i, i + offsets[d]]``
and zeros elsewhere. Packed layout: ``data`` is ``(nd, m)`` with
``data[d, i] = A[i, i + offsets[d]]``, zero outside the matrix, and no
padding. Both geometries are the JAX package's, so the same bytes serve
both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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
    "launch_counts",
    "reset_launch_counts",
    "register",
    "PAIR_MAX_HALO",
]

#: the largest halo the one-pass pair kernels take (their shared-memory
#: tile holds 1024 + 2H floats, or 1024 + lo + hi for the packed pair);
#: above it the pair is two launches, the axpy kernel then the product.
PAIR_MAX_HALO = 1024

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


def dia_pair_plain(data, y, win_vec, c1, c2, *, offsets, m, n):
    """Plain twin of :func:`dia_pair`."""
    u = _axpy_acc(data, y, win_vec, c1, c2, offsets, m)
    return u, dia_matvec_plain(data, u, offsets=offsets, m=m, n=n, adjoint=True)


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


def _launch(wrapper, fn, stripes, *args):
    """Run a launcher, raise on its CUDA error, count the launch."""
    from . import _cuda

    _cuda.check(fn(*args, torch.cuda.current_stream(stripes.device).cuda_stream),
                wrapper.kernel_name)
    wrapper.launches += 1
    wrapper.variants[_SUFFIX[stripes.dtype]] += 1


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
    otherwise."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_product_shared_plain(dp, vec, offsets=offsets, m=m, n=n,
                                        adjoint=adjoint)
    fn = _kernel("dia_product_shared", dp,
                 (torch.float32, torch.float64, torch.bfloat16), offsets)
    _check_shared(dp, offsets, m, n)
    H, Lp = _geometry(offsets, m, n)
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    acc = _acc_dtype(dp)
    _check("vec", vec, acc, dp.device, dim_in)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    out = torch.empty(dim_out, dtype=acc, device=dp.device)
    if dim_out == 0:
        return out
    _launch(dia_product_shared, fn, dp, dp.data_ptr(), vec.data_ptr(),
            out.data_ptr(), offsets_t.data_ptr(), len(offsets), Lp, H, dim_out,
            dim_in, int(adjoint))
    return out


def dia_product_shared_axpy(dp, vec, y, c1, c2, *, offsets: Sequence[int],
                            m: int, n: int, adjoint: bool,
                            offsets_t: Optional[torch.Tensor] = None):
    """out = A(vec*c1) - c2*y (adjoint=False) or A'(vec*c1) - c2*y
    (adjoint=True). c1, c2 are numbers or 0-d tensors; on CUDA they stay on
    the device (the kernel reads them through pointers). On CUDA: f32 or
    bf16 stripes, f32 vectors."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_product_shared_axpy_plain(dp, vec, y, c1, c2, offsets=offsets,
                                             m=m, n=n, adjoint=adjoint)
    fn = _kernel("dia_shared_axpy", dp, (torch.float32, torch.bfloat16), offsets)
    _check_shared(dp, offsets, m, n)
    H, Lp = _geometry(offsets, m, n)
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    _check("vec", vec, torch.float32, dp.device, dim_in)
    _check("y", y, torch.float32, dp.device, dim_out)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    c1 = _device_scalar(c1, dp.device)
    c2 = _device_scalar(c2, dp.device)
    out = torch.empty(dim_out, dtype=torch.float32, device=dp.device)
    if dim_out == 0:
        return out
    _launch(dia_product_shared_axpy, fn, dp, dp.data_ptr(), vec.data_ptr(),
            y.data_ptr(), c1.data_ptr(), c2.data_ptr(), out.data_ptr(),
            offsets_t.data_ptr(), len(offsets), Lp, H, dim_out, dim_in,
            int(adjoint))
    return out


def dia_pair_shared(dp, vec, y, c1, c2, *, offsets: Sequence[int], m: int,
                    n: int, offsets_t: Optional[torch.Tensor] = None):
    """Both bidiagonalization products in one pass over the stripes:
    u = A(vec*c1) - c2*y with vec (n,), y (m,), and z = A' u. Returns
    (u (m,), z (n,)). On CUDA: f32 or bf16 stripes, f32 vectors. For
    H > PAIR_MAX_HALO the pair is two launches:
    :func:`dia_product_shared_axpy`, then :func:`dia_product_shared` (each
    counts its own launch)."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_pair_shared_plain(dp, vec, y, c1, c2, offsets=offsets, m=m, n=n)
    fn = _kernel("dia_pair_shared", dp, (torch.float32, torch.bfloat16), offsets)
    _check_shared(dp, offsets, m, n)
    H, Lp = _geometry(offsets, m, n)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    if H > PAIR_MAX_HALO:
        u = dia_product_shared_axpy(dp, vec, y, c1, c2, offsets=offsets, m=m,
                                    n=n, adjoint=False, offsets_t=offsets_t)
        return u, dia_product_shared(dp, u, offsets=offsets, m=m, n=n,
                                     adjoint=True, offsets_t=offsets_t)
    _check("vec", vec, torch.float32, dp.device, n)
    _check("y", y, torch.float32, dp.device, m)
    c1 = _device_scalar(c1, dp.device)
    c2 = _device_scalar(c2, dp.device)
    u = torch.empty(m, dtype=torch.float32, device=dp.device)
    z = torch.empty(n, dtype=torch.float32, device=dp.device)
    if max(m, n) == 0:
        return u, z
    _launch(dia_pair_shared, fn, dp, dp.data_ptr(), vec.data_ptr(), y.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), u.data_ptr(), z.data_ptr(),
            offsets_t.data_ptr(), len(offsets), Lp, H, m, n)
    return u, z


def dia_matvec(data, x, *, offsets: Sequence[int], m: int, n: int,
               adjoint: bool = False, offsets_t: Optional[torch.Tensor] = None):
    """y = A x from the packed stripes ``data`` (nd, m), x (n,) -> (m,).
    The adjoint product of the operator runs this on its transpose stripes
    ``tdata`` with the negated offsets (as in the JAX package);
    ``adjoint=True`` instead reads ``data`` from the column side,
    x (m,) -> A' x (n,). On CUDA: f32, f64 or bf16 stripes, with an f32
    vector for bf16 and one of the stripes' dtype otherwise."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_matvec_plain(data, x, offsets=offsets, m=m, n=n, adjoint=adjoint)
    fn = _kernel("dia_matvec", data,
                 (torch.float32, torch.float64, torch.bfloat16), offsets)
    _check("data", data, data.dtype, data.device, (len(offsets), m))
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    acc = _acc_dtype(data)
    _check("x", x, acc, data.device, dim_in)
    offsets_t = _offsets_on(data, offsets, offsets_t)
    out = torch.empty(dim_out, dtype=acc, device=data.device)
    if dim_out == 0:
        return out
    _launch(dia_matvec, fn, data, data.data_ptr(), x.data_ptr(), out.data_ptr(),
            offsets_t.data_ptr(), len(offsets), dim_out, dim_in, int(adjoint))
    return out


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


#: per (device, stream): the fused half-step's int32 ticket, 0 between launches
_TICKETS: dict = {}
#: the fused half-step kernel's grid cap (kReduceBlocks in csrc/dia_packed.cu)
_REDUCE_BLOCKS = 1024


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
    fn = _kernel("dia_fused_halfstep", data, (torch.float32,), offsets)
    offsets_t, c1, c2 = _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n,
                                          offsets_t)
    out = torch.empty(m, dtype=torch.float32, device=data.device)
    if m == 0:
        return out, torch.zeros((), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    ticket = _TICKETS.get((data.device, stream))
    if ticket is None:
        ticket = _TICKETS[(data.device, stream)] = torch.zeros(
            1, dtype=torch.int32, device=data.device)
    slots = min(-(-m // 256), _REDUCE_BLOCKS)
    partial = torch.empty(slots, dtype=torch.float32, device=data.device)
    ssq = torch.empty((), dtype=torch.float32, device=data.device)
    _launch(dia_fused_halfstep, fn, data, data.data_ptr(), win_vec.data_ptr(),
            y.data_ptr(), c1.data_ptr(), c2.data_ptr(), out.data_ptr(),
            partial.data_ptr(), ticket.data_ptr(), ssq.data_ptr(),
            offsets_t.data_ptr(), len(offsets), m, n, slots)
    return out, ssq


def dia_pair(data, y, win_vec, c1, c2, *, offsets: Sequence[int], m: int, n: int,
             offsets_t: Optional[torch.Tensor] = None):
    """Both bidiagonalization products in one pass over the packed stripes:
        u = A (win_vec*c1) - c2*y,     z = A' u
    with data (nd, m), y (m,), win_vec (n,); z comes from the same
    row-aligned stripes read from the column side. Returns (u (m,), z (n,)).
    On CUDA: f32 or bf16 stripes, f32 vectors. When lo = max(0, -min k) or
    hi = max(0, max k) exceeds PAIR_MAX_HALO, the pair is two launches:
    :func:`dia_matvec_axpy`, then :func:`dia_matvec` with ``adjoint=True``
    (each counts its own launch)."""
    offsets = tuple(int(k) for k in offsets)
    if not data.is_cuda:
        return dia_pair_plain(data, y, win_vec, c1, c2, offsets=offsets, m=m, n=n)
    fn = _kernel("dia_pair", data, (torch.float32, torch.bfloat16), offsets)
    offsets_t, c1, c2 = _packed_axpy_args(data, y, win_vec, c1, c2, offsets, m, n,
                                          offsets_t)
    lo, hi = _halos(offsets)
    if max(lo, hi) > PAIR_MAX_HALO:
        u = dia_matvec_axpy(data, y, win_vec, c1, c2, offsets=offsets, m=m, n=n,
                            offsets_t=offsets_t, out_dtype=torch.float32)
        return u, dia_matvec(data, u, offsets=offsets, m=m, n=n, adjoint=True,
                             offsets_t=offsets_t)
    u = torch.empty(m, dtype=torch.float32, device=data.device)
    z = torch.empty(n, dtype=torch.float32, device=data.device)
    if max(m, n) == 0:
        return u, z
    _launch(dia_pair, fn, data, data.data_ptr(), win_vec.data_ptr(), y.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), u.data_ptr(), z.data_ptr(),
            offsets_t.data_ptr(), len(offsets), m, n, lo, hi)
    return u, z


#: every kernel wrapper and the stripe dtypes its kernel takes
KERNELS = {
    dia_pair_shared: ("f32", "bf16"),
    dia_product_shared: ("f32", "f64", "bf16"),
    dia_product_shared_axpy: ("f32", "bf16"),
    dia_pair: ("f32", "bf16"),
    dia_matvec: ("f32", "f64", "bf16"),
    dia_matvec_axpy: ("f32", "bf16"),
    dia_fused_halfstep: ("f32",),
}


def reset_launch_counts() -> None:
    for fn, suffixes in KERNELS.items():
        fn.launches = 0
        fn.variants = dict.fromkeys(suffixes, 0)


def register(wrapper, suffixes, name=None) -> None:
    """Count a kernel wrapper of another module here too, under ``name``
    (its own ``__name__`` by default); it launches through :func:`_launch`."""
    wrapper.kernel_name = name or wrapper.__name__
    KERNELS[wrapper] = tuple(suffixes)
    wrapper.launches = 0
    wrapper.variants = dict.fromkeys(suffixes, 0)


for _fn in KERNELS:
    _fn.kernel_name = _fn.__name__
reset_launch_counts()


def launch_counts(by_variant: bool = False) -> dict:
    """{kernel name: launches since the last reset}. With ``by_variant``,
    one entry per stripe dtype a kernel takes: the name for f32,
    ``name[bf16]`` and ``name[f64]`` for the others."""
    if not by_variant:
        return {fn.kernel_name: fn.launches for fn in KERNELS}
    return {(fn.kernel_name if s == "f32" else f"{fn.kernel_name}[{s}]"): count
            for fn in KERNELS for s, count in fn.variants.items()}
