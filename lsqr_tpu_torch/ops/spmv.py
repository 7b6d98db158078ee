"""Shared-stripe DIA products: the three kernels of the banded main path.

PyTorch counterpart of the shared part of :mod:`lsqr_tpu.ops.pallas_spmv`.
Each kernel is written by hand in CUDA C++ (``csrc/dia_shared.cu``) and has
a plain PyTorch twin beside it in this module:

=========================  =================================  ==============
wrapper                    computes                           replaces
=========================  =================================  ==============
dia_product_shared         A x or A' y (f32, f64)             pallas_spmv.py
                                                              dia_product_shared
dia_product_shared_axpy    (A or A')(vec*c1) - c2*y (f32)     ...shared_axpy
dia_pair_shared            u = A(vec*c1) - c2*y, z = A' u     dia_pair_shared
=========================  =================================  ==============

A wrapper given CPU tensors runs the twin. Given CUDA tensors it launches its
kernel or raises: there is no fallback. Each wrapper counts its launches in
its ``launches`` attribute (a plain integer; :func:`reset_launch_counts`).

``dp`` is the flat ``(nd * Lp,)`` stripe array of :func:`dia_shared_geometry`
with ``dp[d * Lp + H + i] = A[i, i + offsets[d]]`` and zeros elsewhere; the
geometry is the JAX package's, so the same bytes serve both packages.
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
    "launch_counts",
    "reset_launch_counts",
    "no_bf16_kernel",
    "PAIR_MAX_HALO",
]

#: the largest halo the one-pass pair kernel takes (its shared-memory tile
#: holds 1024 + 2H floats); above it the pair is two launches, the axpy
#: kernel then the product kernel.
PAIR_MAX_HALO = 1024


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


def _acc_dtype(dp):
    return torch.float32 if dp.dtype == torch.bfloat16 else dp.dtype


# ---------------------------------------------------------------------------
# Plain twins (written from structured.DIASharedOperator._product_xla and the
# Pallas kernel bodies; same summation order: diagonals in offset order)
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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _offsets_on(dp, offsets, offsets_t):
    if offsets_t is None:
        offsets_t = torch.tensor(offsets, dtype=torch.int32, device=dp.device)
    if offsets_t.dtype != torch.int32 or offsets_t.device != dp.device \
            or offsets_t.shape != (len(offsets),):
        raise ValueError("offsets_t must be an int32 tensor of len(offsets) on dp's device")
    return offsets_t


def _check(name, t, dtype, device, length):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the stripes on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtype}")
    if t.shape != (length,):
        raise ValueError(f"{name} must have shape ({length},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def no_bf16_kernel():
    """Refuse bf16 stripes on CUDA (the CPU twins take them)."""
    raise NotImplementedError(
        "bf16 stripe storage has no CUDA kernel yet (ROADMAP Queue 2, gaps "
        "in the ported rows)"
    )


def _check_stripes(dp, offsets, m, n, dtypes):
    if dp.dtype == torch.bfloat16:
        no_bf16_kernel()
    if dp.dtype not in dtypes:
        raise TypeError(f"stripes of dtype {dp.dtype}: the kernel takes {dtypes}")
    if not 1 <= len(offsets) <= 1024:
        raise ValueError(f"the kernels take 1 to 1024 diagonals, got {len(offsets)}")
    H, Lp = _geometry(offsets, m, n)
    _check("dp", dp, dp.dtype, dp.device, len(offsets) * Lp)
    return H, Lp


def _device_scalar(c, device):
    c = _scalar(c, torch.float32, device)
    if c.dim() != 0:
        raise ValueError("c1 and c2 must be scalars")
    return c.contiguous()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def dia_product_shared(dp, vec, *, offsets: Sequence[int], m: int, n: int,
                       adjoint: bool, offsets_t: Optional[torch.Tensor] = None):
    """y = A x (adjoint=False, vec (n,) -> (m,)) or x = A' y (adjoint=True,
    vec (m,) -> (n,)) from the shared stripes. On CUDA: f32 or f64 stripes
    with a vector of the same dtype."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_product_shared_plain(dp, vec, offsets=offsets, m=m, n=n,
                                        adjoint=adjoint)
    from . import _cuda

    H, Lp = _check_stripes(dp, offsets, m, n, (torch.float32, torch.float64))
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    _check("vec", vec, dp.dtype, dp.device, dim_in)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    out = torch.empty(dim_out, dtype=dp.dtype, device=dp.device)
    if dim_out == 0:
        return out
    lib = _cuda.library()
    fn = (lib.lsqr_dia_product_shared_f32 if dp.dtype == torch.float32
          else lib.lsqr_dia_product_shared_f64)
    _cuda.check(fn(dp.data_ptr(), vec.data_ptr(), out.data_ptr(),
                   offsets_t.data_ptr(), len(offsets), Lp, H, dim_out, dim_in,
                   int(adjoint), _stream()), "dia_product_shared")
    dia_product_shared.launches += 1
    return out


def dia_product_shared_axpy(dp, vec, y, c1, c2, *, offsets: Sequence[int],
                            m: int, n: int, adjoint: bool,
                            offsets_t: Optional[torch.Tensor] = None):
    """out = A(vec*c1) - c2*y (adjoint=False) or A'(vec*c1) - c2*y
    (adjoint=True). c1, c2 are numbers or 0-d tensors; on CUDA they stay on
    the device (the kernel reads them through pointers). f32 on CUDA."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_product_shared_axpy_plain(dp, vec, y, c1, c2, offsets=offsets,
                                             m=m, n=n, adjoint=adjoint)
    from . import _cuda

    H, Lp = _check_stripes(dp, offsets, m, n, (torch.float32,))
    dim_out, dim_in = (n, m) if adjoint else (m, n)
    _check("vec", vec, dp.dtype, dp.device, dim_in)
    _check("y", y, dp.dtype, dp.device, dim_out)
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    c1 = _device_scalar(c1, dp.device)
    c2 = _device_scalar(c2, dp.device)
    out = torch.empty(dim_out, dtype=dp.dtype, device=dp.device)
    if dim_out == 0:
        return out
    lib = _cuda.library()
    _cuda.check(lib.lsqr_dia_shared_axpy_f32(
        dp.data_ptr(), vec.data_ptr(), y.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), out.data_ptr(), offsets_t.data_ptr(), len(offsets), Lp,
        H, dim_out, dim_in, int(adjoint), _stream()), "dia_product_shared_axpy")
    dia_product_shared_axpy.launches += 1
    return out


def dia_pair_shared(dp, vec, y, c1, c2, *, offsets: Sequence[int], m: int,
                    n: int, offsets_t: Optional[torch.Tensor] = None):
    """Both bidiagonalization products in one pass over the stripes:
    u = A(vec*c1) - c2*y with vec (n,), y (m,), and z = A' u. Returns
    (u (m,), z (n,)). f32 on CUDA. For H > PAIR_MAX_HALO the pair is two
    launches: :func:`dia_product_shared_axpy`, then
    :func:`dia_product_shared` (each counts its own launch)."""
    offsets = tuple(int(k) for k in offsets)
    if not dp.is_cuda:
        return dia_pair_shared_plain(dp, vec, y, c1, c2, offsets=offsets, m=m, n=n)
    from . import _cuda

    H, Lp = _check_stripes(dp, offsets, m, n, (torch.float32,))
    offsets_t = _offsets_on(dp, offsets, offsets_t)
    if H > PAIR_MAX_HALO:
        u = dia_product_shared_axpy(dp, vec, y, c1, c2, offsets=offsets, m=m,
                                    n=n, adjoint=False, offsets_t=offsets_t)
        return u, dia_product_shared(dp, u, offsets=offsets, m=m, n=n,
                                     adjoint=True, offsets_t=offsets_t)
    _check("vec", vec, dp.dtype, dp.device, n)
    _check("y", y, dp.dtype, dp.device, m)
    c1 = _device_scalar(c1, dp.device)
    c2 = _device_scalar(c2, dp.device)
    u = torch.empty(m, dtype=dp.dtype, device=dp.device)
    z = torch.empty(n, dtype=dp.dtype, device=dp.device)
    if max(m, n) == 0:
        return u, z
    lib = _cuda.library()
    _cuda.check(lib.lsqr_dia_pair_shared_f32(
        dp.data_ptr(), vec.data_ptr(), y.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), u.data_ptr(), z.data_ptr(), offsets_t.data_ptr(),
        len(offsets), Lp, H, m, n, _stream()), "dia_pair_shared")
    dia_pair_shared.launches += 1
    return u, z


KERNELS = (dia_pair_shared, dia_product_shared, dia_product_shared_axpy)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
