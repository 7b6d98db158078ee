"""Vector primitives: the overflow-safe 2-norm and the safe scalar hypot.

PyTorch counterpart of :mod:`lsqr_tpu.ops.blas`, with the same operation
order (max, scale, sum of squares, sqrt, rescale) so that results agree with
the JAX package up to the order a reduction sums in.
"""

from __future__ import annotations

import torch

__all__ = ["nrm2", "d2norm", "safe_divide", "abs2", "all_sum", "all_max", "side_norms"]


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=group)
    return t


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a process group of
    ``torch.distributed``), in place: the psum of the JAX package's sharded
    solves. Every rank gets the same bits. ``t`` itself when ``group`` is
    None, so an unsharded solve runs no collective."""
    return _all_reduce(t, group, "SUM")


def all_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """As :func:`all_sum`, the maximum (JAX's pmax)."""
    return _all_reduce(t, group, "MAX")


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 elementwise, always real-dtyped (``x * x`` for real input)."""
    if x.is_complex():
        return (x * x.conj()).real
    return x * x


def nrm2(x: torch.Tensor, *, safe: bool = True, group=None) -> torch.Tensor:
    """Euclidean norm of ``x`` as a 0-d tensor on ``x``'s device.

    ``safe=True`` is the scaled two-pass form of the reference ``dnrm2``
    (lsqrblas.f90:123-159): a max reduction picks the scale, then a scaled
    sum of squares. ``safe=False`` is the plain ``sqrt(sum(x^2))``.

    ``group``: ``x`` is this rank's slice of a vector split over the ranks
    of that process group; the max and the sum of squares are completed
    over it (:func:`all_max`, :func:`all_sum`), giving every rank the norm
    of the whole vector."""
    if safe:
        if x.numel():
            amax = x.abs().amax()
        else:
            amax = torch.zeros((), dtype=abs2(x).dtype, device=x.device)
        amax = all_max(amax, group)
        one = torch.ones((), dtype=amax.dtype, device=x.device)
        scale = torch.where(amax > 0, amax, one)
        ssq = all_sum(abs2(x / scale).sum(), group)
        return torch.where(amax > 0, scale * ssq.sqrt(), torch.zeros_like(amax))
    return all_sum(abs2(x).sum(), group).sqrt()


def side_norms(A, safe: bool):
    """(norm of an m-vector, norm of an n-vector) for a solve on ``A``: the
    :func:`nrm2` of a vector, completed over the process group that A's
    distribution hook (``axis_name_m``, ``axis_name_n``; ops/linop.py)
    names for that side, if any."""
    groups = getattr(A, "axis_name_m", None), getattr(A, "axis_name_n", None)
    return tuple((lambda vec, g=g: nrm2(vec, safe=safe, group=g)) for g in groups)


def d2norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(a**2 + b**2) without overflow: the reference's scale-by-|a|+|b|
    form (lsqr.f90:1164-1179)."""
    scale = a.abs() + b.abs()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    r = safe * torch.sqrt(torch.square(a / safe) + torch.square(b / safe))
    return torch.where(scale > 0, r, torch.zeros_like(scale))


def safe_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0 where den == 0."""
    safe_den = torch.where(den != 0, den, torch.ones_like(den))
    return torch.where(den != 0, num / safe_den, torch.zeros_like(num * safe_den))
