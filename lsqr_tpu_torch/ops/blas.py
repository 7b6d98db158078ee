"""Vector primitives: the overflow-safe 2-norm and the safe scalar hypot.

PyTorch counterpart of :mod:`lsqr_tpu.ops.blas`, with the same operation
order (max, scale, sum of squares, sqrt, rescale) so that results agree with
the JAX package up to the order a reduction sums in.
"""

from __future__ import annotations

import torch

__all__ = ["nrm2", "d2norm", "safe_divide", "abs2"]


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 elementwise, always real-dtyped (``x * x`` for real input)."""
    if x.is_complex():
        return (x * x.conj()).real
    return x * x


def nrm2(x: torch.Tensor, *, safe: bool = True) -> torch.Tensor:
    """Euclidean norm of ``x`` as a 0-d tensor on ``x``'s device.

    ``safe=True`` is the scaled two-pass form of the reference ``dnrm2``
    (lsqrblas.f90:123-159): a max reduction picks the scale, then a scaled
    sum of squares. ``safe=False`` is the plain ``sqrt(sum(x^2))``."""
    if safe:
        if x.numel():
            amax = x.abs().amax()
        else:
            amax = torch.zeros((), dtype=abs2(x).dtype, device=x.device)
        one = torch.ones((), dtype=amax.dtype, device=x.device)
        scale = torch.where(amax > 0, amax, one)
        ssq = abs2(x / scale).sum()
        return torch.where(amax > 0, scale * ssq.sqrt(), torch.zeros_like(amax))
    return abs2(x).sum().sqrt()


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
