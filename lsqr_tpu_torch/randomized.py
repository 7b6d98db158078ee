"""LSRN: randomized preconditioning for strongly rectangular problems.

PyTorch counterpart of :mod:`lsqr_tpu.randomized` (Meng, Saunders &
Mahoney 2014). For an over-determined A (m >= n) and s = ceil(gamma * n)
sketch rows, gamma > 1:

1. sketch         ``S = G A`` with G an (s, m) iid N(0, 1) matrix;
2. thin SVD       ``S = U diag(sig) V'`` on the host ((s, n) is small);
3. precondition   ``N = V diag(1/sig)``, solve ``min ||(A N) y - b||``
   with LSQR, and ``x = N y``.

Every nonzero singular value of ``A N`` lies in
``[1 - sqrt(n/s), 1 + sqrt(n/s)]`` w.h.p., so the preconditioned solve
takes a few tens of iterations whatever cond(A). The under-determined case
sketches from the right (``A G'``) and preconditions from the left with
``P = diag(1/sig) U'``.

G comes from a ``torch.Generator`` seeded by ``seed`` on the operator's
device, in chunks of ``chunk`` rows (an (s, m) G of a tall operator would
not fit); each sketch row of a sparse operator is one adjoint product
(``(G A)_i = (A' g_i)'``), so the sketch launches the operator's own
kernels. Its draws are not ``jax.random``'s: the two packages' sketches
differ, what they are for does not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import resolve_device
from .ops.compose import scale_operator, vstack_operators
from .ops.linop import DenseOperator, LinearOperator, as_operator, as_tensor, to_numpy
from .ops.precondition import ComposedOperator

__all__ = ["LSRNResult", "lsrn", "lsrn_preconditioner", "sketch_left",
           "sketch_right", "svd_truncated_preconditioner"]


def _gaussian_rows(A: LinearOperator, s: int, length: int, seed: int, chunk: int,
                   device=None):
    """Chunks of the rows of an (s, length) standard Gaussian G in A's
    dtype, from one generator seeded by ``seed`` on A's device."""
    dev = A.device if A.device is not None else resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = A.dtype or torch.get_default_dtype()
    for lo in range(0, s, chunk):
        yield torch.randn((min(chunk, s - lo), length), generator=g, dtype=dtype,
                          device=dev)


def sketch_left(A: LinearOperator, s: int, *, seed: int = 0, chunk: int = 64,
                device=None) -> torch.Tensor:
    """``G A`` for an (s, m) standard Gaussian G: an (s, n) tensor on A's
    device (``device`` where A has none). A DenseOperator takes a matmul a
    chunk; any other operator an adjoint product a row."""
    out = []
    for G in _gaussian_rows(A, s, A.m, seed, chunk, device):
        if isinstance(A, DenseOperator):
            out.append(G @ A.a)
        elif G.is_complex():
            # rmatvec is the adjoint: row i of G A = conj(A^H conj(g_i))
            out.append(torch.stack([A.rmatvec(g.conj()) for g in G]).conj())
        else:
            out.append(torch.stack([A.rmatvec(g) for g in G]))
    return torch.cat(out)


def sketch_right(A: LinearOperator, s: int, *, seed: int = 0, chunk: int = 64,
                 device=None) -> torch.Tensor:
    """``A G'`` for an (s, n) standard Gaussian G: an (m, s) tensor."""
    out = []
    for G in _gaussian_rows(A, s, A.n, seed, chunk, device):
        if isinstance(A, DenseOperator):
            out.append((A.a @ G.T).T)
        else:
            out.append(torch.stack([A.matvec(g) for g in G]))
    return torch.cat(out).T


class LSRNResult(NamedTuple):
    """Outputs of :func:`lsrn`."""

    x: torch.Tensor            #: (n,) solution of the original problem
    result: NamedTuple         #: the inner solver's result (preconditioned operator)
    N: Optional[torch.Tensor]  #: (n, r) right preconditioner (m >= n)
    P: Optional[torch.Tensor]  #: (r, m) left preconditioner (m < n)
    rank: int                  #: numerical rank kept after the rcond cut
    cond_bound: float          #: the w.h.p. bound (1+sqrt(r/s))/(1-sqrt(r/s))


def svd_truncated_preconditioner(S, rcond: Optional[float] = None):
    """``N = V diag(1/sig)`` of a sketch ``S`` (numpy): host SVD, singular
    values below ``rcond * sig_max`` cut (numpy.linalg.pinv's ``max(S.shape)
    * eps`` by default). Returns (N, rank)."""
    _, sig, Vt = np.linalg.svd(S, full_matrices=False)
    if rcond is None:
        rcond = max(S.shape) * np.finfo(S.dtype).eps
    r = int(np.sum(sig > rcond * sig[0]))
    return Vt[:r].conj().T / sig[:r], r


def lsrn_preconditioner(A, *, gamma: float = 4.0, seed: int = 0,
                        rcond: Optional[float] = None, chunk: int = 64, device=None):
    """The LSRN right preconditioner ``N = V diag(1/sig)`` of an
    over-determined operator (m >= n): ``(N, rank, cond_bound)`` with N an
    (n, r) tensor on A's device. Solve ``min ||A N y - b||``, then
    ``x = N y``."""
    A = as_operator(A)
    if A.m < A.n:
        raise ValueError("lsrn_preconditioner expects m >= n; "
                         "use lsrn() which handles both orientations")
    s = int(np.ceil(gamma * A.n))
    S = sketch_left(A, s, seed=seed, chunk=chunk, device=device)
    N, r = svd_truncated_preconditioner(to_numpy(S), rcond=rcond)
    root = np.sqrt(r / s)
    return as_tensor(N, dtype=S.dtype, device=S.device), r, float((1 + root) / (1 - root))


def lsrn(
    A,
    b,
    damp: float = 0.0,
    *,
    gamma: float = 4.0,
    seed: int = 0,
    rcond: Optional[float] = None,
    chunk: int = 64,
    solver: str = "lsqr",
    device=None,
    **opts,
) -> LSRNResult:
    """Solve ``min ||A x - b||`` (or the damped problem) with LSQR after the
    LSRN preconditioner: the iteration count no longer depends on cond(A).

    Cost: ceil(gamma * min(m, n)) products for the sketch, one host SVD of
    the (s, min(m, n)) sketch and a few tens of preconditioned iterations.
    ``damp`` stacks ``[A; damp I]`` before the sketch (it does not commute
    with the preconditioner); ``solver`` is 'lsqr', 'lsmr' or 'cgls', and
    ``opts`` go to it. ``result.result`` is the inner solve's result on the
    preconditioned operator (its acond near ``cond_bound``). ``device`` is
    where the work goes when A has no device (a callback operator): the
    card when None."""
    A = as_operator(A)
    if solver == "lsqr":
        from .solver import lsqr as _solve
    elif solver == "lsmr":
        from .lsmr import lsmr as _solve
    elif solver == "cgls":
        from .cgls import cgls as _solve
    else:
        raise ValueError(f"unknown solver {solver!r}")
    dev = A.device if A.device is not None else resolve_device(device)
    b = as_tensor(b, device=dev)

    if damp != 0.0:
        # the damped problem is this undamped one (lsqr.f90:264-273)
        eye = DenseOperator(torch.eye(A.n, dtype=A.dtype, device=dev))
        A = vstack_operators([A, scale_operator(eye, torch.tensor(damp, dtype=A.dtype))])
        b = torch.cat([b, torch.zeros(A.n, dtype=b.dtype, device=dev)])

    if A.m >= A.n:
        N, r, bound = lsrn_preconditioner(A, gamma=gamma, seed=seed, rcond=rcond,
                                          chunk=chunk, device=dev)
        res = _solve(ComposedOperator(outer=A, inner=DenseOperator(N)), b, **opts)
        return LSRNResult(x=DenseOperator(N).matvec(res.x), result=res, N=N, P=None,
                          rank=r, cond_bound=bound)

    s = int(np.ceil(gamma * A.m))
    S = to_numpy(sketch_right(A, s, seed=seed, chunk=chunk, device=dev))  # (m, s)
    U, sig, _ = np.linalg.svd(S, full_matrices=False)
    if rcond is None:
        rcond = max(S.shape) * np.finfo(S.dtype).eps
    r = int(np.sum(sig > rcond * sig[0]))
    # P = diag(1/sig) U^H, (r, m)
    P = as_tensor(U[:, :r].conj().T / sig[:r, None], dtype=A.dtype, device=dev)
    res = _solve(ComposedOperator(outer=DenseOperator(P), inner=A),
                 DenseOperator(P).matvec(b), **opts)
    root = np.sqrt(r / s)
    return LSRNResult(x=res.x, result=res, N=None, P=P, rank=r,
                      cond_bound=float((1 + root) / (1 - root)))
