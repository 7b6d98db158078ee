"""Differentiable least squares: gradients through the solver.

PyTorch counterpart of :mod:`lsqr_tpu.implicit`. The solution of

    x*(A, b, damp) = argmin_x ||A x - b||^2 + damp^2 ||x||^2

is an implicit function of the operator's values, b and damp, defined by
the optimality condition F = A'(A x - b) + damp^2 x = 0. By the implicit
function theorem the backward pass for a cotangent g needs one more solve
with the same (SPD) normal operator,

    (A'A + damp^2 I) s = g,

and then, with r = A x - b,

    d/db    = A s
    d/ddamp = -2 damp <s, x>
    d/dA    = -(r s' + (A s) x'),  sampled on the operator's own storage.

The adjoint solve is conjugate gradients on the normal operator through the
operator's own products (:func:`normal_cg`), so on the card it runs the
product kernels; no kernel needs a backward of its own. The sampled outer
products are plain tensor gathers and products on each layout's packing,
what the JAX package's autodiff gives outside its Pallas kernels.

Where gradients land. The JAX package differentiates
θ -> A'(A x - b) through the operator's two products, so a value tensor
read only by the forward product takes the share -(A s) x', one read only
by the adjoint product the share -r s', and one read by both takes both.
Every stored entry takes its sample, padding included (an ELL slot of value
0 and column 0 takes -(A s)_i x_0, as in JAX):

- ``DenseOperator.a``, ``COOOperator.vals``, ``DIASharedOperator.dp``,
  ``DiagonalOperator.d``: both shares;
- ``DIAOperator``, ``ELLOperator``, ``BlockELLOperator``: ``data``/
  ``vals``/``blocks`` the forward share, ``tdata``/``tvals``/``tblocks``
  the adjoint share, each on its own packing (BlockELL: the outer products
  of the vectors' block segments, padded blocks included);
- ``JDIAOperator``: ``data`` the forward share and ``tdata`` the adjoint
  share at the positions their jitter and window bases give, ``rem_vals``
  both;
- ``WCOOOperator``, ``WWCOOOperator``, ``RWCOOOperator``: the triplets
  ``coo.vals``, both shares. On the card the products read the packed
  copies (``packed.vals``, the hot and cold packings) while the gradient
  lands on the triplets, as the JAX package's CPU products run through
  ``coo``; the packed copies take none (JAX gives them zeros);
- the composites recurse to any depth: a ``VStackOperator`` member takes
  its rows of the vectors, an ``HStackOperator`` member its columns, a
  ``SumOperator`` member all of them; ``ScaledOperator`` passes alpha times
  them to its member and takes -(r.B s + (A s).B x) on ``alpha``;
  ``ColumnScaledOperator``, ``ComposedOperator`` and the transpose
  ``A.T`` pass on what their products make of the vectors, and
  ``ColumnScaledOperator.scale`` takes -(s∘B'r + x∘B'(A s));
- ``PaigeSaundersOperator`` (``hy``, ``hz``, ``d``): autograd through its
  plain products, which run no kernel.

The integer tensors (indices, jitter, window bases) and the tensors built
from the values (the fixed-order sums' sorted copies) are not leaves.
Callback operators, the sharded operators and the complex ZDIA/ZJDIA take no
value gradients (JAX gives callbacks none, and ``lsqr_grad`` is real-only in
both packages): a tensor of theirs that requires grad raises TypeError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .models.paige_saunders import PaigeSaundersOperator
from .ops.compose import (DiagonalOperator, HStackOperator, ScaledOperator, SumOperator,
                          VStackOperator)
from .ops.coo import COOOperator
from .ops.jdia import JDIAOperator
from .ops.linop import (CallbackOperator, DenseOperator, LinearOperator, _TransposedOperator,
                        as_operator, as_tensor)
from .ops.precondition import ColumnScaledOperator, ComposedOperator
from .ops.rwcoo import RWCOOOperator
from .ops.spmv_sparse import jdia_gather
from .ops.structured import BlockELLOperator, DIAOperator, DIASharedOperator, ELLOperator
from .ops.wcoo import ChunkedCOOOperator
from .solver import _run_segments, lsqr

__all__ = ["lsqr_grad", "normal_cg"]

#: the storage layouts and their value tensors (subclasses included)
STORAGE = ((DenseOperator, ("a",)), (COOOperator, ("vals",)),
           (DIAOperator, ("data", "tdata")), (DIASharedOperator, ("dp",)),
           (ELLOperator, ("vals", "tvals")), (BlockELLOperator, ("blocks", "tblocks")),
           (JDIAOperator, ("data", "tdata", "rem_vals")), (DiagonalOperator, ("d",)),
           (PaigeSaundersOperator, ("hy", "hz", "d")))


def _normal_matvec(A, damp, s):
    return A.rmatvec(A.matvec(s)) + (damp * damp) * s


class _CGCarry(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor  # 1 once the residual is small enough or at maxiter
    s: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor


def normal_cg(A, damp, g, *, tol: float = 1e-10, maxiter: Optional[int] = None,
              loop_segment: int = 64, info: Optional[dict] = None) -> torch.Tensor:
    """Solve the regularized normal equations ``(A'A + damp^2 I) s = g``
    for any right-hand side g by conjugate gradients, through the
    operator's products (two an iteration), until ``||r|| <= tol ||g||`` or
    ``maxiter`` (4n) iterations. This is the adjoint solve of the implicit
    gradient; :func:`~lsqr_tpu_torch.cgls` takes only g = A'b.

    The loop is the solvers' host-stepped masked segments of
    ``loop_segment`` iterations. A dict passed as ``info`` receives the
    iterations run (``"itn"``)."""
    A = as_operator(A)
    g = as_tensor(g, device=A.device)
    dt = g.dtype
    maxiter = 4 * g.shape[0] if maxiter is None else int(maxiter)
    damp = as_tensor(damp, dtype=dt, device=g.device)
    zero = torch.zeros((), dtype=dt, device=g.device)
    one = torch.ones((), dtype=dt, device=g.device)
    gn2 = torch.sum(g * g)
    small = tol * tol * gn2

    def stop(rs, itn):
        return ((rs <= small) | (itn >= maxiter)).to(torch.int32)

    itn0 = torch.zeros((), dtype=torch.int32, device=g.device)
    carry0 = _CGCarry(itn=itn0, istop=stop(gn2, itn0), s=torch.zeros_like(g), r=g, p=g,
                      rs=gn2)

    def cond_fun(c):
        return c.istop == 0

    def body_fun(c, active):
        q = _normal_matvec(A, damp, c.p)
        pq = torch.sum(c.p * q)
        alpha = torch.where(pq > zero, c.rs / torch.where(pq > zero, pq, one), zero)
        s = c.s + alpha * c.p
        r = c.r - alpha * q
        rs = torch.sum(r * r)
        beta = torch.where(c.rs > zero, rs / c.rs, zero)
        itn = c.itn + 1
        return _CGCarry(itn=itn, istop=stop(rs, itn), s=s, r=r, p=r + beta * c.p, rs=rs)

    final = _run_segments(carry0, cond_fun, body_fun, itnlim=maxiter, seg_len=loop_segment)
    if info is not None:
        info["itn"] = int(final.itn)
    return final.s


# ---------------------------------------------------------------------------
# The operator's differentiable tensors
# ---------------------------------------------------------------------------


def _parts(A):
    """(value fields, member operators) of an operator whose values take
    gradients, None for one whose values take none."""
    if isinstance(A, (VStackOperator, HStackOperator, SumOperator)):
        return (), A.ops
    if isinstance(A, ScaledOperator):
        return ("alpha",), (A.op,)
    if isinstance(A, ColumnScaledOperator):
        return ("scale",), (A.op,)
    if isinstance(A, ComposedOperator):
        return (), (A.outer, A.inner)
    if isinstance(A, _TransposedOperator):
        return (), (A.op,)
    if isinstance(A, (ChunkedCOOOperator, RWCOOOperator)):
        return (), (A.coo,)
    for cls, fields in STORAGE:
        if isinstance(A, cls):
            return fields, ()
    return None


def _tensors(obj, seen=None):
    """Every tensor an operator holds, through nested operators,
    dataclasses, lists, tuples and the closures of its callables."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item, seen)
    elif isinstance(obj, LinearOperator) or dataclasses.is_dataclass(obj):
        seen.add(id(obj))
        for value in vars(obj).values():
            yield from _tensors(value, seen)
    elif callable(obj):
        seen.add(id(obj))
        yield from _tensors(getattr(obj, "__self__", None), seen)
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                contents = cell.cell_contents
            except ValueError:  # a cell not filled yet
                continue
            yield from _tensors(contents, seen)


def _refusal(A) -> str:
    if isinstance(A, CallbackOperator):
        return ("its products are opaque callables (host products included), so there are "
                "no stored values to sample the gradient on; the JAX package gives a "
                "callback operator no gradient either")
    if A.dtype is not None and A.dtype.is_complex:
        return "lsqr_grad is real-only"
    return "its values take no gradient here (a sharded operator: gradients do not cross ranks)"


def _leaves(A, out=None) -> dict:
    """{id: tensor} of A's floating value tensors, each once, in a fixed
    order, through nested operators. Raises TypeError where a tensor that
    requires grad sits on an operator whose values take no gradient."""
    out = {} if out is None else out
    parts = _parts(A)
    if parts is None:
        if any(t.requires_grad for t in _tensors(A)):
            raise TypeError(f"lsqr_grad takes no gradient to the values of a "
                            f"{type(A).__name__}: {_refusal(A)}; a tensor of it requires grad")
        return out
    fields, members = parts
    for f in fields:
        t = getattr(A, f)
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            out.setdefault(id(t), t)
    for op in members:
        _leaves(op, out)
    return out


# ---------------------------------------------------------------------------
# Sampled outer products
# ---------------------------------------------------------------------------
#
# A use of A is a pair (l, r), l of length m and r of length n: a forward
# use stands for <l, A r> through A's forward product, an adjoint use for
# <A' l, r> through its adjoint product. Both sample l_i r_j at A_ij; a
# layout with separate forward and adjoint copies gives each copy its own
# uses. lsqr_grad's gradient to A's values is minus that of the forward use
# (A s, x) and the adjoint use (r, s), with r = A x - b.


def _stripes(offsets, m, n, u, v):
    """The outer product u v' (u of length m, v of n) sampled on
    row-aligned stripes (len(offsets), m): out[d, i] = u[i] v[i + k] on the
    rows i where 0 <= i + k < n, 0 elsewhere."""
    out = u.new_zeros((len(offsets), m))
    for d, k in enumerate(offsets):
        lo, hi = max(0, -k), min(m, n - k)
        if hi > lo:
            out[d, lo:hi] = u[lo:hi] * v[lo + k:hi + k]
    return out


def _pad(v, length):
    return v if v.shape[0] == length else torch.cat([v, v.new_zeros(length - v.shape[0])])


def _jdia(data, eoff, base, p_lo, tm, u, v):
    """u_i v_j on each slot position of a JDIA packing: u zero-padded to
    the packing's rows, v gathered where the product reads x."""
    return _pad(u, data.shape[1])[None, :] * jdia_gather(eoff, base, v, p_lo=p_lo, tm=tm)


def _blocks(blocks, bcols, u, v):
    """u v' on each (bh, bw) block of a BlockELL packing: the outer product
    of u's block-row segment and v's block-column segment (v padded to the
    packing's columns, u padded here)."""
    mb, _, bh, bw = blocks.shape
    ub = _pad(u, mb * bh).view(mb, bh)
    return ub[:, None, :, None] * v.view(-1, bw)[bcols.long()][:, :, None, :]


def _sample(A, name, fwd, adj):
    """The sum over A's uses of the samples of tensor ``name``."""
    both = fwd + adj
    if isinstance(A, DenseOperator):
        return sum(torch.outer(l, r) for l, r in both)
    if isinstance(A, COOOperator):
        return sum(l[A.rows] * r[A.cols] for l, r in both)
    if isinstance(A, DiagonalOperator):
        return sum(l * r for l, r in both)
    if isinstance(A, DIASharedOperator):
        grad = A.dp.new_zeros((len(A.offsets), A.Lp), dtype=both[0][0].dtype)
        grad[:, A.H:A.H + A.m] = sum(_stripes(A.offsets, A.m, A.n, l, r) for l, r in both)
        return grad.reshape(-1)
    if isinstance(A, DIAOperator):
        if name == "data":
            return sum(_stripes(A.offsets, A.m, A.n, l, r) for l, r in fwd)
        return sum(_stripes(A.toffsets, A.n, A.m, r, l) for l, r in adj)
    if isinstance(A, ELLOperator):
        if name == "vals":
            return sum(l[:, None] * r[A.cols] for l, r in fwd)
        return sum(r[:, None] * l[A.trows] for l, r in adj)
    if isinstance(A, BlockELLOperator):
        if name == "blocks":
            return sum(_blocks(A.blocks, A.bcols, l, _pad(r, A.tblocks.shape[0] * A.bw))
                       for l, r in fwd)
        return sum(_blocks(A.tblocks, A.tbrows, r, _pad(l, A.blocks.shape[0] * A.bh))
                   for l, r in adj)
    if isinstance(A, JDIAOperator):
        if name == "data":
            return sum(_jdia(A.data, A.eoff, A.base, A.p_lo, A.tm, l, r) for l, r in fwd)
        if name == "tdata":
            return sum(_jdia(A.tdata, A.teoff, A.tbase, A.tp_lo, A.tm, r, l) for l, r in adj)
        return sum(l[A.rem_rows] * r[A.rem_cols] for l, r in both)
    raise AssertionError(type(A).__name__)


def _autograd(A, names, fwd, adj):
    """{name: gradient} of an operator whose products are plain torch code
    (no kernel): autograd through them on detached copies of its values."""
    with torch.enable_grad():
        values = {f: getattr(A, f).detach().requires_grad_() for f in names}
        B = dataclasses.replace(A, **values)
        total = (sum(torch.dot(l, B.matvec(r)) for l, r in fwd)
                 + sum(torch.dot(B.rmatvec(l), r) for l, r in adj))
        return dict(zip(names, torch.autograd.grad(total, list(values.values()))))


def _add(acc, t, g):
    if isinstance(g, torch.Tensor):  # else 0: no use reads t
        acc[id(t)] = g if id(t) not in acc else acc[id(t)] + g


def _value_grads(A, fwd, adj, want, acc):
    """Add to ``acc[id(t)]`` the gradient of the uses ``fwd`` and ``adj``
    (lists of (l, r)) to each tensor t of A whose id is in ``want``,
    through nested operators (their products run where a composite's
    scalars or inner members need them)."""
    if not any(key in want for key in _leaves(A)):
        return

    def wants(op):
        return any(key in want for key in _leaves(op))

    def scale(c, uses):
        return [(c * l, r) for l, r in uses]

    if isinstance(A, (VStackOperator, HStackOperator, SumOperator)):
        start = 0
        for op in A.ops:
            rows = slice(start, start + op.m) if isinstance(A, VStackOperator) else slice(None)
            cols = slice(start, start + op.n) if isinstance(A, HStackOperator) else slice(None)
            start += op.m if isinstance(A, VStackOperator) else op.n
            _value_grads(op, [(l[rows], r[cols]) for l, r in fwd],
                         [(l[rows], r[cols]) for l, r in adj], want, acc)
    elif isinstance(A, ScaledOperator):
        if id(A.alpha) in want:
            _add(acc, A.alpha, sum(torch.dot(l, A.op.matvec(r)) for l, r in fwd)
                 + sum(torch.dot(A.op.rmatvec(l), r) for l, r in adj))
        _value_grads(A.op, scale(A.alpha, fwd), scale(A.alpha, adj), want, acc)
    elif isinstance(A, ColumnScaledOperator):
        if id(A.scale) in want:
            _add(acc, A.scale, sum(r * A.op.rmatvec(l) for l, r in fwd + adj))
        _value_grads(A.op, [(l, A.scale * r) for l, r in fwd],
                     [(l, A.scale * r) for l, r in adj], want, acc)
    elif isinstance(A, ComposedOperator):
        if wants(A.outer):
            _value_grads(A.outer, [(l, A.inner.matvec(r)) for l, r in fwd],
                         [(l, A.inner.matvec(r)) for l, r in adj], want, acc)
        if wants(A.inner):
            _value_grads(A.inner, [(A.outer.rmatvec(l), r) for l, r in fwd],
                         [(A.outer.rmatvec(l), r) for l, r in adj], want, acc)
    elif isinstance(A, _TransposedOperator):
        # A.T's forward product is A's adjoint one and the other way round
        _value_grads(A.op, [(r, l) for l, r in adj], [(r, l) for l, r in fwd], want, acc)
    elif isinstance(A, (ChunkedCOOOperator, RWCOOOperator)):
        _value_grads(A.coo, fwd, adj, want, acc)
    elif isinstance(A, PaigeSaundersOperator):
        names = [f for f in ("hy", "hz", "d") if id(getattr(A, f)) in want]
        for f, g in _autograd(A, names, fwd, adj).items():
            _add(acc, getattr(A, f), g)
    else:
        fields, _ = _parts(A)
        for f in fields:
            t = getattr(A, f)
            if id(t) in want:
                _add(acc, t, _sample(A, f, fwd, adj))


class _LSQRGrad(torch.autograd.Function):
    """x = lsqr(A, b, damp).x with the implicit-function backward."""

    @staticmethod
    def forward(ctx, A, options, info, b, damp, *values):
        res = lsqr(A, b, damp, **options)
        if info is not None:
            info.update(istop=int(res.istop), itn=int(res.itn))
        ctx.A, ctx.options, ctx.info = A, options, info
        ctx.save_for_backward(b, damp, res.x)
        return res.x

    @staticmethod
    def backward(ctx, g):
        A = ctx.A
        b, damp, x = ctx.saved_tensors
        tol = ctx.options.get("atol") or 1e-10
        cg = {} if ctx.info is not None else None
        s = normal_cg(A, damp, g, tol=min(float(tol), 1e-8), info=cg)
        if cg is not None:
            ctx.info["cg_itn"] = cg["itn"]
        As = A.matvec(s)
        ddamp = -2.0 * damp * torch.sum(s * x)
        leaves = list(_leaves(A).values())
        want = {id(t) for t, need in zip(leaves, ctx.needs_input_grad[5:]) if need}
        acc = {}
        if want:
            _value_grads(A, [(As, x)], [(A.matvec(x) - b, s)], want, acc)
        grads = tuple(None if id(t) not in want else torch.zeros_like(t) if id(t) not in acc
                      else (-acc[id(t)]).to(t.dtype).reshape(t.shape) for t in leaves)
        return (None, None, None, As, ddamp, *grads)


def lsqr_grad(A, b, damp=0.0, *, m: Optional[int] = None, n: Optional[int] = None,
              info: Optional[dict] = None, **options) -> torch.Tensor:
    """Differentiable ``lsqr(A, b, damp).x``: ``torch.autograd`` gradients
    to b, damp (a tensor) and the operator's values (module docstring) by
    the implicit function theorem, one conjugate-gradient solve on the
    normal operator per backward pass. A value tensor that requires grad
    takes its gradient in ``.grad`` (or passes it on to the tensors it was
    built from).

    ``options`` are :class:`~lsqr_tpu_torch.LSQROptions` overrides for the
    forward solve, atol = btol = 1e-10 unless given: the gradient is exact
    only at the minimizer, so keep them tight (in f32 pass an ``itnlim``).
    Complex problems raise TypeError (real-only), and so does a tensor that
    requires grad on an operator whose values take no gradient (callbacks,
    sharded operators). A dict passed as ``info`` receives the forward
    solve's ``istop`` and ``itn`` and, after the backward pass, the
    conjugate-gradient iterations it ran (``cg_itn``)."""
    A = as_operator(A, m=m, n=n)
    b = as_tensor(b, device=A.device)
    if b.is_complex() or (A.dtype is not None and A.dtype.is_complex):
        raise TypeError(
            "lsqr_grad is real-only; the complex-capable surface is the core solver "
            "family (lsqr/lsmr/cgls/craig)")
    leaves = list(_leaves(A).values())
    options.setdefault("atol", 1e-10)
    options.setdefault("btol", 1e-10)
    damp = as_tensor(damp, dtype=b.dtype, device=b.device)
    return _LSQRGrad.apply(A, options, info, b, damp, *leaves)
