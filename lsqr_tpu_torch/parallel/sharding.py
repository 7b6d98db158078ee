"""Sharded solves over ``torch.distributed``: the rows of A split over a 1-D
mesh of ranks, or A split into blocks over a 2-D one.

PyTorch counterpart of :mod:`lsqr_tpu.parallel.sharding`, with its design:

* A is partitioned by ROWS over a 1-D mesh: each rank owns a contiguous
  block of rows (its shard) and the matching slice of every m-vector (u,
  b). The n-vectors (x, v, w) are replicated: every rank runs the scalar
  recurrence itself, with no communication.
* Each iteration takes two collectives: the transpose product's partial
  sums are summed over the ranks (``all_reduce``, JAX's psum), and so is
  the sum of squares of ``||u||``. The forward product and every n-vector
  operation stay local.
* Over a 2-D (rows x cols) mesh, rank (r, c) owns block (r, c) of A, the
  u-rows of its row block and the x-columns of its column block. The
  forward product is summed over ``cols``, the transpose product over
  ``rows``, each norm over its vector's own axis; x and se are gathered
  once, when the solve ends.

The solvers find the collectives through the operator hooks
``axis_name_m``/``axis_name_n`` (:mod:`..ops.linop`), which here hold the
process groups of a ``torch.distributed.device_mesh.DeviceMesh``.

The port is SPMD as the JAX package is under ``lsqr_multihost``: one
process per rank, every rank calls an entry point with the same global A
and b, takes its own rows or block from them and returns the same result,
bit for bit, on every rank: every all-reduce hands all ranks the same
bits, so all ranks take the same steps and stop at the same iteration. The
host loop of the solvers (``solver._run_segments``) reads each rank's own
stop flag, so any scalar that differed between ranks would make them leave
at different iterations and hang in the next collective.

Where JAX pads every shard to one static shape for ``shard_map``, a rank
here needs only its own shard's shape; the packed layouts (WCOO, WWCOO)
still share JAX's forced shapes, so a shard packs as JAX's does, and each
rank plans every shard (``wcoo_plan``, ``wwcoo_plan``) and packs its own
once. A pack refusal names its shard and is raised on every rank.

Each rank's shard goes on ``device`` when one is given, else on the card
``cuda:{LOCAL_RANK}`` (the rank modulo the card count without that
variable). The local products are the port's operators on the shard:
the banded shards are shared-stripe DIA (or ZDIA) operators over the
shard's column window, so they run the main path's kernels on the card;
the unstructured ones run the WCOO and WWCOO kernels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import LSQROptions, as_dtype, default_dtype, real_dtype
from ..ops.blas import all_sum
from ..ops.coo import COOOperator
from ..ops.linop import LinearOperator, as_tensor, to_numpy

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_coo",
    "ShardedCOO",
    "lsqr_sharded",
    "lsqr_sharded_dia",
    "lsqr_sharded_wcoo",
    "lsqr_sharded_wcoo_2d",
    "lsmr_sharded_wcoo",
    "craig_sharded_wcoo",
    "cgls_sharded_wcoo",
    "lsqr_sharded_2d",
    "lsmr_sharded",
    "craig_sharded",
    "cgls_sharded",
    "cgls_sharded_2d",
    "cgls_sharded_dia",
    "craig_sharded_dia",
    "lsmr_sharded_dia",
    "craig_sharded_2d",
    "lsmr_sharded_2d",
]


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def _world():
    """torch.distributed, with a world of one process set up when none is
    (so that a sharded solve runs in a plain process, as JAX's do on its
    local devices)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return dist


def _device_mesh(ranks, names):
    """A DeviceMesh over ``ranks`` (an int tensor of the mesh's shape). All
    ranks of the world call it, those outside the mesh too. Its device type
    follows the backend: the groups of a gloo world take CUDA tensors too."""
    from torch.distributed.device_mesh import DeviceMesh

    dist = _world()
    if ranks.numel() > dist.get_world_size():
        raise ValueError(f"need {ranks.numel()} ranks, have {dist.get_world_size()}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rows"):
    """A 1-D mesh over the first ``n_devices`` ranks of the world (default:
    all), as JAX's over the first devices. Every rank of the world calls
    it; a rank outside the mesh takes no part in its solves."""
    n = _world().get_world_size() if n_devices is None else int(n_devices)
    return _device_mesh(torch.arange(n), (axis_name,))


def make_mesh_2d(shape: tuple, axis_names: tuple = ("rows", "cols")):
    """A 2-D (rows x cols) mesh over the first prod(shape) ranks. The
    collectives an iteration are one sum over 'cols' (the forward
    product's partials) and one over 'rows' (the transpose product's)."""
    r, c = shape
    return _device_mesh(torch.arange(r * c).reshape(r, c), axis_names)


def _axis(mesh, name):
    """(process group, size, this rank's index) of a mesh axis; with no
    mesh, of the 1-D mesh over the world (:func:`make_mesh`)."""
    if mesh is None:
        mesh = make_mesh(axis_name=name)
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"the mesh has no axis {name!r} (axes {names})")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    dim = names.index(name)
    return mesh.get_group(name), mesh.size(dim), coord[dim]


def _rank_device(device):
    """Where this rank's shard goes: ``device``, else its card."""
    if device is not None:
        return torch.device(device)
    dist = _world()
    local = os.environ.get("LOCAL_RANK")
    local = int(local) if local is not None else dist.get_rank() % max(
        torch.cuda.device_count(), 1)
    return torch.device(f"cuda:{local}")


def _agree(groups, device, error):
    """Raise ``error`` (or the error of another rank's shard) on every rank
    of the mesh, whose axes' process groups are ``groups``, when any rank
    has one: a rank that raised alone would leave the others waiting in the
    solve's first collective."""
    failed = torch.tensor([0 if error is None else 1], device=device)
    for group in groups:  # summed over each axis in turn: over the mesh
        all_sum(failed, group)
    if error is not None:
        raise error
    if int(failed):
        raise ValueError(f"{int(failed)} other rank(s) failed to build their shard")


def _options(options, overrides) -> LSQROptions:
    opts = options or LSQROptions()
    return opts.replace(**overrides) if overrides else opts


def _solve_dtype(dtype, b, stored):
    """The working dtype: the option, else that of b and A's values; ints
    give the default float (JAX's ``result_type`` rule)."""
    dtype = as_dtype(dtype) or torch.promote_types(b.dtype, stored)
    return dtype if dtype.is_floating_point or dtype.is_complex else default_dtype()


def _local_b(b, m, start, rows, dtype, device):
    """This rank's slice b[start:start + rows] of the global b (m,), zero
    past m."""
    b = as_tensor(b, device="cpu")
    if tuple(b.shape) != (m,):
        raise ValueError(f"b must have shape ({m},), got {tuple(b.shape)}")
    out = torch.zeros(rows, dtype=dtype)
    stop = min(m, start + rows)
    if stop > start:
        out[:stop - start] = b[start:stop].to(dtype)
    return out.to(device)


# ---------------------------------------------------------------------------
# The shard operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _RowShard(LinearOperator):
    """One rank's rows of a row-partitioned matrix. ``local`` holds the
    shard's rows over the columns [col0, col0 + local.n) of the n global
    ones (a banded shard's window, zero outside [0, n)), or over all n
    columns (col0 = 0, local.n = n). x stays replicated: the forward product
    is local; the transpose product's partial sums are summed over
    ``group``, the ranks of the row axis."""

    local: LinearOperator
    group: object
    global_m: int
    n: int
    col0: int = 0

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.local.m

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def axis_name_m(self):
        return self.group

    @property
    def supports_complex_pair(self) -> bool:
        return bool(getattr(self.local, "supports_complex_pair", False))

    def _span(self):
        """(lo, hi): the part of the window inside [0, n) (empty for the
        rows of a tall matrix past its last column)."""
        lo = max(0, -self.col0)
        return lo, max(lo, min(self.local.n, self.n - self.col0))

    def _window(self, x):
        if self.col0 == 0 and self.local.n == self.n:
            return x
        lo, hi = self._span()
        xw = x.new_zeros(self.local.n)
        xw[lo:hi] = x[self.col0 + lo:self.col0 + hi]
        return xw

    def _place(self, z):
        """The window's partial sums as an n-vector, summed over the ranks."""
        if not (self.col0 == 0 and self.local.n == self.n):
            lo, hi = self._span()
            zw, z = z, z.new_zeros(self.n)
            z[self.col0 + lo:self.col0 + hi] = zw[lo:hi]
        return all_sum(z, self.group)

    def matvec(self, x):
        return self.local.matvec(self._window(x))

    def rmatvec(self, y):
        return self._place(self.local.rmatvec(y))

    def fused_pair(self, *, y, win, c1, c2):
        """Both products from the local operator's pair kernel (one pass)
        and one all-reduce: the sharded ``dia_pair``. The entry points ask
        for it only of a local operator that has one."""
        u, z = self.local.fused_pair(y=y, win=self._window(win), c1=c1, c2=c2)
        return u, self._place(z)


@dataclasses.dataclass(frozen=True, eq=False)
class _BlockShard(LinearOperator):
    """One rank's block of a 2-D partition: ``local`` is block (r, c), with
    local row and column indices. The forward product's partials are
    summed over ``group_n`` (the 'cols' axis), the transpose product's over
    ``group_m`` ('rows'); u-norms complete over 'rows', x-norms over
    'cols'."""

    local: LinearOperator
    group_m: object
    group_n: object
    global_m: int
    global_n: int

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.local.m

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.local.n

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def axis_name_m(self):
        return self.group_m

    @property
    def axis_name_n(self):
        return self.group_n

    def matvec(self, x):
        return all_sum(self.local.matvec(x), self.group_n)

    def rmatvec(self, y):
        return all_sum(self.local.rmatvec(y), self.group_m)


# ---------------------------------------------------------------------------
# The solve loops on a shard (the JAX package's _lsqr_impl and siblings)
# ---------------------------------------------------------------------------


def _run_lsqr(op, b, damp, opts, *, pair):
    from ..solver import _build, _run_segments

    rd = real_dtype(b.dtype)
    itnlim = opts.resolve_itnlim(getattr(op, "global_n", op.n))
    log = [] if opts.debug_log else None
    carry0, cond_fun, body_fun, finalize = _build(
        op, b, *(as_tensor(v, dtype=rd, device=b.device)
                 for v in (damp, opts.atol, opts.btol, opts.conlim)),
        itnlim=itnlim, wantse=opts.wantse, nconv=opts.nconv,
        record_trace=opts.record_trace, safe_norms=opts.safe_norms, fused=pair,
        pair=pair, scalar_dtype=as_dtype(opts.scalar_dtype), log_rows=log)
    return finalize(_run_segments(carry0, cond_fun, body_fun, A=op, itnlim=itnlim,
                                  seg_len=opts.loop_segment, log=log))


def _sibling(name):
    """(builder, its scalar arguments, default itnlim of (m, n)) of LSMR,
    CGLS or CRAIG."""
    from ..cgls import _build as cgls
    from ..craig import _build as craig
    from ..lsmr import _build as lsmr

    return {"lsmr": (lsmr, ("damp", "atol", "btol", "conlim"), min),
            "cgls": (cgls, ("damp", "atol", "btol"), lambda m, n: 4 * n),
            "craig": (craig, ("atol", "btol"), min)}[name]


def _run_sibling(name, op, b, scalars, *, itnlim, safe_norms, pair, **kw):
    from ..solver import _run_segments

    build, keys, default = _sibling(name)
    if itnlim is None:
        itnlim = default(op.global_m, getattr(op, "global_n", op.n))
    rd = real_dtype(b.dtype)
    carry0, cond_fun, body_fun, finalize = build(
        op, b, *(as_tensor(scalars[k], dtype=rd, device=b.device) for k in keys),
        itnlim=int(itnlim), safe_norms=safe_norms, pair=pair, **kw)
    return finalize(_run_segments(carry0, cond_fun, body_fun, A=op, itnlim=int(itnlim),
                                  seg_len=64))


# ---------------------------------------------------------------------------
# COO row partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedCOO:
    """Host-side row partition of a COO matrix (JAX's, array for array):
    vals/rows/cols (ndev, nnz_max) CPU tensors, rows holding LOCAL indices
    (int32), each shard padded with zero entries; m_pad the padded global
    row count (ndev * rows_per_dev)."""

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    m: int
    n: int
    m_pad: int
    ndev: int

    @property
    def rows_per_dev(self) -> int:
        return self.m_pad // self.ndev


def shard_coo(A: COOOperator, ndev: int) -> ShardedCOO:
    """Partition a COO operator into ``ndev`` contiguous row blocks with
    equal shapes (zero padding for ragged nnz)."""
    rows, cols, vals = to_numpy(A.rows), to_numpy(A.cols), to_numpy(A.vals)
    m, n = A.m, A.n
    m_pad = -(-m // ndev) * ndev
    rpd = m_pad // ndev
    dev_of = rows // rpd
    order = np.argsort(dev_of, kind="stable")
    rows, cols, vals, dev_of = rows[order], cols[order], vals[order], dev_of[order]
    counts = np.bincount(dev_of, minlength=ndev)
    nnz_max = max(int(counts.max()) if counts.size else 0, 1)
    out_vals = np.zeros((ndev, nnz_max), vals.dtype)
    out_rows = np.zeros((ndev, nnz_max), np.int32)
    out_cols = np.zeros((ndev, nnz_max), np.int32)
    start = 0
    for d in range(ndev):
        c = int(counts[d])
        sl = slice(start, start + c)
        out_vals[d, :c] = vals[sl]
        out_rows[d, :c] = rows[sl] - d * rpd
        out_cols[d, :c] = cols[sl]
        start += c
    return ShardedCOO(vals=torch.from_numpy(out_vals), rows=torch.from_numpy(out_rows),
                      cols=torch.from_numpy(out_cols), m=m, n=n, m_pad=m_pad, ndev=ndev)


def _coo_rows(A, b, mesh, axis_name, device, dtype=None):
    """(this rank's row shard of a COOOperator or ShardedCOO, its b)."""
    group, ndev, r = _axis(mesh, axis_name)
    if isinstance(A, COOOperator):
        sharded = shard_coo(A, ndev)
    elif isinstance(A, ShardedCOO):
        sharded = A
        if sharded.ndev != ndev:
            raise ValueError(f"ShardedCOO was built for {sharded.ndev} devices, mesh has {ndev}")
    else:
        raise TypeError("expected a COOOperator or ShardedCOO; for other operators run "
                        "lsqr() on your own shard operator whose axis_name_m names the "
                        "row group")
    dev = _rank_device(device)
    rpd = sharded.rows_per_dev
    dtype = _solve_dtype(dtype, as_tensor(b, device="cpu"), sharded.vals.dtype)
    b_local = _local_b(b, sharded.m, r * rpd, rpd, dtype, dev)
    local = COOOperator(vals=sharded.vals[r].to(device=dev, dtype=dtype),
                        rows=sharded.rows[r].to(device=dev, dtype=torch.int64),
                        cols=sharded.cols[r].to(device=dev, dtype=torch.int64),
                        m=rpd, n=sharded.n)
    return _RowShard(local, group, sharded.m, sharded.n), b_local


def lsqr_sharded(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                 options: Optional[LSQROptions] = None, device=None, **option_overrides):
    """Row-partitioned LSQR over the ranks of a 1-D mesh (default: all).

    Args:
      A: a COOOperator (partitioned here) or a pre-built ShardedCOO.
      b: the global right-hand side (m,), the same on every rank.
      mesh: a 1-D mesh (:func:`make_mesh`); ``device``: where this rank's
        shard goes (default: its card).

    Semantics are those of :func:`lsqr_tpu_torch.lsqr`: the sharded and
    unsharded solvers give the same iterates up to the order of the sums."""
    opts = _options(options, option_overrides)
    op, b_local = _coo_rows(A, b, mesh, axis_name, device, opts.dtype)
    return _run_lsqr(op, b_local, damp, opts, pair=False)


def lsmr_sharded(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                 atol: float = 1e-6, btol: float = 1e-6, conlim: float = 1e8,
                 itnlim: Optional[int] = None, record_trace: bool = False,
                 safe_norms: bool = True, device=None):
    """Row-partitioned LSMR (see :func:`lsqr_tpu_torch.lsmr`), with the
    partition and collectives of :func:`lsqr_sharded`."""
    op, b_local = _coo_rows(A, b, mesh, axis_name, device)
    return _run_sibling("lsmr", op, b_local, dict(damp=damp, atol=atol, btol=btol,
                                                  conlim=conlim),
                        itnlim=itnlim, safe_norms=safe_norms, pair=False,
                        record_trace=record_trace)


def cgls_sharded(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                 atol: float = 1e-6, btol: float = 1e-6, itnlim: Optional[int] = None,
                 safe_norms: bool = True, device=None):
    """Row-partitioned CGLS (see :func:`lsqr_tpu_torch.cgls`)."""
    op, b_local = _coo_rows(A, b, mesh, axis_name, device)
    return _run_sibling("cgls", op, b_local, dict(damp=damp, atol=atol, btol=btol),
                        itnlim=itnlim, safe_norms=safe_norms, pair=False)


def craig_sharded(A, b, *, mesh=None, axis_name: str = "rows", atol: float = 1e-6,
                  btol: float = 1e-6, itnlim: Optional[int] = None,
                  safe_norms: bool = True, device=None):
    """Row-partitioned CRAIG (see :func:`lsqr_tpu_torch.craig`)."""
    op, b_local = _coo_rows(A, b, mesh, axis_name, device)
    return _run_sibling("craig", op, b_local, dict(atol=atol, btol=btol), itnlim=itnlim,
                        safe_norms=safe_norms, pair=False)


# ---------------------------------------------------------------------------
# Banded (DIA, ZDIA) row partitions
# ---------------------------------------------------------------------------


def _band_rows(stripes, offsets, m, n, b, mesh, axis_name, device, dtype):
    """(this rank's shard of row-aligned stripes (nd, m), its b). The shard
    is a shared-stripe DIA operator (ZDIA for complex stripes) over its
    column window: rows [row0, row0 + rpd) read the columns
    [row0 - lo, row0 + rpd + hi), so its offsets are shifted by lo and x
    needs no halo exchange (x is replicated). The last shard's rows past m
    are zero."""
    from ..ops.structured import dia_shared_operator
    from ..ops.zdia import zdia_operator_device

    group, ndev, r = _axis(mesh, axis_name)
    dev = _rank_device(device)
    rpd = -(-m // ndev)
    row0 = r * rpd
    ks = tuple(offsets) or (0,)
    lo, hi = max(0, -min(ks)), max(0, max(ks))
    local = stripes.new_zeros((len(offsets), rpd))
    stop = min(m, row0 + rpd)
    if stop > row0:
        local[:, :stop - row0] = stripes[:, row0:stop]
    local = local.to(dev)
    shifted = tuple(k + lo for k in offsets)
    if local.is_complex():
        op = zdia_operator_device(rpd, lo + rpd + hi, shifted, local)
    else:
        op = dia_shared_operator(rpd, lo + rpd + hi, shifted, local, device=dev)
    b_local = _local_b(b, m, row0, rpd, dtype, dev)
    return _RowShard(op, group, m, n, col0=row0 - lo), b_local


def _dia_rows(A, b, mesh, axis_name, device, dtype=None):
    """The banded row shard of a DIAOperator or DIASharedOperator: its
    stripes in the working dtype (bf16 stripes stay bf16 for an f32 solve)."""
    from ..ops.structured import DIAOperator, DIASharedOperator

    if not isinstance(A, (DIAOperator, DIASharedOperator)):
        raise TypeError("the DIA sharded solvers expect a DIAOperator or DIASharedOperator")
    dtype = as_dtype(dtype) or A.dtype
    stripes = A.data
    if stripes.dtype != dtype and not (stripes.dtype == torch.bfloat16
                                       and dtype == torch.float32):
        stripes = stripes.to(dtype)
    return _band_rows(stripes, A.offsets, A.m, A.n, b, mesh, axis_name, device, dtype)


def lsqr_sharded_dia(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                     options: Optional[LSQROptions] = None, device=None, **option_overrides):
    """Row-partitioned solve of a banded operator (``DIAOperator`` or
    ``DIASharedOperator``). Each rank owns a contiguous row block of the
    stripes; x/v/w stay replicated, so the banded forward product needs no
    halo exchange, and the transpose product is summed with one all-reduce
    an iteration. ``options.pair`` (opt-in, as in JAX) takes both products
    from one local stripe pass (``dia_pair_shared`` on the card) and one
    all-reduce."""
    opts = _options(options, option_overrides)
    op, b_local = _dia_rows(A, b, mesh, axis_name, device, opts.dtype)
    return _run_lsqr(op, b_local, damp, opts, pair=bool(opts.pair))


def lsmr_sharded_dia(A, b, damp=0.0, *, mesh=None, axis_name="rows", atol=1e-6,
                     btol=1e-6, conlim=0.0, itnlim=None, safe_norms=True, pair=False,
                     device=None):
    """Row-partitioned LSMR on a banded operator (the partition of
    :func:`lsqr_sharded_dia`); ``pair=True`` takes both products from one
    local stripe pass."""
    op, b_local = _dia_rows(A, b, mesh, axis_name, device)
    return _run_sibling("lsmr", op, b_local, dict(damp=damp, atol=atol, btol=btol,
                                                  conlim=conlim),
                        itnlim=itnlim, safe_norms=safe_norms, pair=bool(pair),
                        record_trace=False)


def craig_sharded_dia(A, b, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                      itnlim=None, safe_norms=True, pair=False, device=None):
    """Row-partitioned CRAIG on a banded operator."""
    op, b_local = _dia_rows(A, b, mesh, axis_name, device)
    return _run_sibling("craig", op, b_local, dict(atol=atol, btol=btol), itnlim=itnlim,
                        safe_norms=safe_norms, pair=bool(pair))


def cgls_sharded_dia(A, b, damp=0.0, *, mesh=None, axis_name="rows", atol=1e-6,
                     btol=1e-6, itnlim=None, safe_norms=True, pair=False, device=None):
    """Row-partitioned CGLS on a banded operator."""
    op, b_local = _dia_rows(A, b, mesh, axis_name, device)
    return _run_sibling("cgls", op, b_local, dict(damp=damp, atol=atol, btol=btol),
                        itnlim=itnlim, safe_norms=safe_norms, pair=bool(pair))


def lsqr_sharded_zdia(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                      options: Optional[LSQROptions] = None, device=None,
                      **option_overrides):
    """Row-partitioned solve of a complex banded operator (``ZDIAOperator``):
    each rank owns a row block of the two real stripe planes, the transpose
    product is summed as complex values, and every scalar of the recurrence
    stays real. ``options.pair`` takes both products from one local plane
    pass (``zdia_pair`` on the card)."""
    from ..ops.zdia import ZDIAOperator

    if not isinstance(A, ZDIAOperator):
        raise TypeError("lsqr_sharded_zdia expects a ZDIAOperator")
    opts = _options(options, option_overrides)
    op, b_local = _band_rows(torch.complex(A.dr, A.di), A.offsets, A.m, A.n, b, mesh,
                             axis_name, device, A.dtype)
    return _run_lsqr(op, b_local, damp, opts, pair=bool(opts.pair))


# ---------------------------------------------------------------------------
# Multi-damp sweeps over a row partition
# ---------------------------------------------------------------------------


@tracing.entry("lsqr_multidamp_sharded", rows="damps", rows_by_length=True)
def lsqr_multidamp_sharded(A, b, damps, *, mesh=None, axis_name: str = "rows",
                           options: Optional[LSQROptions] = None, device=None,
                           **option_overrides):
    """Row-partitioned multi-damp solve: the whole damp grid from one shared
    bidiagonalization (:func:`lsqr_tpu_torch.lsqr_multidamp`) with A's rows
    split over the mesh; the same two collectives an iteration serve every
    damp. ``A``: a COOOperator/ShardedCOO or a banded operator (pair mode
    through ``options.pair``). Returns an LSQRResult with a leading (k,)
    axis."""
    from ..multidamp import _damps, build_lsqr_rows, solve_rows
    from ..ops.structured import DIAOperator, DIASharedOperator

    opts = _options(options, option_overrides)
    if opts.record_trace or opts.debug_log:
        raise ValueError("record_trace/debug_log are not supported by the multi-damp solvers")
    if isinstance(A, (DIAOperator, DIASharedOperator)):
        op, b_local = _dia_rows(A, b, mesh, axis_name, device, opts.dtype)
        pair = bool(opts.pair)
    elif isinstance(A, (COOOperator, ShardedCOO)):
        op, b_local = _coo_rows(A, b, mesh, axis_name, device, opts.dtype)
        pair = False
    else:
        raise TypeError("lsqr_multidamp_sharded expects a COOOperator/ShardedCOO or a "
                        "DIAOperator")
    rd = real_dtype(b_local.dtype)
    itnlim = opts.resolve_itnlim(op.n)

    def scalar(v):
        return as_tensor(v, dtype=rd, device=b_local.device)

    with tracing.span("prepare"):
        pieces = build_lsqr_rows(
            op, b_local, _damps(damps, b_local.dtype, b_local.device), scalar(opts.atol),
            scalar(opts.btol), scalar(opts.conlim), batched=False, itnlim=itnlim,
            wantse=opts.wantse, nconv=opts.nconv, safe_norms=opts.safe_norms, fused=pair,
            pair=pair, scalar_dtype=as_dtype(opts.scalar_dtype))
    return solve_rows(pieces, A=op, itnlim=itnlim, seg_len=opts.loop_segment)


# ---------------------------------------------------------------------------
# 2-D (rows x cols) block partitions
# ---------------------------------------------------------------------------


def _grid(mesh, mesh_shape, axis_names):
    if mesh is None:
        if mesh_shape is None:
            raise ValueError("pass mesh= or mesh_shape=(R, C)")
        mesh = make_mesh_2d(mesh_shape, axis_names)
    (gm, nr, r), (gn, nc, c) = (_axis(mesh, name) for name in axis_names)
    return gm, nr, r, gn, nc, c


def _blocks(coo, nr, nc):
    """(m_pad, n_pad, rpd, cpd, bucket starts and ends, the triplets sorted
    by block r * nc + c) of a COO operator's entries on an (nr, nc) grid."""
    rows, cols, vals = to_numpy(coo.rows), to_numpy(coo.cols), to_numpy(coo.vals)
    m, n = coo.m, coo.n
    m_pad, n_pad = -(-m // nr) * nr, -(-n // nc) * nc
    rpd, cpd = m_pad // nr, n_pad // nc
    bucket = (rows // rpd) * nc + cols // cpd
    order = np.argsort(bucket, kind="stable")
    rows, cols, vals, bucket = rows[order], cols[order], vals[order], bucket[order]
    starts = np.searchsorted(bucket, np.arange(nr * nc))
    ends = np.searchsorted(bucket, np.arange(nr * nc), side="right")
    return m_pad, n_pad, rpd, cpd, starts, ends, (vals, rows, cols)


def _block(triplets, starts, ends, bidx, nc, rpd, cpd, empty_entry):
    """(vals, local rows, local cols) of block bidx; one explicit zero entry
    for an empty block where ``empty_entry`` (the packed layouts need one)."""
    vals, rows, cols = triplets
    r, c = divmod(bidx, nc)
    sl = slice(int(starts[bidx]), int(ends[bidx]))
    if sl.start == sl.stop and empty_entry:
        return np.zeros(1, np.float32), np.zeros(1, np.int64), np.zeros(1, np.int64)
    return vals[sl], rows[sl] - r * rpd, cols[sl] - c * cpd


def _coo_blocks(A, b, mesh, mesh_shape, axis_names, device, dtype=None):
    """(this rank's block of a COOOperator, its b, gather of a column-split
    n-vector)."""
    if not isinstance(A, COOOperator):
        raise TypeError("2-D sharded solvers expect a COOOperator")
    gm, nr, r, gn, nc, c = _grid(mesh, mesh_shape, axis_names)
    dev = _rank_device(device)
    m_pad, n_pad, rpd, cpd, starts, ends, trip = _blocks(A, nr, nc)
    vals, rows, cols = _block(trip, starts, ends, r * nc + c, nc, rpd, cpd, False)
    dtype = _solve_dtype(dtype, as_tensor(b, device="cpu"), A.vals.dtype)
    local = COOOperator(vals=torch.from_numpy(np.ascontiguousarray(vals)).to(dev, dtype),
                        rows=torch.from_numpy(rows.astype(np.int64)).to(dev),
                        cols=torch.from_numpy(cols.astype(np.int64)).to(dev), m=rpd, n=cpd)
    op = _BlockShard(local=local, group_m=gm, group_n=gn, global_m=A.m, global_n=A.n)
    return op, _local_b(b, A.m, r * rpd, rpd, dtype, dev), _gather(gn, c, cpd, A.n)


def _gather(group_n, c, cpd, n):
    """The whole n-vector from each rank's column slice: an all-reduce of a
    zero-filled vector into which each rank writes its own slice (exact:
    every other addend is zero)."""
    def gather(v):
        if v is None:
            return None
        full = v.new_zeros(cpd * group_n.size())
        full[c * cpd:(c + 1) * cpd] = v
        return all_sum(full, group_n)[:n]

    return gather


def _lsqr_2d(op, b_local, gather, damp, opts):
    res = _run_lsqr(op, b_local, damp, opts, pair=False)
    # x (and se) live column-split over the mesh; gathered once, here
    return res._replace(x=gather(res.x), se=gather(res.se))


def lsqr_sharded_2d(A, b, damp: float = 0.0, *, mesh=None, mesh_shape: Optional[tuple] = None,
                    axis_names: tuple = ("rows", "cols"),
                    options: Optional[LSQROptions] = None, device=None, **option_overrides):
    """LSQR over a 2-D (rows x cols) block partition of a COOOperator.

    Every vector is split along its own dimension: u/b over 'rows', x/v/w/se
    over 'cols', so both m and n scale past one card. A (1, C) mesh gives
    pure column sharding, (R, 1) the row-sharded solve. Returns the whole x
    (and se) on every rank, gathered once when the solve ends."""
    opts = _options(options, option_overrides)
    op, b_local, gather = _coo_blocks(A, b, mesh, mesh_shape, axis_names, device,
                                      opts.dtype)
    return _lsqr_2d(op, b_local, gather, damp, opts)


def _sibling_2d(name, A, b, scalars, mesh, mesh_shape, axis_names, itnlim, safe_norms,
                device, **kw):
    op, b_local, gather = _coo_blocks(A, b, mesh, mesh_shape, axis_names, device)
    res = _run_sibling(name, op, b_local, scalars, itnlim=itnlim, safe_norms=safe_norms,
                       pair=False, **kw)
    return res._replace(x=gather(res.x))


def lsmr_sharded_2d(A, b, damp: float = 0.0, *, mesh=None, mesh_shape=None,
                    axis_names=("rows", "cols"), atol: float = 1e-6, btol: float = 1e-6,
                    conlim: float = 0.0, itnlim: Optional[int] = None, safe_norms: bool = True,
                    device=None):
    """LSMR over a 2-D block partition (see :func:`lsqr_sharded_2d`)."""
    return _sibling_2d("lsmr", A, b, dict(damp=damp, atol=atol, btol=btol, conlim=conlim),
                       mesh, mesh_shape, axis_names, itnlim, safe_norms, device,
                       record_trace=False)


def craig_sharded_2d(A, b, *, mesh=None, mesh_shape=None, axis_names=("rows", "cols"),
                     atol: float = 1e-6, btol: float = 1e-6, itnlim: Optional[int] = None,
                     safe_norms: bool = True, device=None):
    """CRAIG over a 2-D block partition."""
    return _sibling_2d("craig", A, b, dict(atol=atol, btol=btol), mesh, mesh_shape,
                       axis_names, itnlim, safe_norms, device)


def cgls_sharded_2d(A, b, damp: float = 0.0, *, mesh=None, mesh_shape=None,
                    axis_names=("rows", "cols"), atol: float = 1e-6, btol: float = 1e-6,
                    itnlim: Optional[int] = None, safe_norms: bool = True, device=None):
    """CGLS over a 2-D block partition."""
    return _sibling_2d("cgls", A, b, dict(damp=damp, atol=atol, btol=btol), mesh,
                       mesh_shape, axis_names, itnlim, safe_norms, device)


# ---------------------------------------------------------------------------
# The packed unstructured layouts: WCOO, RWCOO, WWCOO
# ---------------------------------------------------------------------------


def _pack_shard(label, plan_and_pack, groups, device):
    """Run ``plan_and_pack()`` (plans of every shard, then this rank's
    packing); a pack refusal raises on every rank of the mesh, naming its
    shard: a refusal under the shared (forced) shapes is a property of one
    shard, not of the matrix (the JAX package let it escape unnamed)."""
    from ..ops.wcoo import WCOOPackError
    from ..ops.wwcoo import WWCOOPackError

    out, error = None, None
    try:
        out = plan_and_pack()
    except (WCOOPackError, WWCOOPackError) as e:
        error = type(e)(f"{label}: {e}; the COO sharded solvers (lsqr_sharded, "
                        f"lsqr_sharded_2d) take any pattern")
        error.__cause__ = e
    _agree(groups, device, error)
    return out


def _wcoo_triplets(A, kinds, name):
    coo = getattr(A, "coo", None) if isinstance(A, kinds) else A
    if not isinstance(coo, COOOperator):
        raise TypeError(f"{name} expects a {' or '.join(k.__name__ for k in kinds)} "
                        "or COOOperator")
    return coo


def _row_triplets(coo, ndev):
    """(rows per shard, the shards' (vals f32, local rows, cols), one
    explicit zero entry for an empty shard)."""
    vals = to_numpy(coo.vals).astype(np.float32, copy=False)
    rows = to_numpy(coo.rows).astype(np.int64, copy=False)
    cols = to_numpy(coo.cols).astype(np.int64, copy=False)
    rpd = -(-coo.m // ndev)
    shard_of = rows // rpd
    order = np.argsort(shard_of, kind="stable")
    vals, rows, cols, shard_of = vals[order], rows[order], cols[order], shard_of[order]
    starts = np.searchsorted(shard_of, np.arange(ndev))
    ends = np.searchsorted(shard_of, np.arange(ndev), side="right")
    shards = []
    for s in range(ndev):
        sl = slice(int(starts[s]), int(ends[s]))
        if sl.start == sl.stop:
            shards.append((np.zeros(1, np.float32), np.zeros(1, np.int64),
                           np.zeros(1, np.int64)))
        else:
            shards.append((vals[sl], rows[sl] - s * rpd, cols[sl]))
    return rpd, shards


def _wcoo_force(plans):
    """The force_* knobs of a WCOO packing shared by shards of these plans."""
    return dict(force_emax=max(p["emax"] for p in plans), force_kb=max(p["kb"] for p in plans),
                force_ku=max(p["ku"] for p in plans))


def _wwcoo_force(plans):
    return dict(force_emax=max(p["emax"] for p in plans), force_kb=max(p["kb"] for p in plans),
                force_js=max(p["js"] for p in plans), force_w=max(p["w"] for p in plans))


def _wcoo_rows(A, b, mesh, axis_name, device):
    """(this rank's WCOO row shard, its b): every shard packed to one shape
    (JAX's forced capacities, from the plans), this rank's packed once."""
    from ..ops.wcoo import WCOOOperator, wcoo_pack, wcoo_plan

    coo = _wcoo_triplets(A, (WCOOOperator,), "the WCOO sharded solvers")
    group, ndev, r = _axis(mesh, axis_name)
    dev = _rank_device(device)
    m, n = coo.m, coo.n
    rpd, shards = _row_triplets(coo, ndev)

    def plan_and_pack():
        force = _wcoo_force([wcoo_plan(rpd, n, s[1], s[2]) for s in shards])
        return wcoo_pack(rpd, n, *shards[r], **force, device=dev)

    packed = _pack_shard(f"shard {r} of {ndev} (rows {r * rpd}..)", plan_and_pack, (group,),
                         dev)
    local = WCOOOperator(packed=packed, coo=None)
    return _RowShard(local, group, m, n), _local_b(b, m, r * rpd, rpd, torch.float32, dev)


def _pair_default(pair):
    """The WCOO-family shards take the pair unless told otherwise (JAX's
    shards prefer it: one kernel pass and one all-reduce)."""
    return True if pair is None else bool(pair)


def lsqr_sharded_wcoo(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                      options: Optional[LSQROptions] = None, device=None,
                      **option_overrides):
    """Row-partitioned LSQR for unstructured sparsity with n <= 4096, each
    shard a WCOO packing (``A``: a WCOOOperator, whose triplets are
    reused, or a COOOperator) running the WCOO kernels on the card
    (``wcoo_pair`` with one all-reduce an iteration, unless
    ``options.pair`` is False). Communication as in :func:`lsqr_sharded`."""
    opts = _options(options, option_overrides)
    op, b_local = _wcoo_rows(A, b, mesh, axis_name, device)
    return _run_lsqr(op, b_local, damp, opts, pair=_pair_default(opts.pair))


def _rwcoo_rows(A, b, mesh, axis_name, device):
    """(this rank's RWCOO row shard, its b): the hot columns chosen over the
    whole matrix (every shard shares one hotmap), each shard a hot WCOO
    panel and a cold WWCOO stream, packed to shapes shared by all shards."""
    from ..ops.rwcoo import _K_HOT, RWCOOOperator
    from ..ops.wcoo import wcoo_pack, wcoo_plan
    from ..ops.wwcoo import wwcoo_pack, wwcoo_plan

    coo = _wcoo_triplets(A, (RWCOOOperator,), "the RWCOO sharded solvers")
    if isinstance(A, RWCOOOperator):
        hotcols = to_numpy(A.hotmap).astype(np.int64)
    else:
        counts = np.bincount(to_numpy(coo.cols), minlength=coo.n)
        k_hot = min(_K_HOT, int((counts > 0).sum()))
        hotcols = np.sort(np.argpartition(counts, -k_hot)[-k_hot:])
    group, ndev, r = _axis(mesh, axis_name)
    dev = _rank_device(device)
    m, n, k_hot = coo.m, coo.n, len(hotcols)
    hpos = np.full(n, -1, np.int64)
    hpos[hotcols] = np.arange(k_hot)
    rpd, shards = _row_triplets(coo, ndev)
    z1 = (np.zeros(1, np.float32), np.zeros(1, np.int64), np.zeros(1, np.int64))

    def split(v, rr, cc):
        h = hpos[cc] >= 0
        hot, cold = (v[h], rr[h], hpos[cc[h]]), (v[~h], rr[~h], cc[~h])
        return (hot if len(hot[0]) else z1), (cold if len(cold[0]) else z1)

    def plan_and_pack():
        parts = [split(*s) for s in shards]
        hkw = _wcoo_force([wcoo_plan(rpd, k_hot, h[1], h[2]) for h, _ in parts])
        ckw = _wwcoo_force([wwcoo_plan(rpd, n, c[1], c[2]) for _, c in parts])
        hot, cold = parts[r]
        return (wcoo_pack(rpd, k_hot, *hot, **hkw, device=dev),
                wwcoo_pack(rpd, n, *cold, **ckw, device=dev))

    hot, cold = _pack_shard(f"shard {r} of {ndev} (rows {r * rpd}..)", plan_and_pack,
                            (group,), dev)
    local = RWCOOOperator(hot=hot, hotmap=torch.from_numpy(hotcols.astype(np.int32)).to(dev),
                          cold=cold, coo=None, n=int(n))
    return _RowShard(local, group, m, n), _local_b(b, m, r * rpd, rpd, torch.float32, dev)


def lsqr_sharded_rwcoo(A, b, damp: float = 0.0, *, mesh=None, axis_name: str = "rows",
                       options: Optional[LSQROptions] = None, device=None,
                       **option_overrides):
    """Row-partitioned LSQR for wide unstructured sparsity (4096 < n <=
    262,144) with column concentration: each shard runs the RWCOO routed
    kernels (hot panel through WCOO, the sparse tail through WWCOO) on its
    row block. A shard that its packer refuses raises on every rank, named
    (:class:`~lsqr_tpu_torch.ops.wcoo.WCOOPackError` or
    :class:`~lsqr_tpu_torch.ops.wwcoo.WWCOOPackError`)."""
    opts = _options(options, option_overrides)
    op, b_local = _rwcoo_rows(A, b, mesh, axis_name, device)
    return _run_lsqr(op, b_local, damp, opts, pair=_pair_default(opts.pair))


def _packed_sibling(rows_of, name, A, b, scalars, mesh, axis_name, itnlim, safe_norms, pair,
                    device, **kw):
    op, b_local = rows_of(A, b, mesh, axis_name, device)
    return _run_sibling(name, op, b_local, scalars, itnlim=itnlim, safe_norms=safe_norms,
                        pair=bool(pair), **kw)


def lsmr_sharded_wcoo(A, b, damp=0.0, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                      conlim=0.0, itnlim=None, safe_norms=True, pair=True, device=None):
    """Row-partitioned LSMR on WCOO shards (see :func:`lsqr_sharded_wcoo`)."""
    return _packed_sibling(_wcoo_rows, "lsmr", A, b, dict(damp=damp, atol=atol, btol=btol,
                                                          conlim=conlim),
                           mesh, axis_name, itnlim, safe_norms, pair, device,
                           record_trace=False)


def craig_sharded_wcoo(A, b, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                       itnlim=None, safe_norms=True, pair=True, device=None):
    """Row-partitioned CRAIG on WCOO shards."""
    return _packed_sibling(_wcoo_rows, "craig", A, b, dict(atol=atol, btol=btol), mesh,
                           axis_name, itnlim, safe_norms, pair, device)


def cgls_sharded_wcoo(A, b, damp=0.0, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                      itnlim=None, safe_norms=True, pair=True, device=None):
    """Row-partitioned CGLS on WCOO shards."""
    return _packed_sibling(_wcoo_rows, "cgls", A, b, dict(damp=damp, atol=atol, btol=btol),
                           mesh, axis_name, itnlim, safe_norms, pair, device)


def lsmr_sharded_rwcoo(A, b, damp=0.0, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                       conlim=0.0, itnlim=None, safe_norms=True, pair=True, device=None):
    """Row-partitioned LSMR on RWCOO (wide-n) shards (see
    :func:`lsqr_sharded_rwcoo`)."""
    return _packed_sibling(_rwcoo_rows, "lsmr", A, b, dict(damp=damp, atol=atol, btol=btol,
                                                           conlim=conlim),
                           mesh, axis_name, itnlim, safe_norms, pair, device,
                           record_trace=False)


def craig_sharded_rwcoo(A, b, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                        itnlim=None, safe_norms=True, pair=True, device=None):
    """Row-partitioned CRAIG on RWCOO (wide-n) shards."""
    return _packed_sibling(_rwcoo_rows, "craig", A, b, dict(atol=atol, btol=btol), mesh,
                           axis_name, itnlim, safe_norms, pair, device)


def cgls_sharded_rwcoo(A, b, damp=0.0, *, mesh=None, axis_name="rows", atol=1e-6, btol=1e-6,
                       itnlim=None, safe_norms=True, pair=True, device=None):
    """Row-partitioned CGLS on RWCOO (wide-n) shards."""
    return _packed_sibling(_rwcoo_rows, "cgls", A, b, dict(damp=damp, atol=atol, btol=btol),
                           mesh, axis_name, itnlim, safe_norms, pair, device)


def _packed_blocks(A, b, mesh, mesh_shape, axis_names, device, wide):
    """(this rank's WCOO (or, ``wide``, WWCOO) block, its b, the gather):
    every block planned, this rank's packed once to the shared shape."""
    from ..ops.rwcoo import RWCOOOperator
    from ..ops.wcoo import WCOOOperator, wcoo_pack, wcoo_plan
    from ..ops.wwcoo import WWCOOOperator, wwcoo_pack, wwcoo_plan

    if wide:
        kinds, limit, pack, plan, force, cls = ((RWCOOOperator, WWCOOOperator), 262_144,
                                                wwcoo_pack, wwcoo_plan, _wwcoo_force,
                                                WWCOOOperator)
    else:
        kinds, limit, pack, plan, force, cls = ((WCOOOperator,), 4096, wcoo_pack, wcoo_plan,
                                                _wcoo_force, WCOOOperator)
    coo = _wcoo_triplets(A, kinds, "the 2-D " + ("WWCOO" if wide else "WCOO") + " solver")
    gm, nr, r, gn, nc, c = _grid(mesh, mesh_shape, axis_names)
    dev = _rank_device(device)
    m_pad, n_pad, rpd, cpd, starts, ends, trip = _blocks(coo, nr, nc)
    if cpd > limit:
        raise ValueError(f"per-device column block is {cpd} > {limit}: use more column "
                         f"shards (ndev_c >= {-(-coo.n // limit)})")
    trip = (trip[0].astype(np.float32, copy=False), trip[1], trip[2])
    blocks = [_block(trip, starts, ends, i, nc, rpd, cpd, True) for i in range(nr * nc)]

    def plan_and_pack():
        kw = force([plan(rpd, cpd, blk[1], blk[2]) for blk in blocks])
        return pack(rpd, cpd, *blocks[r * nc + c], **kw, device=dev)

    packed = _pack_shard(f"block ({r}, {c}) of ({nr}, {nc})", plan_and_pack, (gm, gn), dev)
    op = _BlockShard(local=cls(packed=packed, coo=None), group_m=gm, group_n=gn,
                     global_m=coo.m, global_n=coo.n)
    return (op, _local_b(b, coo.m, r * rpd, rpd, torch.float32, dev),
            _gather(gn, c, cpd, coo.n))


def lsqr_sharded_wcoo_2d(A, b, damp: float = 0.0, *, mesh=None,
                         mesh_shape: Optional[tuple] = None,
                         axis_names: tuple = ("rows", "cols"),
                         options: Optional[LSQROptions] = None, device=None,
                         **option_overrides):
    """LSQR over a 2-D block partition with WCOO block kernels: the scaling
    path for unstructured patterns with n past WCOO's 4096 columns (pick
    ndev_c >= n / 4096 so that every block fits). Vector and collective
    layout as :func:`lsqr_sharded_2d`."""
    opts = _options(options, option_overrides)
    op, b_local, gather = _packed_blocks(A, b, mesh, mesh_shape, axis_names, device, False)
    return _lsqr_2d(op, b_local, gather, damp, opts)


def lsqr_sharded_wwcoo_2d(A, b, damp: float = 0.0, *, mesh=None,
                          mesh_shape: Optional[tuple] = None,
                          axis_names: tuple = ("rows", "cols"),
                          options: Optional[LSQROptions] = None, device=None,
                          **option_overrides):
    """LSQR over a 2-D block partition with WWCOO block kernels, for n up
    to 262,144 * ndev_c. Each block is planned on every rank and packed
    once, by its own rank (the JAX package packs every block twice).
    Vector and collective layout as :func:`lsqr_sharded_2d`."""
    opts = _options(options, option_overrides)
    op, b_local, gather = _packed_blocks(A, b, mesh, mesh_shape, axis_names, device, True)
    return _lsqr_2d(op, b_local, gather, damp, opts)
