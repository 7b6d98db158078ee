"""WCOO: general (unstructured) sparsity with a small n (n <= 4096).

PyTorch counterpart of :mod:`lsqr_tpu.ops.wcoo`. The packer is the JAX
package's, and gives the same arrays byte for byte (the native path through
:func:`lsqr_tpu_torch.native.wcoo_pack_chunks`, or the numpy loop): the rows
in chunks of CR = 16384, each chunk's entries padded to a common ``emax``
(a multiple of 1024) and stored twice, row-sorted (``vals_r``, ``col_r``,
with the row ends ``gpe``) and column-sorted within each 1024-slot subtile
(``vals``, ``idx = col | rowlocal << 12``).

The kernels on the card (:mod:`.spmv_wcoo`, csrc/wcoo.cu) read those five
arrays, and the operator keeps only them. The TPU kernels' window tables
(``ep``, ``ugb``, ``bnb``) come out of :func:`wcoo_pack_arrays`, which gives
JAX's whole packing, and are not kept: no kernel here reads them.

The packer keeps every refusal of JAX's, with its limits: n > 4096, an
empty matrix, the VMEM guard and the window bounds (``_KU_MAX``,
``_KB_MAX``). They bound the TPU's VMEM and windows, not the card, and stay
so that :func:`~lsqr_tpu_torch.ops.interop.auto_operator` routes a pattern
as JAX does (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..config import as_dtype
from .coo import COOOperator, coo_operator
from .linop import LinearOperator, placement, to_numpy
from .spmv_wcoo import CR, wcoo_adjoint, wcoo_forward, wcoo_pair

__all__ = ["WCOOOperator", "WCOOPacked", "WCOOPackError", "wcoo_operator", "wcoo_pack",
           "wcoo_pack_arrays", "wcoo_plan", "ChunkedCOOOperator"]

#: max boundary windows (JAX's S-gather bound)
_KB_MAX = 7
#: max u-gather window rows per subtile (JAX's bound)
_KU_MAX = 16


class WCOOPackError(ValueError):
    """The sparsity pattern violates a WCOO window constraint."""


class ChunkedPacked:
    """What the WCOO and WWCOO packings share: the arrays the kernels read
    (``DEVICE_FIELDS``), all on one device."""

    DEVICE_FIELDS: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device):
        """The packing with its arrays on ``device``."""
        return dataclasses.replace(self, **{f: getattr(self, f).to(device)
                                            for f in self.DEVICE_FIELDS})

    def device_bytes(self) -> int:
        """Bytes of the arrays on the device."""
        return sum(getattr(self, f).numel() * 4 for f in self.DEVICE_FIELDS)


@dataclasses.dataclass(frozen=True, eq=False)
class WCOOPacked(ChunkedPacked):
    """The WCOO layout: the arrays the kernels read, and the statics."""

    vals: torch.Tensor    # (nc, emax) f32, column-sorted within each subtile
    idx: torch.Tensor     # (nc, emax) int32: col | rowlocal << 12 (same order)
    vals_r: torch.Tensor  # (nc, emax) f32, row-sorted
    col_r: torch.Tensor   # (nc, emax) int32, columns in row-sorted order
    gpe: torch.Tensor     # (nc, CR) int32: last slot of rows <= r (-1 none)
    m: int
    n: int
    m_pad: int
    nc: int
    eb: int
    xs: int
    kb: int = 1
    ku: int = 8

    DEVICE_FIELDS = ("vals", "idx", "vals_r", "col_r", "gpe")


def packed_from_arrays(arrays, meta, device) -> WCOOPacked:
    """A :class:`WCOOPacked` over the arrays (numpy) and static fields of a
    WCOO packing, JAX's or :func:`wcoo_pack_arrays`'s, on ``device``."""
    fields = {f: torch.from_numpy(np.array(arrays[f], order="C", copy=True))
              for f in WCOOPacked.DEVICE_FIELDS}
    statics = {k: int(meta[k]) for k in ("m", "n", "m_pad", "nc", "eb", "xs", "kb", "ku")}
    return WCOOPacked(**fields, **statics).to(device)


def _vmem_guard(eb, npad):
    """JAX's refusal of packs whose per-chunk TPU blocks would exceed the
    ~16 MiB scoped VMEM (kept for routing parity)."""
    demand = eb * (158_000 + 8 * npad)
    if demand > 15 * (1 << 20):
        raise WCOOPackError(
            f"chunk density too high: {eb} entry subtiles at n_pad "
            f"{npad} would need ~{demand / (1 << 20):.0f} MiB of VMEM "
            f"(> ~16 MiB scoped limit); use more rows per entry or a "
            f"blocked/COO format"
        )


def row_ends(rowl, k, emax, t, error):
    """JAX's row ends of chunk t, whose k real entries lie in ``rowl`` (row
    within the chunk, row-sorted, padded to emax with the last row): gpe
    (the last slot of rows <= r, -1 before the first, capped at the last
    real entry so the padding belongs to no row), the S-window base of each
    128 rows (bnb) and the windows they need, at most ``_KB_MAX`` (else
    ``error``, the packer's refusal)."""
    cnt = np.bincount(rowl, minlength=CR)
    g = np.minimum(np.cumsum(cnt) - 1, k - 1)
    G2 = g.reshape(CR // 128, 128)
    last = G2[:, -1]
    first = np.where(G2 >= 0, G2, np.int64(1) << 60).min(axis=1)
    first = np.where(first == (np.int64(1) << 60), np.maximum(last, 0), first)
    span = last - first
    need = np.maximum(1, -(-(span + 128) // 1024))
    if need.max() > _KB_MAX:
        j = int(need.argmax())
        raise error(
            f"entry span {int(span[j])} under 128 rows exceeds "
            f"{_KB_MAX} 1024-entry S-windows (chunk {t}, "
            f"rows {j * 128}..)"
        )
    base = np.maximum(0, last - (need * 1024 - 1))
    base = -(-base // 128) * 128
    return g, np.minimum(base, max(0, emax - 1024)), int(need.max())


def _pack_numpy(rows, cols, vals, nc, emax, npad):
    """JAX's numpy loop over chunks: the arrays, kb_req and ku_req."""
    eb = emax // 1024
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    chunk_of = rows // CR
    cstart = np.searchsorted(chunk_of, np.arange(nc))
    cend = np.searchsorted(chunk_of, np.arange(nc), side="right")

    vals_p = np.zeros((nc, emax), np.float32)
    col_p = np.zeros((nc, emax), np.int32)
    rowl_p = np.zeros((nc, emax), np.int32)
    vals_r = np.zeros((nc, emax), np.float32)
    col_r = np.zeros((nc, emax), np.int32)
    ep_p = np.zeros((nc, eb * npad), np.int32)
    gpe = np.zeros((nc, CR), np.int32)
    ugb = np.zeros((nc, 1, eb), np.int32)
    bnb = np.zeros((nc, 1, CR // 128), np.int32)
    kb_req = 1
    ku_req = 1

    for t in range(nc):
        st, e = int(cstart[t]), int(cend[t])
        k = e - st
        vals_p[t, :k] = vals[st:e]
        col_p[t, :k] = cols[st:e]
        rl = (rows[st:e] - t * CR).astype(np.int32)
        rowl_p[t, :k] = rl
        # zero-valued padding sits on the last real row
        if k and k < emax:
            rowl_p[t, k:] = rl[-1]

        # u-gather window bases
        R2 = rowl_p[t].reshape(eb, 1024)
        rmin = R2[:, 0].astype(np.int64)
        rmax = R2[:, -1].astype(np.int64)
        base_u = rmin & ~127
        need_u = (-(-(rmax - base_u + 1) // 128)).astype(np.int64)
        if need_u.max() > _KU_MAX:
            i = int(need_u.argmax())
            raise WCOOPackError(
                f"row span {int(rmax[i] - rmin[i])} in one entry subtile "
                f"exceeds {_KU_MAX} 128-row u-window slices "
                f"(chunk {t}, subtile {i})"
            )
        ugb[t, 0, :] = base_u.astype(np.int32)
        ku_req = max(ku_req, int(need_u.max()))

        # within-subtile column sort
        C2 = col_p[t].reshape(eb, 1024)
        V2 = vals_p[t].reshape(eb, 1024)
        vals_r[t] = vals_p[t]
        col_r[t] = col_p[t]
        oc = np.argsort(C2, axis=1, kind="stable")
        C2s = np.take_along_axis(C2, oc, axis=1)
        col_p[t] = C2s.reshape(-1)
        vals_p[t] = np.take_along_axis(V2, oc, axis=1).reshape(-1)
        rowl_p[t] = np.take_along_axis(R2, oc, axis=1).reshape(-1)

        # per-subtile column boundary tables
        flat = (np.arange(eb)[:, None] * npad + C2s).reshape(-1)
        hist = np.bincount(flat, minlength=eb * npad).reshape(eb, npad)
        ep_p[t] = (np.cumsum(hist, axis=1) - 1).reshape(-1)

        gpe[t], bnb[t, 0, :], need = row_ends(rowl_p[t], k, emax, t, WCOOPackError)
        kb_req = max(kb_req, need)

    return dict(vals_p=vals_p, col_p=col_p, rowl_p=rowl_p, vals_r=vals_r, col_r=col_r,
                ep=ep_p, gpe=gpe, ugb=ugb, bnb=bnb, kb_req=kb_req,
                ku_req=ku_req)


def wcoo_pack_arrays(m, n, vals, rows, cols, *, force_emax=None, force_kb=None,
                     force_ku=None):
    """JAX's WCOO packing of (unsorted) COO triplets, byte for byte: (arrays,
    statics), the arrays numpy and named as the fields of JAX's
    ``WCOOPacked`` (the TPU window tables ``ep``, ``ugb`` and ``bnb``
    included).

    ``force_emax``/``force_kb``/``force_ku`` pin the padded entry capacity
    and the window counts (JAX's knobs for shards that share one shape);
    packing fails if the data needs more. Raises :class:`WCOOPackError`
    when n > 4096 or a window constraint fails."""
    from .. import native

    if n > 4096:
        raise WCOOPackError(f"WCOO requires n <= 4096, got {n}")
    vals = to_numpy(vals).astype(np.float32, copy=False)
    rows = to_numpy(rows).astype(np.int64, copy=False)
    cols = to_numpy(cols).astype(np.int64, copy=False)
    if vals.size == 0:
        raise WCOOPackError("empty matrix")

    nc = max(1, -(-m // CR))
    m_pad = nc * CR
    xs = max(1, -(-n // 128))
    npad = xs * 128
    counts0 = np.bincount(rows // CR, minlength=nc)
    emax = int(-(-max(1, int(counts0.max())) // 1024) * 1024)
    if force_emax is not None:
        if emax > force_emax:
            raise WCOOPackError(f"chunk needs {emax} entry slots > forced {force_emax}")
        emax = int(force_emax)
    eb = emax // 1024
    _vmem_guard(eb, npad)

    try:
        p = native.wcoo_pack_chunks(rows, cols, vals, nc, emax, npad, CR, _KU_MAX, _KB_MAX)
    except ValueError as e:
        raise WCOOPackError(str(e)) from None
    if p is None:
        p = _pack_numpy(rows, cols, vals, nc, emax, npad)
    arrays = dict(vals=p["vals_p"], idx=p["col_p"] | (p["rowl_p"] << 12), vals_r=p["vals_r"],
                  col_r=p["col_r"], gpe=p["gpe"], ep=p["ep"], ugb=p["ugb"], bnb=p["bnb"])
    meta = dict(m=m, n=n, m_pad=m_pad, nc=nc, eb=eb, xs=xs,
                kb=min(max(p["kb_req"], force_kb or 1), eb),
                ku=max(p["ku_req"], force_ku or 1))
    return arrays, meta


def wcoo_pack(m, n, vals, rows, cols, *, force_emax=None, force_kb=None, force_ku=None,
              device=None) -> WCOOPacked:
    """The WCOO layout of (unsorted) COO triplets (:func:`wcoo_pack_arrays`,
    with its knobs and refusals), the kernels' arrays on ``device`` (when
    None: the device of a tensor ``vals``, else the card)."""
    device = placement(vals, device)
    with tracing.span("build.pack"):
        arrays, meta = wcoo_pack_arrays(m, n, vals, rows, cols, force_emax=force_emax,
                                        force_kb=force_kb, force_ku=force_ku)
    with tracing.span("build.upload"):
        return packed_from_arrays(arrays, meta, device)


def wcoo_plan(m, n, rows, cols) -> dict:
    """The statics :func:`wcoo_pack_arrays` gives these (unsorted) triplets
    without forcing, found without building the packing: ``emax``, ``kb``
    and ``ku``. Their maxima over the shards of a sharded solve are the
    ``force_*`` values under which every shard packs once to one shape.
    Raises the packer's window refusals (``_KU_MAX``, ``_KB_MAX``)."""
    rows = to_numpy(rows).astype(np.int64, copy=False)
    order = np.argsort(rows, kind="stable")  # only the rows' order matters here
    rows = rows[order]
    nc = max(1, -(-m // CR))
    chunk_of = rows // CR
    cstart = np.searchsorted(chunk_of, np.arange(nc))
    cend = np.searchsorted(chunk_of, np.arange(nc), side="right")
    emax = int(-(-max(1, int((cend - cstart).max())) // 1024) * 1024)
    eb = emax // 1024
    kb_req = ku_req = 1
    for t in range(nc):
        st, e = int(cstart[t]), int(cend[t])
        k = e - st
        rowl = np.zeros(emax, np.int64)
        rowl[:k] = rows[st:e] - t * CR
        if k and k < emax:  # the packing's padding: the last row
            rowl[k:] = rowl[k - 1]
        R2 = rowl.reshape(eb, 1024)
        base_u = R2[:, 0] & ~127
        need_u = -(-(R2[:, -1] - base_u + 1) // 128)
        if need_u.max() > _KU_MAX:
            i = int(need_u.argmax())
            raise WCOOPackError(
                f"row span {int(R2[i, -1] - R2[i, 0])} in one entry subtile exceeds "
                f"{_KU_MAX} 128-row u-window slices (chunk {t}, subtile {i})")
        ku_req = max(ku_req, int(need_u.max()))
        kb_req = max(kb_req, row_ends(rowl, k, emax, t, WCOOPackError)[2])
    return dict(emax=emax, kb=min(kb_req, eb), ku=ku_req)


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkedCOOOperator(LinearOperator):
    """General-sparsity m x n operator (f32) on a chunked-COO packing, whose
    products are the packing's three kernel wrappers (``KERNELS``: forward,
    adjoint, pair). On CUDA they launch the kernels; on the CPU they run
    their twins. ``coo`` holds the triplets (for ``todense`` and ``nnz``),
    as in JAX. ``prefers_pair`` is true where the kernels run, as JAX's is
    true on the TPU, so a solve on the CPU takes the separate products as
    JAX's CPU solve does."""

    packed: ChunkedPacked
    coo: COOOperator

    KERNELS = ()

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.packed.m

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.packed.n

    @property
    def dtype(self):
        return torch.float32

    @property
    def device(self):
        return self.packed.device

    @property
    def nnz(self) -> int:
        return self.coo.nnz

    @property
    def prefers_pair(self) -> bool:
        return self.packed.vals.is_cuda

    def matvec(self, x):
        x = x.to(torch.float32)
        return self.KERNELS[0](self.packed, x, 1.0, 0.0, x.new_zeros(0))

    def rmatvec(self, y):
        return self.KERNELS[1](self.packed, y.to(torch.float32))

    def fused_pair(self, *, y, win, c1, c2):
        """u = A(win*c1) - c2*y and z = A' u; returns (u, z), z unnormalized."""
        return self.KERNELS[2](self.packed, y.to(torch.float32), win.to(torch.float32), c1, c2)

    def todense(self):
        return self.coo.todense()


class WCOOOperator(ChunkedCOOOperator):
    """The chunked-COO operator on the WCOO layout (n <= 4096)."""

    KERNELS = (wcoo_forward, wcoo_adjoint, wcoo_pair)


@tracing.builder("wcoo_operator")
def wcoo_operator(m, n, vals, rows, cols, *, dtype=None, device=None) -> WCOOOperator:
    """Build a :class:`WCOOOperator` from COO triplets (real f32,
    n <= 4096), packed on the host and moved to ``device`` once (when None:
    the device of a tensor ``vals``, else the card). Raises
    :class:`WCOOPackError` for patterns outside WCOO's window constraints,
    for complex values and for dtype float64."""
    device = placement(vals, device)
    vals = to_numpy(vals)
    if np.iscomplexobj(vals):
        raise WCOOPackError("WCOO is real-only")
    if dtype is not None and as_dtype(dtype) == torch.float64:
        raise WCOOPackError("WCOO computes in f32; use the COO path for f64")
    packed = wcoo_pack(m, n, vals, rows, cols, device=device)
    coo = coo_operator(m, n, vals.astype(np.float32), to_numpy(rows), to_numpy(cols),
                       dtype=torch.float32, device=device)
    return WCOOOperator(packed=packed, coo=coo)
