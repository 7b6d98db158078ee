"""WWCOO: general (unstructured) sparsity with a wide n (n <= 262,144).

PyTorch counterpart of :mod:`lsqr_tpu.ops.wwcoo`. The packer is the JAX
package's numpy loop and gives the same arrays byte for byte: WCOO's chunks
of CR = 16384 rows and two copies of the entries, with each chunk's columns
compacted (``col_r`` holds a position in the chunk's sorted column list
``colmap``, padded with the out-of-range n_pad).

The kernels on the card (:mod:`.spmv_wcoo`, csrc/wwcoo.cu) read ``vals_r``,
``col_r``, ``gpe``, ``colmap``, ``vals`` and three arrays JAX does not
store: ``cidx = colc | rowl << 18`` (unsigned, in the column-sorted order),
colc the slot's compacted column, which the TPU kernel recovered from its
emission tables ep (:func:`column_index` derives it from ``col_r`` and
``rowl``); and the inverse of ``colmap``, ``zptr``/``zsrc``, the (chunk,
position) of each column in chunk order, through which the adjoint expands
each chunk's compacted z into z as the TPU kernel did through its ``zexp``
tables (:func:`column_lists` derives it from ``colmap``). The operator keeps
only those eight arrays; the TPU kernels' tables (``rowl``, ``ep``,
``zexp``, ``bnb`` and the eleven work lists) come out of
:func:`wwcoo_pack_arrays`, which gives JAX's whole packing.

The packer keeps JAX's refusals with their limits: n > 262,144, an empty
matrix, the window bound ``_KB_MAX``, the work-list cap ``_W_MAX`` and the
VMEM-demand guard. They bound the TPU, not the card, and stay so that
:func:`~lsqr_tpu_torch.ops.interop.auto_operator` routes as JAX does
(ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import as_dtype
from .coo import coo_operator
from .linop import placement, to_numpy
from .spmv_wcoo import CR, SHIFT, wwcoo_adjoint, wwcoo_forward, wwcoo_pair
from .wcoo import ChunkedCOOOperator, ChunkedPacked, row_ends

__all__ = ["WWCOOOperator", "WWCOOPacked", "WWCOOPackError", "wwcoo_operator",
           "wwcoo_pack", "wwcoo_pack_arrays", "wwcoo_plan", "column_index", "column_lists"]

#: widest n (JAX's VMEM-resident x and z blocks)
_N_MAX = 262_144
#: cap on each per-chunk work list
_W_MAX = 1024
_STATICS = ("m", "n", "m_pad", "nc", "eb", "xs", "js", "kb", "wc", "wf", "wu", "wm", "wz")


class WWCOOPackError(ValueError):
    """The sparsity pattern violates a WWCOO window constraint."""


@dataclasses.dataclass(frozen=True, eq=False)
class WWCOOPacked(ChunkedPacked):
    """The WWCOO layout: the arrays the kernels read, and the statics."""

    vals: torch.Tensor    # (nc, emax) f32, column-sorted within each subtile
    cidx: torch.Tensor    # (nc, emax) int32 bits of colc | rowl << 18 (same order)
    vals_r: torch.Tensor  # (nc, emax) f32, row-sorted
    col_r: torch.Tensor   # (nc, emax) int32 compacted columns, row-sorted
    colmap: torch.Tensor  # (nc, D_pad) int32 sorted distinct columns (pad n_pad)
    gpe: torch.Tensor     # (nc, CR) int32: last slot of rows <= r (-1 none)
    zptr: torch.Tensor    # (n + 1,) int32: column c's entries of zsrc
    zsrc: torch.Tensor    # (pairs,) int32: t * D_pad + pos of column c, t ascending
    m: int
    n: int
    m_pad: int
    nc: int
    eb: int
    xs: int
    js: int = 8
    kb: int = 1
    wc: int = 1
    wf: int = 1
    wu: int = 1
    wm: int = 1
    wz: int = 1

    DEVICE_FIELDS = ("vals", "cidx", "vals_r", "col_r", "colmap", "gpe", "zptr", "zsrc")
    #: the device arrays the port derives (JAX's packing has none of them)
    DERIVED = ("cidx", "zptr", "zsrc")


def column_index(col_r, rowl, eb):
    """The kernels' column-sorted index plane, int32 bits of the unsigned
    ``colc | rowl << 18``: colc is each subtile's col_r sorted, which is the
    column order of the column-sorted copy (numpy arrays (nc, emax))."""
    nc = col_r.shape[0]
    colc = np.sort(col_r.reshape(nc, eb, 1024), axis=-1).reshape(nc, -1)
    code = colc.astype(np.uint32) | (rowl.astype(np.uint32) << np.uint32(SHIFT[True]))
    return code.view(np.int32)


def column_lists(colmap, n):
    """The inverse of the chunks' column lists ``colmap`` (numpy (nc, D_pad),
    padded with n_pad >= n): (zptr (n + 1,), zsrc), where
    zsrc[zptr[c]:zptr[c + 1]] holds t * D_pad + pos for each chunk t whose
    colmap has column c at position pos, t ascending. It says what JAX's
    zexp tables say (position zexp[t, .., c % 1024] of column c in chunk t,
    -1 where chunk t lacks it), as one list per column. Both int32, as the
    kernel reads them, unless a value passes 2^31 - 1 (a packing too large
    for one card: its colmap alone would hold 8 GiB)."""
    nc, d_pad = colmap.shape
    t, pos = np.nonzero(colmap < n)  # chunk-major: t ascending
    cols = colmap[t, pos].astype(np.int64)
    order = np.argsort(cols, kind="stable")
    zptr = np.zeros(n + 1, np.int64)
    zptr[1:] = np.cumsum(np.bincount(cols, minlength=n))
    zsrc = (t.astype(np.int64) * d_pad + pos)[order]
    narrow = nc * d_pad < 1 << 31
    return (zptr.astype(np.int32) if narrow else zptr), (zsrc.astype(np.int32) if narrow
                                                         else zsrc)


def packed_from_arrays(arrays, meta, device) -> WWCOOPacked:
    """A :class:`WWCOOPacked` over the arrays (numpy) and static fields of a
    WWCOO packing, JAX's or :func:`wwcoo_pack_arrays`'s, on ``device``: its
    device arrays, ``cidx`` derived from ``col_r`` and ``rowl``, and
    ``zptr``/``zsrc`` from ``colmap``."""
    def t(a):
        return torch.from_numpy(np.array(a, order="C", copy=True))

    fields = {f: t(arrays[f]) for f in WWCOOPacked.DEVICE_FIELDS
              if f not in WWCOOPacked.DERIVED}
    fields["cidx"] = t(column_index(np.asarray(arrays["col_r"]), np.asarray(arrays["rowl"]),
                                    int(meta["eb"])))
    fields["zptr"], fields["zsrc"] = map(t, column_lists(np.asarray(arrays["colmap"]),
                                                         int(meta["n"])))
    return WWCOOPacked(**fields, **{k: int(meta[k]) for k in _STATICS}).to(device)


def _value_windows(lo, hi):
    """128-aligned 1024-wide window bases covering [lo, hi] per row of the
    (sorted) bounds arrays."""
    base0 = lo & ~np.int64(127)
    k = (-(-(hi - base0 + 1) // 1024)).astype(np.int64)
    return base0, k


def wwcoo_pack_arrays(m, n, vals, rows, cols, *, force_emax=None, force_kb=None,
                      force_js=None, force_w=None):
    """JAX's WWCOO packing of (unsorted) COO triplets (its numpy loop), byte
    for byte: (arrays, statics), the arrays numpy and named as the fields of
    JAX's ``WWCOOPacked`` (the TPU tables and work lists included). Raises
    :class:`WWCOOPackError` when n > 262,144 or a window constraint fails.

    The ``force_*`` knobs are JAX's: they pin the padded entry capacity
    (``force_emax``), the S-window count (``force_kb``), the column-map rows
    (``force_js``) and all five work-list lengths (``force_w``), so that the
    shards of a sharded solve share one shape; packing fails if the data
    needs more (:func:`wwcoo_plan` gives what it needs)."""
    if n > _N_MAX:
        raise WWCOOPackError(f"WWCOO requires n <= {_N_MAX}, got {n}")
    vals = to_numpy(vals).astype(np.float32, copy=False)
    rows = to_numpy(rows).astype(np.int64, copy=False)
    cols = to_numpy(cols).astype(np.int64, copy=False)
    if vals.size == 0:
        raise WWCOOPackError("empty matrix")
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    nc = max(1, -(-m // CR))
    m_pad = nc * CR
    n_pad = max(1024, -(-n // 1024) * 1024)
    xs = n_pad // 128
    chunk_of = rows // CR
    cstart = np.searchsorted(chunk_of, np.arange(nc))
    cend = np.searchsorted(chunk_of, np.arange(nc), side="right")
    counts = cend - cstart
    emax = int(-(-max(1, counts.max()) // 1024) * 1024)
    if force_emax is not None:
        if emax > force_emax:
            raise WWCOOPackError(f"chunk needs {emax} entry slots > forced {force_emax}")
        emax = int(force_emax)
    eb = emax // 1024

    vals_r_p = np.zeros((nc, emax), np.float32)
    col_r_p = np.zeros((nc, emax), np.int32)
    vals_c_p = np.zeros((nc, emax), np.float32)
    rowl_c_p = np.zeros((nc, emax), np.int32)
    gpe = np.zeros((nc, CR), np.int32)
    bnb = np.zeros((nc, 1, CR // 128), np.int32)
    kb_req = 1

    colmaps = []
    cwk, fwk, uwk, ewk, zwk = [], [], [], [], []
    ep_tabs, zexp_tabs = [], []

    for t in range(nc):
        st, e = int(cstart[t]), int(cend[t])
        k = e - st
        rl = (rows[st:e] - t * CR).astype(np.int32)
        cl = cols[st:e]
        # column compaction map of this chunk
        cmap = np.unique(cl) if k else np.zeros(1, np.int64)
        D = len(cmap)
        cj = np.searchsorted(cmap, cl).astype(np.int32)
        colmaps.append(cmap)

        rowl = np.zeros(emax, np.int32)
        colp = np.zeros(emax, np.int32)
        rowl[:k] = rl
        colp[:k] = cj
        vals_r_p[t, :k] = vals[st:e]
        # zero-valued padding sits on the last real (row, col)
        if k and k < emax:
            rowl[k:] = rl[-1]
            colp[k:] = cj[-1]
        col_r_p[t] = colp

        # u-gather work items: one per spanned 128-row u slice
        R2 = rowl.reshape(eb, 1024)
        rmin = R2[:, 0].astype(np.int64)
        rmax = R2[:, -1].astype(np.int64)
        base_u = rmin & ~127
        need_u = (-(-(rmax - base_u + 1) // 128)).astype(np.int64)
        items = []
        for i in range(eb):
            for j in range(int(need_u[i])):
                items.append((i, int(base_u[i]) + 128 * j))
        uwk.append(np.asarray(items, np.int64).reshape(-1, 2))

        # within-subtile sort by compacted column (the adjoint copy)
        C2 = colp.reshape(eb, 1024)
        V2 = vals_r_p[t].reshape(eb, 1024)
        oc = np.argsort(C2, axis=1, kind="stable")
        C2s = np.take_along_axis(C2, oc, axis=1)
        vals_c_p[t] = np.take_along_axis(V2, oc, axis=1).reshape(-1)
        rowl_c_p[t] = np.take_along_axis(rowl.reshape(eb, 1024), oc, axis=1).reshape(-1)

        # compaction work items: xc[j] = x[colmap[j]]
        items = []
        for jb in range(0, max(D, 1), 1024):
            seg = cmap[jb:jb + 1024]
            b0, kx = _value_windows(seg[0], seg[-1])
            for j in range(int(kx)):
                items.append((jb, min(int(b0) + 1024 * j, n_pad - 1024)))
        cwk.append(np.asarray(items, np.int64).reshape(-1, 2))

        # forward entry-gather items: (subtile, xc window)
        cmin = C2s[:, 0].astype(np.int64)
        cmax = C2s[:, -1].astype(np.int64)
        items = []
        b0, kx = _value_windows(cmin, cmax)
        for i in range(eb):
            for j in range(int(kx[i])):
                items.append((i, int(b0[i]) + 1024 * j))
        fwk.append(np.asarray(items, np.int64).reshape(-1, 2))

        # emission items: (subtile, zc slab) and boundary tables
        zbase = (cmin >> 10) << 10
        kz = (-(-(cmax - zbase + 1) // 1024)).astype(np.int64)
        items, tabs = [], []
        for i in range(eb):
            row = C2s[i]
            for j in range(int(kz[i])):
                jb = int(zbase[i]) + j * 1024
                table = (np.searchsorted(row, np.arange(jb, jb + 1024), side="right") - 1
                         ).astype(np.int32)
                items.append((i, jb, 1 if j == 0 else 0))
                tabs.append(table.reshape(8, 128))
        ewk.append(np.asarray(items, np.int64).reshape(-1, 3))
        ep_tabs.append(np.stack(tabs) if tabs else np.zeros((0, 8, 128), np.int32))

        # expansion items: (z slab, zc slab) and position tables
        items, tabs = [], []
        occ = np.unique(cmap >> 10) if k else np.zeros(0, np.int64)
        for zw in occ:
            zb = int(zw) << 10
            jlo = int(np.searchsorted(cmap, zb))
            jhi = max(int(np.searchsorted(cmap, zb + 1024)) - 1, jlo)
            table = np.searchsorted(cmap, np.arange(zb, zb + 1024)).astype(np.int64)
            hit = (table < D) & (cmap[np.minimum(table, D - 1)] == np.arange(zb, zb + 1024))
            table = np.where(hit, table, -1).astype(np.int32)
            for q in range(jlo >> 10, (jhi >> 10) + 1):
                items.append((zb, q * 1024))
                tabs.append(table.reshape(8, 128))
        zwk.append(np.asarray(items, np.int64).reshape(-1, 2))
        zexp_tabs.append(np.stack(tabs) if tabs else np.zeros((0, 8, 128), np.int32))

        gpe[t], bnb[t, 0, :], need = row_ends(rowl, k, emax, t, WWCOOPackError)
        kb_req = max(kb_req, need)

    # pad the ragged structures to common statics
    d_pad = max(1024, -(-max(len(c) for c in colmaps) // 1024) * 1024)
    if force_js is not None:
        if d_pad // 128 > force_js:
            raise WWCOOPackError(f"chunk needs {d_pad // 128} colmap rows > forced {force_js}")
        d_pad = int(force_js) * 128
    js = d_pad // 128
    wc = max(1, max(len(a) for a in cwk))
    wf = max(1, max(len(a) for a in fwk))
    wu = max(1, max(len(a) for a in uwk))
    wm = max(1, max(len(a) for a in ewk))
    wz = max(1, max(len(a) for a in zwk))
    if max(wc, wf, wu, wm, wz) > _W_MAX:
        raise WWCOOPackError(
            f"chunk needs {max(wc, wf, wu, wm, wz)} work items > "
            f"{_W_MAX} — row/column spread too wide for the WWCOO "
            f"window budget")
    if force_w is not None:
        if max(wc, wf, wu, wm, wz) > force_w:
            raise WWCOOPackError(
                f"chunk needs {max(wc, wf, wu, wm, wz)} work items > forced {force_w}")
        wc = wf = wu = wm = wz = int(force_w)

    # JAX's VMEM-demand guard (kept for routing parity)
    demand = eb * 36_864 + (wm + wz) * 8_192 + (xs + js) * 2_048
    if demand > 14 * (1 << 20):
        raise WWCOOPackError(
            f"chunk density too high: ~{demand / (1 << 20):.0f} MiB of "
            f"VMEM blocks (eb={eb}, wm={wm}, wz={wz}, n_pad={xs * 128}, "
            f"D_pad={js * 128}) exceeds the ~16 MiB scoped limit"
        )

    colmap_p = np.full((nc, d_pad), n_pad, np.int32)
    lists = dict(
        cwk_jb=np.zeros((nc, wc), np.int32), cwk_xb=np.full((nc, wc), n_pad - 1024, np.int32),
        fwk_sub=np.zeros((nc, wf), np.int32), fwk_jb=np.full((nc, wf), d_pad - 1024, np.int32),
        uwk_sub=np.zeros((nc, wu), np.int32), uwk_ub=np.zeros((nc, wu), np.int32),
        ewk_sub=np.zeros((nc, wm), np.int32), ewk_jb=np.zeros((nc, wm), np.int32),
        ewk_first=np.ones((nc, wm), np.int32),
        zwk_zb=np.zeros((nc, wz), np.int32), zwk_jb=np.zeros((nc, wz), np.int32))
    ep = np.full((nc, wm * 8, 128), -1, np.int32)
    zexp = np.full((nc, wz * 8, 128), -1, np.int32)
    for t in range(nc):
        colmap_p[t, :len(colmaps[t])] = colmaps[t]
        a = cwk[t]
        lists["cwk_jb"][t, :len(a)] = a[:, 0]
        lists["cwk_xb"][t, :len(a)] = a[:, 1]
        a = fwk[t]
        lists["fwk_sub"][t, :len(a)] = a[:, 0]
        lists["fwk_jb"][t, :len(a)] = np.minimum(a[:, 1], d_pad - 1024)
        a = uwk[t]
        lists["uwk_sub"][t, :len(a)] = a[:, 0]
        lists["uwk_ub"][t, :len(a)] = a[:, 1]
        a = ewk[t]
        lists["ewk_sub"][t, :len(a)] = a[:, 0]
        lists["ewk_jb"][t, :len(a)] = np.minimum(a[:, 1], d_pad - 1024)
        lists["ewk_first"][t, :len(a)] = a[:, 2]
        if len(a):
            ep[t, :len(a) * 8, :] = ep_tabs[t].reshape(-1, 128)
        a = zwk[t]
        lists["zwk_zb"][t, :len(a)] = a[:, 0]
        lists["zwk_jb"][t, :len(a)] = np.minimum(a[:, 1], d_pad - 1024)
        if len(a):
            zexp[t, :len(a) * 8, :] = zexp_tabs[t].reshape(-1, 128)

    arrays = dict(vals=vals_c_p, rowl=rowl_c_p, vals_r=vals_r_p, col_r=col_r_p,
                  colmap=colmap_p, ep=ep, zexp=zexp, gpe=gpe, bnb=bnb, **lists)
    meta = dict(m=m, n=n, m_pad=m_pad, nc=nc, eb=eb, xs=xs, js=js,
                kb=min(max(kb_req, force_kb or 1), eb),
                wc=wc, wf=wf, wu=wu, wm=wm, wz=wz)
    return arrays, meta


def wwcoo_pack(m, n, vals, rows, cols, *, force_emax=None, force_kb=None, force_js=None,
               force_w=None, device=None) -> WWCOOPacked:
    """The WWCOO layout of (unsorted) COO triplets (:func:`wwcoo_pack_arrays`,
    with its knobs and refusals), the kernels' arrays on ``device`` (when
    None: the device of a tensor ``vals``, else the card)."""
    device = placement(vals, device)
    return packed_from_arrays(*wwcoo_pack_arrays(
        m, n, vals, rows, cols, force_emax=force_emax, force_kb=force_kb,
        force_js=force_js, force_w=force_w), device)


def wwcoo_plan(m, n, rows, cols) -> dict:
    """The statics :func:`wwcoo_pack_arrays` gives these (unsorted) triplets
    without forcing, found without building the packing: ``emax``, ``kb``,
    ``js`` and ``w``, the longest of the five work lists. Their maxima over
    the shards of a sharded solve are the ``force_*`` values under which
    every shard packs once to one shape. Raises the packer's window
    refusal (``_KB_MAX``); the work-list cap and the VMEM guard are the
    packing's to raise."""
    rows = to_numpy(rows).astype(np.int64, copy=False)
    cols = to_numpy(cols).astype(np.int64, copy=False)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    nc = max(1, -(-m // CR))
    chunk_of = rows // CR
    cstart = np.searchsorted(chunk_of, np.arange(nc))
    cend = np.searchsorted(chunk_of, np.arange(nc), side="right")
    emax = int(-(-max(1, int((cend - cstart).max())) // 1024) * 1024)
    eb = emax // 1024
    kb_req, d_max, w = 1, 1, 1
    for t in range(nc):
        st, e = int(cstart[t]), int(cend[t])
        k = e - st
        cmap = np.unique(cols[st:e]) if k else np.zeros(1, np.int64)
        d_max = max(d_max, len(cmap))
        rowl = np.zeros(emax, np.int64)
        colp = np.zeros(emax, np.int64)
        rowl[:k] = rows[st:e] - t * CR
        colp[:k] = np.searchsorted(cmap, cols[st:e])
        if k and k < emax:  # the packing's padding: the last (row, col)
            rowl[k:], colp[k:] = rowl[k - 1], colp[k - 1]
        R2, C2 = rowl.reshape(eb, 1024), colp.reshape(eb, 1024)
        base_u = R2[:, 0] & ~127
        wu = int((-(-(R2[:, -1] - base_u + 1) // 128)).sum())
        jb = np.arange(0, len(cmap), 1024)
        wc = int(_value_windows(cmap[jb], cmap[np.minimum(jb + 1023, len(cmap) - 1)])[1].sum())
        cmin, cmax = C2.min(axis=1), C2.max(axis=1)
        wf = int(_value_windows(cmin, cmax)[1].sum())
        zbase = (cmin >> 10) << 10
        wm = int((-(-(cmax - zbase + 1) // 1024)).sum())
        wz = 0
        if k:
            zb = np.unique(cmap >> 10) << 10
            jlo = np.searchsorted(cmap, zb)
            jhi = np.maximum(np.searchsorted(cmap, zb + 1024) - 1, jlo)
            wz = int(((jhi >> 10) - (jlo >> 10) + 1).sum())
        w = max(w, wc, wf, wu, wm, wz)
        kb_req = max(kb_req, row_ends(rowl, k, emax, t, WWCOOPackError)[2])
    return dict(emax=emax, kb=min(kb_req, eb), js=max(1024, -(-d_max // 1024) * 1024) // 128,
                w=w)


class WWCOOOperator(ChunkedCOOOperator):
    """The chunked-COO operator on the WWCOO layout (n <= 262,144)."""

    KERNELS = (wwcoo_forward, wwcoo_adjoint, wwcoo_pair)


def wwcoo_operator(m, n, vals, rows, cols, *, dtype=None, device=None) -> WWCOOOperator:
    """Build a :class:`WWCOOOperator` from COO triplets (real f32,
    n <= 262,144), packed on the host and moved to ``device`` once (when
    None: the device of a tensor ``vals``, else the card). Raises
    :class:`WWCOOPackError` for patterns outside the window constraints, for
    complex values and for dtype float64."""
    device = placement(vals, device)
    vals = to_numpy(vals)
    if np.iscomplexobj(vals):
        raise WWCOOPackError("WWCOO is real-only")
    if dtype is not None and as_dtype(dtype) == torch.float64:
        raise WWCOOPackError("WWCOO computes in f32; use COO for f64")
    packed = wwcoo_pack(m, n, vals, rows, cols, device=device)
    coo = coo_operator(m, n, vals.astype(np.float32), to_numpy(rows), to_numpy(cols),
                       dtype=torch.float32, device=device)
    return WWCOOOperator(packed=packed, coo=coo)
