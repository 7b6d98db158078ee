"""JDIA — jittered-diagonal storage for general sparsity with locality.

PyTorch counterpart of :mod:`lsqr_tpu.ops.jdia`. An entry A[i, c] sits in
one of up to ``ns`` slots of its row tile (``tm`` rows): a slot is a
tile-local diagonal ``d`` and a per-row jitter ``e`` (int8, |e| <= 32), so

    c = i + d[slot, tile] + e[slot, i]

Entries that fit no slot in both orientations spill into a COO remainder,
applied with ``index_add_`` as in :mod:`.coo`. The transpose packing makes
the adjoint the same streaming product.

The packed arrays are the JAX package's, byte for byte (``jdia_pack``), so
:func:`~lsqr_tpu_torch.ops.convert.operator_from_arrays` carries a JAX
operator across: ``base`` holds ``P_lo + d - JITTER``, relative to a padded
copy of x with a front margin ``P_lo``, padded to (8, 128) multiples, and
``m_pad`` is a multiple of ``tm``. On CUDA an f32 packing's products launch
:func:`~lsqr_tpu_torch.ops.spmv_sparse.jdia_matvec`, which reads x itself
at that column with a bounds mask; on the CPU they run its plain twin. f64
packings always run the twin (the kernel computes in f32), as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .linop import LinearOperator, placement, to_numpy
from .spmv_sparse import JITTER, jdia_matvec, jdia_matvec_plain

__all__ = ["JDIAOperator", "jdia_operator", "jdia_pack", "JDIAFixpointError", "JITTER",
           "DEFAULT_TM"]

DEFAULT_TM = 8192    # rows per tile (multiple of 1024)


class JDIAFixpointError(RuntimeError):
    """:func:`jdia_pack` found no packing that both orientations accept
    (the JAX package raises a plain RuntimeError here)."""


def _pack_side(rows, cols, vals, m, n, *, ns_max, tm, win_budget, dtype=np.float32):
    """Pack one orientation (A or A'). Returns (data, eoff, base, P_lo, win,
    m_pad, fitted mask). base holds the window-relative slot starts
    P_lo + d - JITTER."""
    nnz = len(vals)
    m_pad = max(-(-m // tm), 1) * tm
    nt = m_pad // tm
    deltas = np.asarray(cols, np.int64) - np.asarray(rows, np.int64)

    from ..native import jdia_assign

    native = jdia_assign(rows, deltas, np.asarray(vals, dtype), m_pad, tm, ns_max, JITTER)
    if native is not None:
        assign_slot, slot_d, slot_used, data_full, eoff_full = native
        ns = max(int(slot_used.max()) if nnz else 0, 1)
        data = np.ascontiguousarray(data_full[:ns])
        eoff = np.ascontiguousarray(eoff_full[:ns])
    else:
        assign_slot, slot_d, slot_used = _assign_np(rows, deltas, nt, ns_max, tm)
        ns = max(int(slot_used.max()) if nnz else 0, 1)
        data = np.zeros((ns, m_pad), dtype)
        eoff = np.zeros((ns, m_pad), np.int8)
        f_idx = np.nonzero(assign_slot >= 0)[0]
        s_f, r_f = assign_slot[f_idx], rows[f_idx]
        e_f = deltas[f_idx] - slot_d[r_f // tm, s_f]
        assert np.all(np.abs(e_f) <= JITTER)
        data[s_f, r_f] = vals[f_idx]
        eoff[s_f, r_f] = e_f.astype(np.int8)

    # window geometry: the padded x has a P_lo front margin; each tile's
    # slots read x_pad[t*tm + base .. + tm + 2048)
    used_mask = np.arange(ns_max)[None, :] < slot_used[:, None]
    d_used = np.where(used_mask, slot_d, 0)
    d_min = int(d_used.min()) if nnz else 0
    d_max = int(d_used.max()) if nnz else 0
    p_lo = max(0, -(d_min - JITTER))
    win = p_lo + d_max - JITTER + tm + 2048
    win = -(-win // 1024) * 1024
    if win * 4 > win_budget:
        raise ValueError(
            f"JDIA padded-x window {win} floats exceeds budget; matrix "
            "bandwidth too large for this tiling"
        )
    ns_p = -(-ns // 8) * 8
    nt_p = -(-nt // 128) * 128
    base = np.zeros((ns_p, nt_p), np.int32)
    base[:ns, :nt] = (p_lo + slot_d[:, :ns].T - JITTER).astype(np.int32)
    return data, eoff, base, p_lo, int(win), m_pad, assign_slot >= 0


def _assign_np(rows, deltas, nt, ns_max, tm):
    """The greedy slot assignment in numpy (bit-identical to the native
    assigner): per tile and slot, the window [c - J, c + J] holding the most
    unassigned entries (first argmax), then at most one entry per row."""
    nnz = len(rows)
    slot_d = np.zeros((nt, ns_max), np.int64)
    slot_used = np.zeros(nt, np.int32)
    assign_slot = np.full(nnz, -1, np.int32)
    tile_of = rows // tm
    order = np.argsort(tile_of, kind="stable")
    bounds = np.searchsorted(tile_of[order], np.arange(nt + 1))
    for t in range(nt):
        idx = order[bounds[t]:bounds[t + 1]]
        if idx.size == 0:
            continue
        d_t, r_t = deltas[idx], rows[idx]
        unassigned = np.ones(idx.size, bool)
        for s in range(ns_max):
            live = np.nonzero(unassigned)[0]
            if live.size == 0:
                break
            ds = np.sort(d_t[live])
            hi = np.searchsorted(ds, ds + 2 * JITTER, side="right")
            center = ds[int(np.argmax(hi - np.arange(ds.size)))] + JITTER
            cand = live[(d_t[live] >= center - JITTER) & (d_t[live] <= center + JITTER)]
            if cand.size == 0:
                break
            _, first_idx = np.unique(r_t[cand], return_index=True)
            take = cand[np.sort(first_idx)]
            assign_slot[idx[take]] = s
            slot_d[t, s] = center
            slot_used[t] = s + 1
            unassigned[take] = False
    return assign_slot, slot_d, slot_used


def jdia_pack(m, n, vals, rows, cols, *, ns_max=16, tm=DEFAULT_TM,
              win_budget=16 * 1024 * 1024, dtype=np.float32):
    """Pack COO triplets (duplicates summed beforehand) into JDIA, its
    transpose packing and the COO remainder. Returns a dict of numpy arrays
    and ints under the :class:`JDIAOperator` field names.

    An entry must stream in both orientations or live in the one shared
    remainder, so that the two products stay transposes of each other: both
    sides are packed on the shrinking fitted set until a fixpoint."""
    dtype = np.dtype(dtype)
    vals = np.asarray(vals, dtype)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    fit = np.ones(len(vals), bool)
    for _ in range(8):
        sub = np.nonzero(fit)[0]
        data, eoff, base, p_lo, win, _, ok_f = _pack_side(
            rows[sub], cols[sub], vals[sub], m, n,
            ns_max=ns_max, tm=tm, win_budget=win_budget, dtype=dtype)
        tdata, teoff, tbase, tp_lo, twin, _, ok_t = _pack_side(
            cols[sub], rows[sub], vals[sub], n, m,
            ns_max=ns_max, tm=tm, win_budget=win_budget, dtype=dtype)
        ok = ok_f & ok_t
        if ok.all():
            break
        fit[sub[~ok]] = False
    else:
        raise JDIAFixpointError("jdia_pack failed to reach a packing fixpoint")
    rem = ~fit
    return dict(
        data=data, eoff=eoff, base=base, tdata=tdata, teoff=teoff, tbase=tbase,
        rem_vals=vals[rem], rem_rows=rows[rem].astype(np.int32),
        rem_cols=cols[rem].astype(np.int32),
        p_lo=p_lo, win=win, tp_lo=tp_lo, twin=twin, tm=tm,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class JDIAOperator(LinearOperator):
    """General sparse m x n operator in jittered-diagonal storage plus a COO
    remainder, with the transpose packing for the adjoint.

    data/eoff (ns, m_pad) f32 or f64 / int8, base (ns_p, nt_p) int32: the
    forward packing; tdata/teoff/tbase the transpose packing; rem_vals,
    rem_rows, rem_cols (int64 on the device) the remainder. ``nnz`` counts
    the entries the operator was built from."""

    data: torch.Tensor
    eoff: torch.Tensor
    base: torch.Tensor
    tdata: torch.Tensor
    teoff: torch.Tensor
    tbase: torch.Tensor
    rem_vals: torch.Tensor
    rem_rows: torch.Tensor
    rem_cols: torch.Tensor
    m: int
    n: int
    p_lo: int
    win: int
    tp_lo: int
    twin: int
    tm: int
    nnz: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def ns(self) -> int:
        """Slots of the forward packing."""
        return self.data.shape[0]

    @property
    def fit_fraction(self) -> float:
        return 1.0 - self.rem_vals.shape[0] / max(self.nnz, 1)

    def _product(self, data, eoff, base, x, p_lo, tm, m_out):
        # f64 packings take the twin on every device (the kernel is f32)
        fn = jdia_matvec_plain if data.dtype == torch.float64 else jdia_matvec
        return fn(data, eoff, base, x.to(data.dtype), m=m_out, p_lo=p_lo, tm=tm)

    def matvec(self, x):
        y = self._product(self.data, self.eoff, self.base, x, self.p_lo, self.tm, self.m)
        if self.rem_vals.shape[0]:
            y = y.index_add_(0, self.rem_rows, self.rem_vals * x.to(self.dtype)[self.rem_cols])
        return y

    def rmatvec(self, y):
        x = self._product(self.tdata, self.teoff, self.tbase, y, self.tp_lo, self.tm, self.n)
        if self.rem_vals.shape[0]:
            x = x.index_add_(0, self.rem_cols, self.rem_vals * y.to(self.dtype)[self.rem_rows])
        return x

    def todense(self) -> torch.Tensor:
        out = torch.zeros((self.m, self.n), dtype=torch.float64, device=self.device)
        i = torch.arange(self.m, device=self.device)
        for s in range(self.ns):
            d = self.base[s, i // self.tm].long() + JITTER - self.p_lo
            c = i + d + self.eoff[s, :self.m].long()
            v = self.data[s, :self.m]
            keep = (v != 0) & (c >= 0) & (c < self.n)
            out.index_put_((i[keep], c[keep]), v[keep].double(), accumulate=True)
        if self.rem_vals.shape[0]:
            out.index_put_((self.rem_rows, self.rem_cols), self.rem_vals.double(),
                           accumulate=True)
        return out.to(self.dtype)


def jdia_operator(m, n, vals, rows, cols, *, ns_max=16, tm=DEFAULT_TM, dtype=None,
                  device=None) -> JDIAOperator:
    """Build a :class:`JDIAOperator` from COO triplets (duplicates summed
    beforehand), packed on the host and moved to ``device`` once (when
    None: the device of a tensor ``vals``, else the card).

    ``dtype`` defaults to float32, or float64 for f64 values (as in JAX);
    f64 products run the plain twin on every device."""
    device = placement(vals, device)
    p, nnz = pack_triplets(m, n, vals, rows, cols, ns_max=ns_max, tm=tm, dtype=dtype)
    return from_packing(p, m, n, nnz, device)


def pack_triplets(m, n, vals, rows, cols, *, ns_max=16, tm=DEFAULT_TM, dtype=None):
    """The host half of :func:`jdia_operator`: (the :func:`jdia_pack` dict,
    the number of entries), with its dtype rule. Raises ValueError or
    :class:`JDIAFixpointError` where the packer refuses the pattern."""
    v, rows, cols = to_numpy(vals), to_numpy(rows), to_numpy(cols)
    if dtype is None:
        dtype = v.dtype if v.dtype == np.float64 else np.float32
    v = to_numpy(v, dtype)
    return jdia_pack(m, n, v, rows, cols, ns_max=ns_max, tm=tm, dtype=v.dtype), len(v)


def from_packing(p, m, n, nnz, device) -> JDIAOperator:
    """The operator over a :func:`jdia_pack` dict (numpy arrays), on
    ``device``; the remainder indices become int64."""

    def t(name, dtype=None):
        return torch.from_numpy(np.array(p[name], order="C", copy=True)).to(
            device=device, dtype=dtype)

    return JDIAOperator(
        data=t("data"), eoff=t("eoff"), base=t("base"),
        tdata=t("tdata"), teoff=t("teoff"), tbase=t("tbase"),
        rem_vals=t("rem_vals"), rem_rows=t("rem_rows", torch.int64),
        rem_cols=t("rem_cols", torch.int64),
        m=int(m), n=int(n), p_lo=int(p["p_lo"]), win=int(p["win"]),
        tp_lo=int(p["tp_lo"]), twin=int(p["twin"]), tm=int(p["tm"]), nnz=int(nnz),
    )
