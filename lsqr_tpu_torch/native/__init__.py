"""The host packer: ctypes bindings over ``native/sparse_pack.cpp``.

This package's own copy of the JAX package's host runtime (the C++ source
is the same file). It packs COO triplets into the ELL, blocked-ELL, CSR and
JDIA layouts on the host, in numpy arrays, before the operators move them
to their device once.

The library builds with ``g++`` at first use into ``build/lsqr_tpu_torch/``
under the repository root, named by a hash of the source and flags (as
:mod:`lsqr_tpu_torch.ops._cuda` builds the kernels). Every entry point has a
numpy fallback that gives bit-identical results, taken when the compiler or
the build is missing; :func:`available` says which of the two runs. This is
host code, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "ell_pack",
    "csr_from_coo",
    "block_pack",
    "coo_dedup",
    "jdia_assign",
]

_SRC = Path(__file__).resolve().parent / "sparse_pack.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
#: the loaded library; None before the first use, False when it cannot build
_LIB = None
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """``build/lsqr_tpu_torch/libsparse_pack_<hash>.so`` under the
    repository root."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return (_SRC.parents[2] / "build" / "lsqr_tpu_torch"
            / f"libsparse_pack_{digest.hexdigest()[:16]}.so")


def _build_lib() -> Path:
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                try:
                    lib = ctypes.CDLL(str(_build_lib()))
                    _declare(lib)
                    _LIB = lib
                except (OSError, subprocess.SubprocessError):
                    _LIB = False
    return _LIB or None


def _declare(lib):
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    lib.lsqr_row_counts.restype = i64
    lib.lsqr_row_counts.argtypes = [i32p, i64, i32, i64p]
    lib.lsqr_block_count.restype = i64
    lib.lsqr_block_count.argtypes = [i32p, i32p, i64, i32, i32, i32, i64, i64p]
    for sfx, np_t in (("f32", np.float32), ("f64", np.float64)):
        fp = np.ctypeslib.ndpointer(np_t, flags="C_CONTIGUOUS")
        fn = getattr(lib, f"lsqr_ell_pack_{sfx}")
        fn.restype = None
        fn.argtypes = [i32p, i32p, fp, i64, i32, i64, fp, i32p, i64p]
        fn = getattr(lib, f"lsqr_csr_from_coo_{sfx}")
        fn.restype = None
        fn.argtypes = [i32p, i32p, fp, i64, i32, i64p, i32p, fp]
        fn = getattr(lib, f"lsqr_block_pack_{sfx}")
        fn.restype = None
        fn.argtypes = [i32p, i32p, fp, i64, i32, i32, i32, i64, i64, fp, i32p]
        fn = getattr(lib, f"lsqr_coo_dedup_{sfx}")
        fn.restype = i64
        fn.argtypes = [i32p, i32p, fp, i64]
        fn = getattr(lib, f"lsqr_jdia_assign_{sfx}")
        fn.restype = None
        fn.argtypes = [i64p, i64p, fp, i64, i64, i32, i32, i32, i32p, i64p, i32p,
                       fp, i8p]


def available() -> bool:
    """True when the compiled library runs; False when the numpy fallbacks
    do (no ``g++``, or the build failed)."""
    return _lib() is not None


def _prep(rows, cols, vals):
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.float32, np.float64):
        vals = vals.astype(np.float64)
    sfx = "f32" if vals.dtype == np.float32 else "f64"
    return rows, cols, vals, sfx


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


def ell_pack(rows, cols, vals, m):
    """COO -> ELL (m, k). Returns (vals2d, cols2d)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None:
        return _ell_pack_np(rows, cols, vals, m)
    counts = np.zeros(m, np.int64)
    k = max(int(lib.lsqr_row_counts(rows, nnz, m, counts)), 1)
    out_vals = np.zeros((m, k), vals.dtype)
    out_cols = np.zeros((m, k), np.int32)
    fill = np.zeros(m, np.int64)
    getattr(lib, f"lsqr_ell_pack_{sfx}")(rows, cols, vals, nnz, m, k, out_vals,
                                         out_cols, fill)
    return out_vals, out_cols


def _ell_pack_np(rows, cols, vals, m):
    counts = np.bincount(rows, minlength=m)
    k = max(int(counts.max()) if counts.size else 0, 1)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    pos = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(len(rows_s)) - pos[rows_s]
    out_vals = np.zeros((m, k), vals.dtype)
    out_cols = np.zeros((m, k), np.int32)
    out_vals[rows_s, within] = vals_s
    out_cols[rows_s, within] = cols_s
    return out_vals, out_cols


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


def csr_from_coo(rows, cols, vals, m):
    """COO -> CSR. Returns (indptr int64 (m+1,), cols int32, vals)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None:
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(m + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, cols[order], vals[order]
    indptr = np.zeros(m + 1, np.int64)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, vals.dtype)
    getattr(lib, f"lsqr_csr_from_coo_{sfx}")(rows, cols, vals, nnz, m, indptr,
                                             out_cols, out_vals)
    return indptr, out_cols, out_vals


# ---------------------------------------------------------------------------
# Blocked-ELL
# ---------------------------------------------------------------------------


def block_pack(rows, cols, vals, mb, bh, bw, stride, max_fill_ratio=64.0):
    """COO -> blocked-ELL. Returns (blocks (mb, kb, bh, bw), bcols (mb, kb)).

    Raises ValueError if the blocked representation would store more than
    ``max_fill_ratio`` times nnz values: a pattern that blocky storage
    cannot serve (use ELL or COO instead)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None:
        uniq_ids = np.unique((rows // bh).astype(np.int64) * stride + cols // bw)
        per_row = np.bincount((uniq_ids // stride).astype(np.int64), minlength=mb)
        kb = max(int(per_row.max()) if per_row.size else 0, 1)
    else:
        counts = np.zeros(mb, np.int64)
        kb = max(int(lib.lsqr_block_count(rows, cols, nnz, bh, bw, mb, stride,
                                          counts)), 1)
    stored = float(mb) * kb * bh * bw
    if nnz and stored > max_fill_ratio * nnz:
        raise ValueError(
            f"block_pack would store {stored/nnz:.0f}x nnz ({stored:.3g} "
            f"values for {nnz} nonzeros) — the sparsity pattern is not "
            f"blocky at block ({bh}, {bw}); use the ELL or COO operator"
        )
    if lib is None:
        return _block_pack_np(rows, cols, vals, mb, bh, bw, stride)
    blocks = np.zeros((mb, kb, bh, bw), vals.dtype)
    bcols = np.zeros((mb, kb), np.int32)
    getattr(lib, f"lsqr_block_pack_{sfx}")(rows, cols, vals, nnz, bh, bw, mb, stride,
                                           kb, blocks, bcols)
    return blocks, bcols


def _block_pack_np(rows, cols, vals, mb, bh, bw, stride):
    br = rows // bh
    bc = cols // bw
    ids = br.astype(np.int64) * stride + bc
    uniq, inv = np.unique(ids, return_inverse=True)
    ubr = (uniq // stride).astype(np.int64)
    ubc = (uniq % stride).astype(np.int64)
    counts = np.bincount(ubr, minlength=mb)
    kb = max(int(counts.max()) if counts.size else 0, 1)
    blocks = np.zeros((mb, kb, bh, bw), vals.dtype)
    bcols = np.zeros((mb, kb), np.int32)
    # the slot of each unique block within its block row: uniq is sorted, so
    # a row's blocks are contiguous and in ascending column order
    first = np.searchsorted(ubr, ubr, side="left")
    slot_of = np.arange(len(uniq)) - first
    bcols[ubr, slot_of] = ubc
    np.add.at(blocks, (ubr[inv], slot_of[inv], rows - br * bh, cols - bc * bw), vals)
    return blocks, bcols


# ---------------------------------------------------------------------------
# Dedup
# ---------------------------------------------------------------------------


def coo_dedup(rows, cols, vals):
    """Sort by (row, col) and sum duplicates. Returns (rows, cols, vals)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None or nnz == 0:
        order = np.lexsort((cols, rows))
        rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
        if nnz == 0:
            return rows_s, cols_s, vals_s
        new = np.concatenate([[True], (np.diff(rows_s) != 0) | (np.diff(cols_s) != 0)])
        group = np.cumsum(new) - 1
        out_vals = np.zeros(group[-1] + 1, vals.dtype)
        np.add.at(out_vals, group, vals_s)
        return rows_s[new], cols_s[new], out_vals
    rows, cols, vals = rows.copy(), cols.copy(), vals.copy()
    out = int(getattr(lib, f"lsqr_coo_dedup_{sfx}")(rows, cols, vals, nnz))
    return rows[:out], cols[:out], vals[:out]


# ---------------------------------------------------------------------------
# JDIA greedy slot assignment
# ---------------------------------------------------------------------------


def jdia_assign(rows, deltas, vals, m_pad, tm, ns_max, jitter):
    """Greedy jittered-diagonal slot assignment and slot-array fill (the hot
    loop of :func:`lsqr_tpu_torch.ops.jdia.jdia_pack`'s one-side packing).
    Returns (assign_slot (nnz,) int32 with -1 = unassigned, slot_d
    (nt, ns_max) int64 window centres, slot_used (nt,) int32, data
    (ns_max, m_pad), eoff (ns_max, m_pad) int8), or None without the
    library (the caller then runs the numpy loop)."""
    lib = _lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    deltas = np.ascontiguousarray(deltas, np.int64)
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.float32, np.float64):
        vals = vals.astype(np.float64)
    sfx = "f32" if vals.dtype == np.float32 else "f64"
    nnz = len(rows)
    nt = m_pad // tm
    assign_slot = np.empty(nnz, np.int32)
    slot_d = np.empty(nt * ns_max, np.int64)
    slot_used = np.empty(nt, np.int32)
    data = np.zeros((ns_max, m_pad), vals.dtype)
    eoff = np.zeros((ns_max, m_pad), np.int8)
    getattr(lib, f"lsqr_jdia_assign_{sfx}")(
        rows, deltas, vals, np.int64(nnz), np.int64(m_pad), np.int32(tm),
        np.int32(ns_max), np.int32(jitter), assign_slot, slot_d, slot_used, data, eoff)
    return assign_slot, slot_d.reshape(nt, ns_max), slot_used, data, eoff
