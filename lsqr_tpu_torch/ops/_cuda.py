"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` for ``sm_90a``, one process
per source, all started together, and link into one shared library with a
plain C interface, loaded with ``ctypes``. The library goes
to ``build/lsqr_tpu_torch/`` under the repository root, named by a hash of
the sources and flags, so a changed source builds anew and an unchanged one
loads the library already there. A failed build raises; nothing falls back.

Nothing here runs at import: :func:`library` builds on its first call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "check", "build_dir", "build_log", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # csrc/dia_shared.cu
    # dp, vec, out, offsets, nd, Lp, H, dim_out, dim_in, adjoint, lo, hi, T,
    # stream
    **{f"lsqr_dia_product_shared_{s}": (_P, _P, _P, _P, _I, _L, _I, _L, _L, _I, _I, _I, _I,
                                        _P)
       for s in ("f32", "f64", "bf16")},
    # dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out, dim_in, adjoint, lo,
    # hi, T, stream
    **{f"lsqr_dia_shared_axpy_{s}": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _I, _I,
                                     _I, _I, _P)
       for s in ("f32", "bf16")},
    # dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n, lo, hi, stream
    **{f"lsqr_dia_pair_shared_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _I,
                                     _I, _P)
       for s in ("f32", "bf16")},
    # dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n, lo, hi, T, stream
    **{f"lsqr_dia_pair_shared_staged_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _L,
                                            _L, _I, _I, _I, _P)
       for s in ("f32", "bf16")},
    # csrc/dia_packed.cu
    # data, vec, out, offsets, nd, dim_out, dim_in, column, lo, hi, T, stream
    **{f"lsqr_dia_matvec_{s}": (_P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _I, _P)
       for s in ("f32", "f64", "bf16")},
    # data, vec, y, c1, c2, out, offsets, nd, dim_out, dim_in, stream
    **{f"lsqr_dia_matvec_axpy_{s}": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P)
       for s in ("f32", "bf16", "bf16_f32out")},
    # data, vec, y, c1, c2, out, partial, ticket, ssq, offsets, nd, dim_out,
    # dim_in, slots, stream
    "lsqr_dia_fused_halfstep_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I,
                                    _P),
    # the same, then lo, hi, T (0: the direct kernel), stream
    **{f"lsqr_dia_fused_halfstep_v2_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L,
                                           _I, _I, _I, _I, _P)
       for s in ("f32", "bf16")},
    # data, vec, y, c1, c2, out, partial, offsets, nd, dim_out, dim_in, slots,
    # lo, hi, T, stream
    **{f"lsqr_dia_fused_halfstep_v3_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I,
                                           _I, _I, _I, _P)
       for s in ("f32", "bf16")},
    # data, vec, y, c1, c2, u, z, offsets, nd, m, n, lo, hi, T, stream
    **{f"lsqr_dia_pair_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _P)
       for s in ("f32", "bf16")},
    # nd, lo, hi (returns the tile, 0 where none fits, -1 on a CUDA error)
    **{f"lsqr_dia_pair_tile_{s}": (_I, _I, _I) for s in ("f32", "bf16")},
    # csrc/zdia.cu
    # dr, di, win, y, c1, c2, u, z, offsets, nd, m, n, lo, hi, mode, T, stream
    "lsqr_zdia_pair_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _I,
                           _P),
    # csrc/jdia.cu
    # data, eoff, base, x, out, ns, m_pad, nt_p, m, n, tm, p_lo, stream
    "lsqr_jdia_matvec_f32": (_P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _I, _I, _P),
    # csrc/block_ell.cu
    # blocks, bcols, x, out, partial, mb, kb, bh, bw, slices, stream
    "lsqr_block_ell_matvec_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # blocks, bcols, x, y, c1, c2, u, zp, mb, kb, bh, bw, ranks, keep, stream
    "lsqr_block_ell_pair_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P),
    # csrc/wcoo.cu
    # vals_r, col_r, gpe, x, n, y, y_len, c1, c2, u, m_pad, emax, stream
    "lsqr_wcoo_forward_f32": (_P, _P, _P, _P, _I, _P, _L, _P, _P, _P, _L, _I, _P),
    # vals, idx, u, u_len, partials, blocks, z, n, slots, emax, stream
    "lsqr_wcoo_adjoint_f32": (_P, _P, _P, _L, _P, _I, _P, _I, _L, _I, _P),
    # vals_r, col_r, gpe, vals, idx, x, n, y, y_len, c1, c2, u, partials,
    # blocks, z, m_pad, emax, stream
    "lsqr_wcoo_pair_f32": (_P, _P, _P, _P, _P, _P, _I, _P, _L, _P, _P, _P, _P, _I, _P, _L,
                           _I, _P),
    # csrc/wwcoo.cu: as csrc/wcoo.cu with (colmap, d_pad) after the index
    # plane; the adjoint reads (zptr, zsrc, d_pad) and takes the partials
    # and its plan (groups, wsize, windows, splits)
    "lsqr_wwcoo_forward_f32": (_P, _P, _P, _P, _I, _P, _I, _P, _L, _P, _P, _P, _L, _I, _P),
    # d_pad, eb, nc, plan (4 ints out)
    "lsqr_wwcoo_adjoint_plan": (_I, _I, _L, ctypes.POINTER(ctypes.c_int)),
    # vals, cidx, d_pad, zptr, zsrc, u, u_len, partials, groups, wsize,
    # windows, splits, z, n, slots, emax, stream
    "lsqr_wwcoo_adjoint_f32": (_P, _P, _I, _P, _P, _P, _L, _P, _I, _I, _I, _I, _P, _I, _L, _I,
                               _P),
    # vals_r, col_r, gpe, vals, cidx, colmap, d_pad, zptr, zsrc, x, n, y,
    # y_len, c1, c2, u, partials, groups, wsize, windows, splits, z, m_pad,
    # emax, stream
    "lsqr_wwcoo_pair_f32": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _L, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P, _L, _I, _P),
    # csrc/stream_copy.cu
    # x, len, stream
    "lsqr_stream_copy_f32": (_P, _L, _P),
    # csrc/megakernel.cu
    # solver, bf16, dim, nd, halo (lo + hi), T, blocks (out)
    "lsqr_mk_grid": (_I, _I, _L, _I, _I, _I, ctypes.POINTER(ctypes.c_int)),
    # data, tdata, offsets, toffsets, nd, m, n, u, v, x, w, hbar, state,
    # partial, blocks, K, lo, hi, T, stream
    **{f"lsqr_mk_{solver}_{s}": (_P, _P, _P, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _I, _P)
       for solver in ("lsqr", "lsmr", "craig") for s in ("f32", "bf16")},
}


def build_dir() -> Path:
    """``build/lsqr_tpu_torch`` under the repository root."""
    return CSRC.parents[1] / "build" / "lsqr_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "lsqr_tpu_torch CUDA kernels are built from csrc/ at first use"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    """The headers the sources include (``#include "name.cuh"``): part of
    the library's hash, not compiled on their own."""
    return sorted(CSRC.glob("*.cuh"))


def _compile(sources, out):
    """One ``nvcc -c`` per source, all started together, then one link;
    nvcc's output (``-Xptxas=-v``) goes to ``<library>.log``."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(src.name, log) for src, proc, log in zip(sources, procs, logs)
              if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(("link", proc.stderr))
    Path(f"{out}.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(f"{name}:\n{log}"
                                                        for name, log in failed))
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"liblsqr_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        _compile(sources, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lsqr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lsqr_cuda_error_string.restype = ctypes.c_char_p
    lib.path = out
    return lib


def build_log() -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) of
    the loaded library's build."""
    log = Path(f"{library().path}.log")
    return log.read_text() if log.exists() else ""


def check(code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().lsqr_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code} ({msg})")
