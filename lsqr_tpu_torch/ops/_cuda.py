"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library goes
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
    # dp, vec, out, offsets, nd, Lp, H, dim_out, dim_in, adjoint, stream
    **{f"lsqr_dia_product_shared_{s}": (_P, _P, _P, _P, _I, _L, _I, _L, _L, _I, _P)
       for s in ("f32", "f64", "bf16")},
    # dp, vec, y, c1, c2, out, offsets, nd, Lp, H, dim_out, dim_in, adjoint, stream
    **{f"lsqr_dia_shared_axpy_{s}": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _I, _P)
       for s in ("f32", "bf16")},
    # dp, vec, y, c1, c2, u, z, offsets, nd, Lp, H, m, n, stream
    **{f"lsqr_dia_pair_shared_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _P)
       for s in ("f32", "bf16")},
    # csrc/dia_packed.cu
    # data, vec, out, offsets, nd, dim_out, dim_in, column, stream
    **{f"lsqr_dia_matvec_{s}": (_P, _P, _P, _P, _I, _L, _L, _I, _P)
       for s in ("f32", "f64", "bf16")},
    # data, vec, y, c1, c2, out, offsets, nd, dim_out, dim_in, stream
    **{f"lsqr_dia_matvec_axpy_{s}": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P)
       for s in ("f32", "bf16", "bf16_f32out")},
    # data, vec, y, c1, c2, out, partial, ticket, ssq, offsets, nd, dim_out,
    # dim_in, slots, stream
    "lsqr_dia_fused_halfstep_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L,
                                    _I, _P),
    # data, vec, y, c1, c2, u, z, offsets, nd, m, n, lo, hi, stream
    **{f"lsqr_dia_pair_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _P)
       for s in ("f32", "bf16")},
    # csrc/megakernel.cu
    # solver, bf16, dim, blocks (out)
    "lsqr_mk_grid": (_I, _I, _L, ctypes.POINTER(ctypes.c_int)),
    # data, tdata, offsets, toffsets, nd, m, n, u, v, x, w, hbar, state,
    # partial, blocks, K, stream
    **{f"lsqr_mk_{solver}_{s}": (_P, _P, _P, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _P)
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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"liblsqr_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)
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
