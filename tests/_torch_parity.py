"""Shared helpers of the lsqr_tpu ↔ lsqr_tpu_torch parity tests.

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU in x64 (tests/conftest.py), its Pallas kernels in interpret mode,
and the port on the CPU through its plain twins. Tests that need a CUDA
device take the ``cuda_device`` fixture, which skips without one.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

# the suite runs under xdist with several workers per host
torch.set_num_threads(1)

#: the port builds on the card unless told otherwise; the CPU tests say so
DEV = torch.device("cpu")

PORT_DIR = Path(__file__).resolve().parents[1] / "lsqr_tpu_torch"


def to_np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def rel_err(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = to_np(got).astype(np.float64), to_np(ref).astype(np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def banded(rng, m, n, offsets, dtype=np.float32, boost=0.0, dense=True):
    """Row-aligned stripes (len(offsets), m), zero outside the matrix, with
    ``boost`` added to the main diagonal, and the dense matrix (None when
    ``dense`` is False, for shapes whose dense form would not fit)."""
    data = rng.standard_normal((len(offsets), m)).astype(dtype)
    i = np.arange(m)
    full = np.zeros((m, n), dtype) if dense else None
    for d, k in enumerate(offsets):
        if k == 0:
            data[d] += boost
        valid = (i + k >= 0) & (i + k < n)
        data[d] *= valid
        if dense:
            full[i[valid], i[valid] + k] = data[d][valid]
    return data, full


def banded_triplets(data, offsets, n):
    """COO triplets (vals, rows, cols) of the stripes' nonzero entries."""
    m = data.shape[1]
    rows, cols, vals = [], [], []
    i = np.arange(m)
    for d, k in enumerate(offsets):
        valid = (i + k >= 0) & (i + k < n)
        rows.append(i[valid])
        cols.append(i[valid] + k)
        vals.append(data[d][valid])
    return np.concatenate(vals), np.concatenate(rows), np.concatenate(cols)


def shared_to_torch(op, device=DEV):
    """The port's operator over the JAX DIASharedOperator's own stripes."""
    from lsqr_tpu_torch import operator_from_arrays

    return operator_from_arrays(
        "dia_shared", {"dp": np.asarray(op.dp)},
        {"m": op.m, "n": op.n, "offsets": op.offsets, "H": op.H}, device=device,
    )


def jax_imports_in(root=PORT_DIR):
    """(file, line) of every import of jax under ``root``."""
    found = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            if any(nm == "jax" or nm.startswith(("jax.", "lsqr_tpu."))
                   or nm in ("jaxlib", "lsqr_tpu") for nm in names):
                found.append((path.name, node.lineno))
    return found


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
