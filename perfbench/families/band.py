"""Banded operators from row-aligned stripes: the generator and the plain
products.

``stripes[d, i] = A[i, i + offsets[d]]``, N(0, 1) drawn on the device from
the run's seed, ``diag_boost`` added on the main diagonal, zero outside
the matrix (the frozen form of ``chip_smoke.py``'s ``random_stripes``).
The products are plain slices and multiply-adds, one diagonal at a time,
in the precision asked for: the reference's operator. Nothing here
imports the program.
"""

from __future__ import annotations

import torch

from perfbench.common import derive


def _geometry(cfg):
    return int(cfg["m"]), int(cfg["n"]), tuple(int(k) for k in cfg["offsets"])


def _span(off, m, n):
    """Rows i of the diagonal ``off`` that lie inside the matrix."""
    return max(0, -off), min(m, n - off)


def values_inside(cfg) -> int:
    m, n, offsets = _geometry(cfg)
    return sum(max(0, hi - lo) for lo, hi in (_span(k, m, n) for k in offsets))


def make(cfg, seed, device) -> dict:
    """The stripes (nd, m) f32 on ``device``, from ``seed`` alone."""
    m, n, offsets = _geometry(cfg)
    g = torch.Generator(device=device).manual_seed(derive(seed, "stripes"))
    data = torch.randn((len(offsets), m), generator=g, device=device, dtype=torch.float32)
    data[offsets.index(0)] += float(cfg["diag_boost"])
    for d, k in enumerate(offsets):
        lo, hi = _span(k, m, n)
        data[d, :lo] = 0
        data[d, max(hi, lo):] = 0
    return {"stripes": data}


def builder_args(cfg, inputs) -> tuple:
    """The positional arguments of the program's stripe builders
    (``dia_shared_operator``, ``dia_operator_device``)."""
    m, n, offsets = _geometry(cfg)
    return m, n, offsets, inputs["stripes"]


def control(cfg, inputs):
    """(inputs, builder keywords) of the control: the program's own bf16
    stripe storage, the nearest precision below the configuration's f32."""
    return inputs, {"storage_dtype": torch.bfloat16}


def products(cfg, inputs, dtype=torch.float64):
    """(forward, adjoint) of the stripes in ``dtype``: forward(X) = X A^T
    for X (k, n), adjoint(U) = U A for U (k, m)."""
    m, n, offsets = _geometry(cfg)
    data = inputs["stripes"].to(dtype)
    spans = [(d, k, *_span(k, m, n)) for d, k in enumerate(offsets)]

    def forward(x):
        y = torch.zeros((x.shape[0], m), dtype=dtype, device=x.device)
        for d, k, lo, hi in spans:
            if hi > lo:
                y[:, lo:hi] += data[d, lo:hi] * x[:, lo + k:hi + k]
        return y

    def adjoint(u):
        z = torch.zeros((u.shape[0], n), dtype=dtype, device=u.device)
        for d, k, lo, hi in spans:
            if hi > lo:
                z[:, lo + k:hi + k] += data[d, lo:hi] * u[:, lo:hi]
        return z

    return forward, adjoint
