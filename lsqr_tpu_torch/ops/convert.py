"""Carry state across from the JAX package without repacking.

``operator_from_arrays`` turns the arrays of a JAX operator (as numpy
arrays) into this package's operator on a device; ``result_to_numpy`` turns
a result of either package into numpy arrays. Together they let both
packages compute on the same stored operator and compare what comes out.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..config import resolve_device
from .compose import add_operators
from .coo import coo_operator
from .jdia import from_packing
from .linop import LinearOperator
from .rwcoo import RWCOOOperator
from .structured import BlockELLOperator, DIAOperator, DIASharedOperator, ELLOperator
from .wcoo import WCOOOperator
from .wcoo import packed_from_arrays as wcoo_packed
from .wwcoo import WWCOOOperator
from .wwcoo import packed_from_arrays as wwcoo_packed
from .zdia import ZDIAOperator, ZJDIAOperator

__all__ = ["operator_from_arrays", "result_to_numpy"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    device = resolve_device(device)
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def operator_from_arrays(kind: str, arrays: Mapping[str, np.ndarray],
                         meta: Mapping, device=None) -> LinearOperator:
    """Build this package's operator from a JAX operator's arrays, on
    ``device`` (the card when None).

    kind "dia_shared": arrays {"dp"}, meta {"m", "n", "offsets", "H"}, i.e.
        ``np.asarray(op.dp)`` and the static fields of a JAX
        ``DIASharedOperator``; dp is used as it is.
    kind "dia": arrays {"data", "tdata"}, meta {"m", "n", "offsets"} of a
        JAX ``DIAOperator``; both stripe arrays are used as they are.
    bf16 stripes keep their bits.
    kind "coo": arrays {"vals", "rows", "cols"}, meta {"m", "n"}.
    kind "jdia": arrays {"data", "eoff", "base", "tdata", "teoff", "tbase",
        "rem_vals", "rem_rows", "rem_cols"}, meta {"m", "n", "p_lo", "win",
        "tp_lo", "twin", "tm", "nnz"} of a JAX ``JDIAOperator``.
    kind "ell": arrays {"vals", "cols", "tvals", "trows"}, meta {"m", "n"} of
        a JAX ``ELLOperator``.
    kind "block_ell": arrays {"blocks", "bcols", "tblocks", "tbrows"}, meta
        {"m", "n"} of a JAX ``BlockELLOperator``.
    kind "hyb": the ELL part's arrays as for "ell", and for a JAX
        ``SumOperator`` of ELL and COO also the COO part's as "coo_vals",
        "coo_rows", "coo_cols"; meta {"m", "n"}.
    kind "wcoo": the arrays of a JAX ``WCOOOperator``'s ``packed`` (of which
        "vals", "idx", "vals_r", "col_r" and "gpe" are read; the TPU tables
        are not needed) and of its ``coo`` ("coo_vals", "coo_rows",
        "coo_cols"); meta: the packing's static fields {"m", "n", "m_pad",
        "nc", "eb", "xs", "kb", "ku"}.
    kind "wwcoo": the same for a JAX ``WWCOOOperator`` (of its packing's
        arrays "vals", "vals_r", "col_r", "colmap", "gpe" and "rowl" are
        read; its thirteen static fields).
    kind "rwcoo": a JAX ``RWCOOOperator``'s hot packing's arrays as
        "hot_<name>", its cold packing's as "cold_<name>" (none when it has
        no cold stream), "hotmap" and the "coo_*" triplets; meta {"n", "hot":
        the hot packing's statics, "cold": the cold's or None}.
    kind "zdia": arrays {"dr", "di", "tdr", "tdi"}, meta {"m", "n", "offsets"}
        of a JAX ``ZDIAOperator``; the four planes are used as they are.
    kind "zjdia": the "jdia" arrays of a JAX ``ZJDIAOperator``'s real plane
        prefixed "re_" and of its imaginary plane prefixed "im_"; meta: the
        "jdia" meta, which the two planes share (one pattern).
    Index arrays become int64 where the port indexes with them.
    """
    kinds = ("dia_shared", "dia", "coo", "jdia", "ell", "block_ell", "hyb", "wcoo", "wwcoo",
             "rwcoo", "zdia", "zjdia")
    if kind not in kinds:
        raise ValueError(f"unknown operator kind {kind!r} ({', '.join(kinds)})")
    if kind == "dia_shared":
        return DIASharedOperator(
            dp=_tensor(arrays["dp"], device), m=int(meta["m"]), n=int(meta["n"]),
            offsets=tuple(int(k) for k in meta["offsets"]), H=int(meta["H"]),
        )
    if kind == "dia":
        return DIAOperator(
            data=_tensor(arrays["data"], device), tdata=_tensor(arrays["tdata"], device),
            m=int(meta["m"]), n=int(meta["n"]),
            offsets=tuple(int(k) for k in meta["offsets"]),
        )
    if kind == "zdia":
        return ZDIAOperator(
            **{k: _tensor(arrays[k], device) for k in ("dr", "di", "tdr", "tdi")},
            m=int(meta["m"]), n=int(meta["n"]),
            offsets=tuple(int(k) for k in meta["offsets"]),
        )
    if kind == "zjdia":
        planes = [operator_from_arrays(
            "jdia", {k[3:]: v for k, v in arrays.items() if k.startswith(pre)}, meta, device)
            for pre in ("re_", "im_")]
        return ZJDIAOperator(re=planes[0], im=planes[1])
    if kind == "coo":
        return coo_operator(meta["m"], meta["n"], _tensor(arrays["vals"], device),
                            arrays["rows"], arrays["cols"])
    if kind in ("wcoo", "wwcoo", "rwcoo"):
        return _chunked(kind, arrays, meta, resolve_device(device))
    m, n = int(meta["m"]), int(meta["n"])
    if kind == "jdia":
        packing = dict(arrays, **{k: meta[k] for k in ("p_lo", "win", "tp_lo", "twin",
                                                          "tm")})
        return from_packing(packing, m, n, int(meta["nnz"]), resolve_device(device))
    if kind in ("ell", "hyb"):
        ell = ELLOperator(
            vals=_tensor(arrays["vals"], device),
            cols=_tensor(arrays["cols"], device).long(),
            tvals=_tensor(arrays["tvals"], device),
            trows=_tensor(arrays["trows"], device).long(), m=m, n=n)
        if kind == "ell" or "coo_vals" not in arrays:
            return ell
        return add_operators([ell, coo_operator(
            m, n, _tensor(arrays["coo_vals"], device), arrays["coo_rows"],
            arrays["coo_cols"])])
    return BlockELLOperator(
        blocks=_tensor(arrays["blocks"], device), bcols=_tensor(arrays["bcols"], device),
        tblocks=_tensor(arrays["tblocks"], device), tbrows=_tensor(arrays["tbrows"], device),
        m=m, n=n)


def _chunked(kind, arrays, meta, device):
    """The WCOO, WWCOO or RWCOO operator over a JAX operator's arrays."""
    def part(prefix):
        return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}

    if kind == "rwcoo":
        hot = wcoo_packed(part("hot_"), meta["hot"], device)
        m, n = hot.m, int(meta["n"])
    else:
        m, n = int(meta["m"]), int(meta["n"])
    coo = coo_operator(m, n, _tensor(arrays["coo_vals"], device), arrays["coo_rows"],
                       arrays["coo_cols"])
    if kind == "wcoo":
        return WCOOOperator(packed=wcoo_packed(arrays, meta, device), coo=coo)
    if kind == "wwcoo":
        return WWCOOOperator(packed=wwcoo_packed(arrays, meta, device), coo=coo)
    cold = None if meta["cold"] is None else wwcoo_packed(part("cold_"), meta["cold"], device)
    return RWCOOOperator(hot=hot, hotmap=_tensor(arrays["hotmap"], device), cold=cold,
                         coo=coo, n=n)


def result_to_numpy(res) -> dict:
    """{field: numpy array or None} for a result of either package: an
    LSQRResult, LSMRResult, CRAIGResult or CGLSResult."""
    out = {}
    for name, value in res._asdict().items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        elif value is not None:
            value = np.asarray(value)
        out[name] = value
    return out
