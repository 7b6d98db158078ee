"""Seeded generation, the byte count and the plain reference."""

import numpy as np
import pytest
import torch

from perfbench import core, roofline
from perfbench.common import derive
from perfbench.families import band
from perfbench.reference import lsqr_rows
from perfbench.tests import _small

CPU = torch.device("cpu")
BIG = 2 ** 40 + 12345


@pytest.mark.parametrize("name", ["band11.batch16", "band11.mk"])
def test_seeded_generation_repeats_and_seeds_differ(name):
    cell = _small.cell(name)
    a = cell.family.make(cell.config, BIG, CPU)
    b = cell.family.make(cell.config, BIG, CPU)
    c = cell.family.make(cell.config, BIG + 1, CPU)
    for key in a:
        assert torch.equal(a[key], b[key])
    assert not all(torch.equal(a[key], c[key]) for key in a)
    r = [core.rhs(cell, BIG, i, CPU) for i in (0, 0, 1)]
    assert torch.equal(r[0], r[1]) and not torch.equal(r[0], r[2])


def test_derive_is_a_63_bit_seed():
    for seed in (0, -3, 2 ** 31 + 1, 2 ** 70):
        s = derive(seed, "rhs", 5)
        assert 0 <= s < 2 ** 63 and s == derive(seed, "rhs", 5) != derive(seed, "rhs", 6)


def test_band_stripes_zero_outside_and_boosted():
    cfg = dict(m=64, n=48, offsets=[-3, 0, 2], diag_boost=12.0)
    s = band.make(cfg, 1, CPU)["stripes"]
    # rows 3..50 of offset -3, 0..47 of offset 0, 0..45 of offset 2
    assert s[0, :3].eq(0).all() and s[0, 51:].eq(0).all() and s[0, 3:51].ne(0).all()
    assert s[2, 46:].eq(0).all() and s[1, 48:].eq(0).all()
    assert s[1, :48].mean() > 10
    assert band.values_inside(cfg) == 48 + 48 + 46


def test_byte_counts_against_hand_worked_values():
    # the band at 2^23 x 11: 11 * 2^23 - 30 values inside
    vals, m = 11 * 2 ** 23 - 30, 2 ** 23
    assert roofline.work_bytes(vals, m, m, "pair") == 4 * vals + 4 * 4 * m
    assert roofline.work_bytes(vals, m, m, "lsqr_iteration") == 4 * vals + 8 * 4 * m
    assert roofline.work_bytes(10 * 2 ** 20, 2 ** 21, 2048, "pair") == \
        4 * 10 * 2 ** 20 + 4 * (2 * 2 ** 21 + 2 * 2048)
    ms = {w: 1e3 * roofline.bound_seconds(roofline.work_bytes(v, mm, n, w))
          for w, v, mm, n in (("pair", vals, m, m), ("lsqr_iteration", vals, m, m))}
    assert round(ms["pair"], 4) == 0.1502 and round(ms["lsqr_iteration"], 3) == 0.190
    zipf = 1e3 * roofline.bound_seconds(roofline.work_bytes(10 * 2 ** 20, 2 ** 21, 2048, "pair"))
    assert round(zipf, 4) == 0.0175
    assert roofline.share_percent(10 ** 9, 10 ** 9 / 3.35e12) == pytest.approx(100.0)


def dense(forward, n):
    return forward(torch.eye(n, dtype=torch.float64)).T


@pytest.mark.parametrize("cfg", [
    dict(m=50, n=40, offsets=[-4, -1, 0, 3], diag_boost=5.0),
    dict(m=30, n=45, offsets=[-2, 0, 5], diag_boost=1.0),
])
def test_products_are_adjoint_dense_matrices(cfg):
    inputs = band.make(cfg, 9, CPU)
    fwd, adj = band.products(cfg, inputs)
    A = dense(fwd, cfg["n"])
    assert A.shape == (cfg["m"], cfg["n"])
    At = adj(torch.eye(cfg["m"], dtype=torch.float64))
    assert torch.allclose(A, At, rtol=0, atol=1e-12)
    i = 7
    for d, k in enumerate(cfg["offsets"]):
        assert A[i, i + k] == inputs["stripes"][d, i].double()
    # nothing outside the diagonals
    on = torch.zeros(A.shape, dtype=torch.bool)
    for k in cfg["offsets"]:
        on |= torch.ones(A.shape, dtype=torch.bool).triu(k).tril(k)
    assert A[~on].eq(0).all()


@pytest.mark.parametrize("damp", [0.0, 0.01, 0.7])
@pytest.mark.parametrize("cfg", [
    dict(m=60, n=60, offsets=[-2, 0, 1], diag_boost=4.0),
    dict(m=90, n=40, offsets=[-50, -7, 0, 3], diag_boost=0.5),
])
def test_reference_matches_lstsq_on_damped_problems(cfg, damp):
    inputs = band.make(cfg, 4, CPU)
    fwd, adj = band.products(cfg, inputs)
    A = dense(fwd, cfg["n"]).numpy()
    g = torch.Generator().manual_seed(2)
    B = torch.randn((3, cfg["m"]), generator=g, dtype=torch.float64)
    out = lsqr_rows(fwd, adj, B, damp, atol=1e-14, btol=1e-14, itnlim=20 * cfg["n"],
                    snap_at=torch.tensor([1, 2, 5]))
    for j in range(3):
        stacked = np.vstack([A, damp * np.eye(cfg["n"])])
        rhs = np.concatenate([B[j].numpy(), np.zeros(cfg["n"])])
        x = np.linalg.lstsq(stacked, rhs, rcond=None)[0]
        assert np.linalg.norm(out["x"][j].numpy() - x) <= 1e-9 * np.linalg.norm(x)
        r = np.linalg.norm(stacked @ out["x"][j].numpy() - rhs)
        assert float(out["rnorm"][j]) == pytest.approx(r, rel=1e-8)
    assert set(out["istop"].tolist()) <= {1, 2, 3}
    if damp > 0:
        assert 2 not in out["istop"].tolist()
    # the iterate after one step is x_1 = phi_1 / rho_1 * v_1, in span{A'b}
    v1 = A.T @ B[0].numpy()
    x1 = out["x_at"][0].numpy()
    assert abs(abs(x1 @ v1) - np.linalg.norm(x1) * np.linalg.norm(v1)) <= 1e-9 * abs(x1 @ v1)
