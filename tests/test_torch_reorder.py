"""The reordering planner at 2^18 against the JAX package, on scrambled
jittered-diagonal patterns whose RCM order does not reach a JDIA fit of
0.95 (the seeds of ``tests/test_torch_general.py`` are small ones whose
order does).

Inputs come from numpy seeds and go through both packages. JAX runs on the
CPU in x64, the port on the CPU.
"""

import numpy as np
import pytest

import lsqr_tpu_torch as lt
from lsqr_tpu.ops.jdia import jdia_pack as j_jdia_pack
from lsqr_tpu.ops.reorder import plan_general as j_plan_general
from lsqr_tpu_torch.models.synthetic import jittered_band_coo
from lsqr_tpu_torch.ops.jdia import jdia_pack as t_jdia_pack

from _torch_parity import DEV


@pytest.mark.parametrize("seed", [31, 5])
def test_plan_general_keeps_the_order_where_rcm_falls_short(seed):
    """At 2^18, RCM's order of these scrambled patterns leaves the JDIA
    packer without a fixpoint (seed 31) or at a fit below 0.95 (seed 5), in
    both packages alike, so neither planner reorders (f64: no step-3 route)."""
    m = n = 2 ** 18
    vals, rows, cols = jittered_band_coo(m, n, seed=seed, dtype=np.float64, diag=12.0)
    rng = np.random.default_rng(seed)
    rows, cols = rng.permutation(m)[rows], rng.permutation(n)[cols]
    ro, co = lt.bandwidth_orders(m, n, rows, cols)
    outcome = []
    for pack in (j_jdia_pack, t_jdia_pack):
        try:
            p = pack(m, n, vals, ro[rows], co[cols], dtype=np.float64)
            outcome.append(1.0 - len(p["rem_vals"]) / len(vals))
        except RuntimeError as exc:
            outcome.append(str(exc))
    assert outcome[0] == outcome[1]
    if seed == 31:
        assert outcome[0] == "jdia_pack failed to reach a packing fixpoint"
    else:
        assert 0.9 < outcome[0] < 0.95
    pj = j_plan_general(m, n, vals, rows, cols)
    pt = lt.plan_general(m, n, vals, rows, cols, device=DEV)
    assert type(pt.op).__name__ == type(pj.op).__name__
    np.testing.assert_array_equal(pj.row_order, np.arange(m))
    np.testing.assert_array_equal(pt.row_order, pj.row_order)
    np.testing.assert_array_equal(pt.col_order, pj.col_order)
