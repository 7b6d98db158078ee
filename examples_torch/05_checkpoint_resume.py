"""Segmented solve with checkpointing: cut a long solve into fixed-size
segments, persist the carry after each, resume from disk (bit-identical to
the uninterrupted solve).

Run: python examples_torch/05_checkpoint_resume.py [--device cuda|cpu]
"""

import argparse
import os
import tempfile

import numpy as np

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="a checkpointed solve")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(0)
m, n, nnz = 3000, 1200, 40_000
A = lt.coo_operator(
    m, n,
    rng.standard_normal(nnz),
    rng.integers(0, m, nnz),
    rng.integers(0, n, nnz),
    device=args.device,
)
b = rng.standard_normal(m)

with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, "carry.npz")
    res = lt.lsqr_checkpointed(
        A, b, damp=0.05,
        segment_iters=50,
        checkpoint_path=ckpt,
        on_segment=lambda seg, carry: print(
            f"segment {seg}: itn={int(carry.itn)} rnorm={float(carry.rnorm):.6f}"
        ),
        atol=1e-9, btol=1e-9, itnlim=1000,
    )
    print("final: istop =", int(res.istop), " itn =", int(res.itn))
    # resume from the last checkpoint: the same answer as the uninterrupted run
    again = lt.lsqr_checkpointed(A, b, damp=0.05, segment_iters=50, resume_from=ckpt,
                                 atol=1e-9, btol=1e-9, itnlim=1000)
    print("resumed from", os.path.basename(ckpt), ": istop =", int(again.istop),
          " itn =", int(again.itn), " same x:", bool((again.x == res.x).all()))
