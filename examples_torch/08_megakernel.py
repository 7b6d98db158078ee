"""The iteration megakernel: K complete LSQR iterations per kernel launch.

For small-to-mid problems the per-launch fixed cost, not bandwidth,
dominates solve time. ``lsqr_megakernel`` runs both bidiagonalization
half-steps, the Givens rotations, the x/w update and the full stopping
logic (lsqr.f90:681-810) inside ONE persistent cooperative CUDA kernel,
K iterations a launch. Results match the regular f32 solver to rounding.

The size follows ``--device``: 262,144 rows on the card, 8,192 on the
CPU, where the megakernel runs its plain PyTorch twin.

Run: python examples_torch/08_megakernel.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="the LSQR megakernel")
parser.add_argument("--device", default="cuda", help="where the solves run (default: cuda)")
args = parser.parse_args()

m = 262_144 if torch.device(args.device).type == "cuda" else 8_192
offsets = (-2, -1, 0, 1, 2)

rng = np.random.default_rng(0)
data = rng.standard_normal((len(offsets), m)).astype(np.float32)
data[2] += 6.0  # dominant main diagonal
A = lt.dia_operator(m, m, offsets, data, dtype=torch.float32, device=args.device)
b = rng.standard_normal(m).astype(np.float32)

print("megakernel_supported:", lt.megakernel_supported(A))

res = lt.lsqr(A, b, atol=1e-5, btol=1e-5)
print(f"regular   : istop={int(res.istop)} itn={int(res.itn)} "
      f"rnorm={float(res.rnorm):.6e}")

resm = lt.lsqr_megakernel(A, b, atol=1e-5, btol=1e-5, iters_per_call=32)
print(f"megakernel: istop={int(resm.istop)} itn={int(resm.itn)} "
      f"rnorm={float(resm.rnorm):.6e}")

dx = float((res.x - resm.x).abs().max())
print(f"max |x_regular - x_megakernel| = {dx:.2e}")
