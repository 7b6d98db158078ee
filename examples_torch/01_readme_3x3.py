"""The reference README example (lsqr.f90's README, the 3 x 3 COO system)
on the PyTorch port: solve a 3x3 dense system given as a COO triple.
Expected output: istop = 1, x = (1.242424, -0.06060606, -0.04040404).

Run: python examples_torch/01_readme_3x3.py [--device cuda|cpu]
"""

import argparse

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="the README's 3x3 system")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
args = parser.parse_args()

solver = lt.LSQRSolver(
    m=3,
    n=3,
    a=[1, 4, 7, 2, 5, 88, 3, 66, 9],
    irow=[0, 1, 2, 0, 1, 2, 0, 1, 2],
    icol=[0, 0, 0, 1, 1, 1, 2, 2, 2],
    device=args.device,
)
res = solver.solve(b=[1, 2, 3], damp=0.0)
print("istop =", int(res.istop), "->", res.istop_message)
print("x     =", res.x.cpu().numpy())
