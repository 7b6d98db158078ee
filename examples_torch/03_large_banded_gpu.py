"""Large banded system on the card: 1M x 1M, 11 diagonals (11M nnz), f32,
on the shared-stripe DIA layout, whose products and bidiagonalization pair
run the port's hand-written CUDA kernels (``dia_pair_shared``,
``dia_product_shared``). The data is made on the device (no host
transfer). The first solve builds the kernels (nvcc, once per checkout);
the second is timed.

Run: python examples_torch/03_large_banded_gpu.py [--device cuda|cpu] [--m M]
"""

import argparse
import time

import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="a large banded f32 solve")
parser.add_argument("--device", default="cuda", help="where the solve runs (default: cuda)")
parser.add_argument("--m", type=int, default=1_000_000, help="rows = columns")
args = parser.parse_args()
dev = torch.device(args.device)

m = args.m
offsets = tuple(range(-5, 6))
g = torch.Generator(device=dev).manual_seed(0)
data = torch.randn((len(offsets), m), generator=g, device=dev)
A = lt.dia_shared_operator(m, m, offsets, data)
b = torch.randn(m, generator=g, device=dev)


def solve():
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lt.lsqr(A, b, damp=0.01, atol=1e-5, btol=1e-5, itnlim=300)
    itn = int(res.itn)  # waits for the solve
    return res, itn, time.perf_counter() - t0


solve()  # builds the kernels on first use
res, itn, secs = solve()
name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
print(f"{itn} iterations in {secs:.2f}s on {name} "
      f"(istop={int(res.istop)}, rnorm={float(res.rnorm):.3f})")
