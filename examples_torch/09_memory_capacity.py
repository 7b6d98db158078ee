"""Fitting the largest banded problem on one card: shared-stripe DIA.

The packed ``dia_operator`` keeps a transpose stripe copy so the adjoint
product streams like the forward one; at the memory-capacity limit that
copy is the difference between fitting and not. ``dia_shared_operator``
stores ONE zero-padded stripe array and serves both products from it:
half the operator memory, the same solve. The sizes printed are each
operator's own tensors; on the card the script also reads the memory the
allocator holds after building each, with the card's name and power limit
(``nvidia-smi``).

Run: python examples_torch/09_memory_capacity.py [--device cuda|cpu]
"""

import argparse
import subprocess

import numpy as np
import torch

import lsqr_tpu_torch as lt

parser = argparse.ArgumentParser(description="packed against shared DIA storage")
parser.add_argument("--device", default="cuda", help="where the operators go (default: cuda)")
args = parser.parse_args()
dev = torch.device(args.device)
on_card = dev.type == "cuda"

rng = np.random.default_rng(0)
m = n = 100_000
offsets = tuple(range(-5, 6))
stripes = rng.standard_normal((len(offsets), m)).astype(np.float32)
stripes[5] += 4.0


def held():
    return torch.cuda.memory_allocated(dev) if on_card else 0


if on_card:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0
          else torch.cuda.get_device_name(dev))
before = held()
packed = lt.dia_operator(m, n, offsets, stripes, device=dev)
after_packed = held()
shared = lt.dia_shared_operator(m, n, offsets, stripes, device=dev)
after_shared = held()
packed_bytes = packed.data.nbytes + packed.tdata.nbytes
print(f"packed operator: {packed_bytes / 2**20:.1f} MiB "
      f"(data + transpose copy)")
print(f"shared operator: {shared.dp.nbytes / 2**20:.1f} MiB "
      f"({shared.dp.nbytes / packed_bytes:.0%})")
if on_card:
    print(f"allocator on the card: packed {(after_packed - before) / 2**20:.1f} MiB, "
          f"shared {(after_shared - after_packed) / 2**20:.1f} MiB")

b = rng.standard_normal(m).astype(np.float32)
rp = lt.lsqr(packed, b, 0.01, itnlim=50, atol=0.0, btol=0.0, conlim=0.0)
rs = lt.lsqr(shared, b, 0.01, itnlim=50, atol=0.0, btol=0.0, conlim=0.0)
print(f"solves match: itn {int(rp.itn)} == {int(rs.itn)}, "
      f"max |dx| = {float((rp.x - rs.x).abs().max()):.1e}")

# the same switch through the format auto-selector:
rows = np.concatenate([np.arange(m)] * 3)
cols = np.clip(np.concatenate([np.arange(m) - 1, np.arange(m),
                               np.arange(m) + 1]), 0, n - 1)
vals = rng.standard_normal(len(rows)).astype(np.float32)
A = lt.auto_operator(m, n, vals, rows, cols, compact=True, device=dev)
print("auto_operator(compact=True) ->", type(A).__name__)
