"""Row-partitioned distributed solve over ``torch.distributed``.

Every rank runs the same program on the same A and b: ``lsqr_sharded``
partitions A's rows over the ranks of a 1-D mesh, each rank's products
touch its own rows and one all-reduce an iteration sums the transpose
product's partials. With ``--device cuda`` the ranks are NCCL ranks, one a
card (NCCL refuses two ranks on one card); with ``--device cpu`` they are
gloo ranks on the host. Here the ranks are spawned processes of this
script joined through a file in a temporary directory; across hosts, call
``lsqr_tpu_torch.parallel.initialize_distributed`` with the coordinator's
address on every host instead.

Run: python examples_torch/04_distributed_mesh.py [--device cuda|cpu] [--ranks R]
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp


def problem():
    rng = np.random.default_rng(0)
    m, n, nnz = 4000, 1500, 60_000
    return (m, n, rng.standard_normal(nnz), rng.integers(0, m, nnz),
            rng.integers(0, n, nnz), rng.standard_normal(m))


def rank_main(rank, world, device, init):
    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.parallel import initialize_distributed, lsqr_sharded, make_mesh

    backend = "nccl" if device == "cuda" else "gloo"
    initialize_distributed(init, world, rank, backend=backend)
    dev = torch.device(f"cuda:{rank}") if device == "cuda" else torch.device("cpu")
    m, n, vals, rows, cols, b = problem()
    A = lt.coo_operator(m, n, vals, rows, cols, device=dev)
    mesh = make_mesh()  # all ranks, a 1-D 'rows' axis
    res = lsqr_sharded(A, b, damp=0.05, mesh=mesh, device=dev, atol=1e-8, btol=1e-8,
                       itnlim=500)
    if rank == 0:
        print(f"solving on {world} {backend} rank(s)")
        print("istop =", int(res.istop), " itn =", int(res.itn),
              " rnorm =", float(res.rnorm))
        # equivalence with the single-device solve
        ref = lt.lsqr(A, b, 0.05, atol=1e-8, btol=1e-8, itnlim=500)
        print("max |x_sharded - x_single| =", float((res.x - ref.x).abs().max()))
    torch.distributed.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description="a row-partitioned solve")
    parser.add_argument("--device", default="cuda", help="cuda (NCCL ranks) or cpu (gloo)")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks to spawn (default: the cards, or 2 on the cpu)")
    args = parser.parse_args()
    world = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    if args.device == "cuda" and not 1 <= world <= torch.cuda.device_count():
        raise SystemExit(f"NCCL needs one card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(rank_main, args=(world, args.device, init), nprocs=world, join=True)


if __name__ == "__main__":
    main()
