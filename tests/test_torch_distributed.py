"""The port's multi-process entry points (``lsqr_tpu_torch.parallel``'s
``initialize_distributed``, ``global_mesh``, ``lsqr_multihost``) against the
JAX package's single-process solve, as ``tests/test_distributed.py`` holds
JAX's two-process run.

Two spawned processes (a module-wide pool, ``_torch_ranks``) join one gloo
world through ``initialize_distributed`` with a ``file://`` store; both call
``lsqr_multihost`` with the same problem, and both must return the same x,
bit for bit, which must match the single-process solves of both packages.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 - one CPU thread, as the ranks have
import _torch_ranks as ranks
import lsqr_tpu as lj
import lsqr_tpu_torch as lt


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = ranks.RankPool(2, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def problem():
    """JAX's two-process test problem: ragged over two ranks."""
    rng = np.random.default_rng(42)
    m, n, nnz = 110, 70, 700
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    return ("coo", m, n, vals, rows, cols), rng.standard_normal(m)


def multihost(spec, b, kwargs):
    """One rank's lsqr_multihost solve and what it knows of its world."""
    import torch.distributed as dist

    from lsqr_tpu_torch.parallel import lsqr_multihost

    res = ranks.result(lsqr_multihost(ranks.build(spec), b, 0.1, device="cpu", **kwargs))
    return res, dist.get_rank(), dist.get_world_size()


def test_two_process_solve_matches_single(pool):
    spec, b = problem()
    kw = dict(atol=0.0, btol=0.0, conlim=0.0, itnlim=20)
    (r0, rank0, world), (r1, rank1, _) = pool.run(multihost, spec, b, kw)
    assert (rank0, rank1, world) == (0, 1, 2)
    for name in r0:  # both processes hold the same result
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    _, m, n, vals, rows, cols = spec
    ref = lj.lsqr(lj.coo_operator(m, n, vals, rows, cols), b, 0.1, **kw)
    own = lt.lsqr(ranks.build(spec), torch.from_numpy(b), 0.1, **kw)
    for other in (ref, own):
        assert int(r0["itn"]) == int(other.itn) and int(r0["istop"]) == int(other.istop)
        np.testing.assert_allclose(r0["x"], np.asarray(other.x), rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(r0["rnorm"], float(other.rnorm), rtol=1e-10)


def test_world_is_set_up_once_with_a_named_backend(pool):
    """A second initialize_distributed returns; one naming another backend
    than the world's raises; the global mesh spans both processes."""
    facts = pool.run(ranks.world_facts, "gloo")
    for rank, (got_rank, world, backend, mesh_size, other) in enumerate(facts):
        assert (got_rank, world, backend, mesh_size) == (rank, 2, "gloo", 2)
        assert other is not None and "runs gloo, not nccl" in other


@pytest.mark.parametrize("address,init", [
    ("localhost:29512", "tcp://localhost:29512"),
    ("file:///tmp/store", "file:///tmp/store"),
    (None, "env://"),
])
def test_initialize_distributed_rendezvous(monkeypatch, address, init):
    """The coordinator address as ``torch.distributed`` takes it, the world
    size and rank passed on, and the backend named: gloo without a card."""
    import torch.distributed as dist

    from lsqr_tpu_torch.parallel import initialize_distributed

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    initialize_distributed(address, 4, 3)
    initialize_distributed(address, backend="gloo")
    expected = "nccl" if torch.cuda.is_available() else "gloo"
    assert calls == [(expected, dict(init_method=init, world_size=4, rank=3)),
                     ("gloo", dict(init_method=init, world_size=-1, rank=-1))]
