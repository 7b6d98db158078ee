"""A pool of spawned ranks for the port's sharded-solve tests, and the cases
they run.

Each rank is a process of its own, joined to the others by
``lsqr_tpu_torch.parallel.initialize_distributed`` over gloo with a
``file://`` store in the test's temporary directory (a fixed TCP port would
collide between test workers). The ranks import torch, numpy and
``lsqr_tpu_torch`` only, never JAX. A case is a function of this module:
every rank runs it with the same arguments (numpy problems made by the test
from a seed) and sends back its result; the test holds them to JAX and to
each other.
"""

import multiprocessing
import os
import queue
import traceback

import numpy as np

#: seconds the pool waits for the ranks' results of one case
CASE_TIMEOUT = 240


def _serve(rank, world, store, backend, tasks, results):
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from lsqr_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"file://{store}", world, rank, backend=backend)
    while True:
        job = tasks.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001 - sent to the test as text
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks on ``backend``, each serving cases until
    closed."""

    def __init__(self, world, tmpdir, backend="gloo"):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        store = os.path.join(str(tmpdir), f"store-{os.getpid()}-{id(self)}")
        if os.path.exists(store):  # a store a killed pool left
            os.remove(store)
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, store, backend, self.tasks[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, fn, *args):
        """fn(*args) on every rank: the list of their results, by rank.
        Raises with a rank's traceback when one failed. A case whose ranks
        do not all answer in time (a hang in a collective) ends the pool:
        its ranks are killed and later cases fail at once."""
        if self.broken:
            raise AssertionError("the pool of ranks was ended by an earlier case")
        for q in self.tasks:
            q.put((fn, args))
        out = [None] * self.world
        failures = []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=CASE_TIMEOUT)
            except queue.Empty:
                self.broken = True
                for p in self.procs:
                    p.kill()
                raise AssertionError(f"{fn.__name__}: a rank did not answer in "
                                     f"{CASE_TIMEOUT} s") from None
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
        if failures:
            raise AssertionError("\n".join(failures))
        return out

    def close(self):
        if self.broken:
            return
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# What the ranks build and return
# ---------------------------------------------------------------------------


def build(spec):
    """The port's operator (on the CPU) of a numpy problem spec:
    ("coo", m, n, vals, rows, cols), ("dia" | "dia_shared" | "zdia", m, n,
    offsets, data), ("wcoo" | "rwcoo", m, n, vals, rows, cols)."""
    import lsqr_tpu_torch as lt

    kind, m, n, *rest = spec
    if kind in ("coo", "wcoo", "rwcoo"):
        make = {"coo": lt.coo_operator, "wcoo": lt.wcoo_operator,
                "rwcoo": lt.rwcoo_operator}[kind]
        return make(m, n, *rest, device="cpu")
    offsets, data = rest
    make = lt.dia_shared_operator if kind == "dia_shared" else lt.dia_operator
    return make(m, n, offsets, data, device="cpu")


def mesh_of(shape):
    """The mesh of a shape: an int (1-D over that many ranks) or (R, C)."""
    from lsqr_tpu_torch import parallel

    if isinstance(shape, int):
        return parallel.make_mesh(shape)
    return parallel.make_mesh_2d(shape)


def result(res):
    """A result's fields as numpy (None stays None)."""
    out = {}
    for name, value in res._asdict().items():
        if value is not None:
            out[name] = value.detach().cpu().numpy()
    return out


def solve(entry, spec, b, shape, args=(), kwargs=None):
    """``lsqr_tpu_torch.parallel.<entry>(A, b, *args, mesh=..., **kwargs)``
    on the CPU; None on a rank outside the mesh."""
    from lsqr_tpu_torch import parallel

    mesh = mesh_of(shape)
    if mesh.get_coordinate() is None:
        return None
    A = build(spec)
    return result(getattr(parallel, entry)(A, b, *args, mesh=mesh, device="cpu",
                                           **(kwargs or {})))


def counted_segments(entry, spec, b, shape, args=(), kwargs=None):
    """:func:`solve`'s result with the solve's ``lsqr_tpu_torch.tracing``
    counters, or None on a rank outside the mesh."""
    from lsqr_tpu_torch import tracing

    tracing.clear()
    res = solve(entry, spec, b, shape, args, kwargs)
    return None if res is None else (res, tracing.counts())


def solve_error(entry, spec, b, shape, args=(), kwargs=None):
    """(exception class name, message) of a solve that must fail, or None
    where it does not (and on a rank outside the mesh)."""
    try:
        solve(entry, spec, b, shape, args, kwargs)
    except Exception as e:  # noqa: BLE001 - the test reads it
        return type(e).__name__, str(e)
    return None


def counted_solve(entry, spec, b, shape, args=(), kwargs=None):
    """:func:`solve`, with the lengths of the tensors that every
    ``torch.distributed.all_reduce`` of the solve took."""
    import torch.distributed as dist

    real = dist.all_reduce
    lengths = []

    def counting(tensor, *a, **kw):
        lengths.append(tensor.numel())
        return real(tensor, *a, **kw)

    mesh = mesh_of(shape)
    if mesh.get_coordinate() is None:
        return None
    A = build(spec)
    dist.all_reduce = counting
    try:
        from lsqr_tpu_torch import parallel

        res = getattr(parallel, entry)(A, b, *args, mesh=mesh, device="cpu", **(kwargs or {}))
    finally:
        dist.all_reduce = real
    return result(res), lengths


def packings(entry_prep, spec, shape):
    """This rank's shard packing (its numpy arrays and statics) as the
    sharded WCOO-family solvers build it, with the number of packer calls
    the rank made: ``entry_prep`` is "wcoo", "rwcoo", "wcoo_2d" or
    "wwcoo_2d"."""
    import lsqr_tpu_torch.ops.wcoo as wcoo
    import lsqr_tpu_torch.ops.wwcoo as wwcoo
    from lsqr_tpu_torch.parallel import sharding

    mesh = mesh_of(shape)
    if mesh.get_coordinate() is None:
        return None
    A = build(spec)
    calls = []
    real = {wcoo: wcoo.wcoo_pack_arrays, wwcoo: wwcoo.wwcoo_pack_arrays}
    packs = []

    def spy(module):
        def packer(*a, **kw):
            arrays, meta = real[module](*a, **kw)
            calls.append(module.__name__.rsplit(".", 1)[1])
            packs.append((arrays, meta))
            return arrays, meta
        return packer

    for module in real:
        setattr(module, module.__name__.rsplit(".", 1)[1] + "_pack_arrays", spy(module))
    try:
        b = np.zeros(A.m, np.float32)
        if entry_prep == "wcoo":
            sharding._wcoo_rows(A, b, mesh, "rows", "cpu")
        elif entry_prep == "rwcoo":
            sharding._rwcoo_rows(A, b, mesh, "rows", "cpu")
        else:
            sharding._packed_blocks(A, b, mesh, None, ("rows", "cols"), "cpu",
                                    entry_prep == "wwcoo_2d")
    finally:
        for module, fn in real.items():
            setattr(module, module.__name__.rsplit(".", 1)[1] + "_pack_arrays", fn)
    return calls, packs, tuple(mesh.get_coordinate())


def world_facts(backend):
    """(rank, world size, backend, whether a second initialize_distributed
    returns, the error of one that names another backend)."""
    import torch.distributed as dist

    from lsqr_tpu_torch.parallel import global_mesh, initialize_distributed

    initialize_distributed(backend=backend)
    try:
        initialize_distributed(backend="nccl" if backend == "gloo" else "gloo")
        other = None
    except ValueError as e:
        other = str(e)
    mesh = global_mesh()
    return dist.get_rank(), dist.get_world_size(), dist.get_backend(), mesh.size(0), other


def card_cases(device="cuda:0"):
    """The phase-21 checks of ``chip_smoke.py`` at a small size, on this
    rank's card (the pool's ranks share it under gloo): each sharded solve
    in pair mode against the unsharded solve on the card, with its launches
    and a digest of x. {label: (istop, itn, unsharded itn, x rel err,
    sha256 of x, launches by wrapper, unsharded istop)}."""
    import hashlib

    import torch
    import torch.distributed as dist

    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch import parallel
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo
    from lsqr_tpu_torch.ops import spmv

    dev = torch.device(device)
    world = dist.get_world_size()
    g = torch.Generator(device=dev).manual_seed(21)
    fixed = dict(itnlim=24, atol=0.0, btol=0.0, conlim=0.0, nconv=25)
    m, ks = 1 << 16, tuple(range(-5, 6))
    data = torch.randn((len(ks), m), generator=g, device=dev)
    data[5] += 12.0
    band = lt.dia_shared_operator(m, m, ks, data)
    b = torch.randn(m, generator=g, device=dev)
    vals, rows, cols = zipf_column_coo(1 << 16, 512, 1 << 18, seed=3)
    k = np.arange(512)  # a boosted entry a column, each in a row of its own:
    wcoo = lt.wcoo_operator(  # well-conditioned, so the f32 x holds
        1 << 16, 512, np.concatenate([vals, np.full(512, 1000.0, vals.dtype)]),
        np.concatenate([rows, 128 * k]), np.concatenate([cols, k]), device=dev)
    bw = torch.randn(1 << 16, generator=g, device=dev)
    vals, rows, cols = zipf_column_coo(1 << 14, 3000, 1 << 17, seed=4)
    k = np.arange(3000)
    coo = lt.coo_operator(1 << 14, 3000, np.concatenate([vals, np.full(3000, 100.0, vals.dtype)]),
                          np.concatenate([rows, k]), np.concatenate([cols, k]), device=dev)
    bc = torch.randn(1 << 14, generator=g, device=dev)
    zd = lt.zdia_stripes(1 << 15, 1 << 15, seed=5, diag=12.0, device=dev, generator="torch")
    zdia = lt.zdia_operator_device(1 << 15, 1 << 15, (-2, -1, 0, 1, 2), zd)
    bz = torch.randn(1 << 15, generator=g, device=dev, dtype=torch.complex64)
    cases = {
        "dia": ("lsqr_sharded_dia", band, b, dict(fixed, pair=True), {}),
        "wcoo": ("lsqr_sharded_wcoo", wcoo, bw, dict(fixed, pair=True), {}),
        "2d": ("lsqr_sharded_2d", coo, bc, fixed, dict(mesh_shape=(1, world))),
        "zdia": ("lsqr_sharded_zdia", zdia, bz, dict(fixed, pair=True), {}),
    }
    out = {}
    for label, (entry, A, rhs, opts, extra) in cases.items():
        spmv.reset_launch_counts()
        res = getattr(parallel, entry)(A, rhs, 0.01, device=dev, **opts, **extra)
        launches = {k: v for k, v in spmv.launch_counts().items() if v}
        ref = lt.lsqr(A, rhs, 0.01, **opts)
        x = res.x.cpu()
        err = float((x - ref.x.cpu()).abs().max() / ref.x.cpu().abs().max())
        out[label] = (int(res.istop), int(res.itn), int(ref.itn), err,
                      hashlib.sha256(x.numpy().tobytes()).hexdigest(), launches,
                      int(ref.istop))
    return out
