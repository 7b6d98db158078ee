"""The port's streaming-ceiling probe against the JAX package's.

``bench.py``'s ``stream_copy`` (``bench_roofline``, ``bench.py:211``) is a
Pallas kernel nested in a function that runs only at 1 GiB on a TPU, so it
cannot be imported; these tests compute its body, ``_copy_kernel``
(``bench.py:208-209``: ``o = x * 1.0000001`` in f32), in JAX at a small
seeded shape, chained as ``bench.py`` chains it, and hold the port's twin to
it bit for bit: one f32 multiply has one rounding. The kernel itself runs
only on the card (tests/test_torch_cuda.py).
"""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsqr_tpu_torch as lt
from lsqr_tpu_torch.ops import roofline, spmv

BENCH = Path(__file__).resolve().parents[1] / "bench.py"


def _bench():
    """bench.py as a module (it imports only the standard library at its
    top level)."""
    spec = importlib.util.spec_from_file_location("bench_reference", BENCH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("shape,k", [((16, 4096), 1), ((3, 1001), 20), ((1, 7), 5)])
def test_stream_copy_plain_matches_jax_copy_kernel_bit_for_bit(shape, k):
    x = np.random.default_rng(20).standard_normal(shape).astype(np.float32)
    ref = jnp.asarray(x)
    for _ in range(k):
        ref = ref * 1.0000001  # _copy_kernel's body
    assert ref.dtype == jnp.float32
    got = torch.from_numpy(x.copy())
    for _ in range(k):
        out = roofline.stream_copy_plain(got)
    assert out is got and got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    assert not np.array_equal(_bits(x), _bits(ref))  # the multiply changed bits


def test_stream_copy_on_the_cpu_runs_the_twin_in_place_uncounted():
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(1003).astype(np.float32))
    ref = roofline.stream_copy_plain(x.clone())
    spmv.reset_launch_counts()
    ptr = x.data_ptr()
    assert lt.stream_copy(x) is x and x.data_ptr() == ptr
    assert torch.equal(x, ref)
    assert spmv.launch_counts()["stream_copy"] == 0


def test_defaults_are_bench_roofline_shape():
    bench = _bench()
    assert (roofline.ROWS, roofline.COLS, roofline.K) == (bench.ROOF_ROWS, bench.ROOF_COLS,
                                                         bench.ROOF_K)
    params = inspect.signature(lt.stream_ceiling).parameters
    assert (params["rows"].default, params["cols"].default, params["k"].default) == (
        bench.ROOF_ROWS, bench.ROOF_COLS, bench.ROOF_K)
    # 1 GiB of f32: the bound of one copy is 2 GiB over the card's memory rate
    assert 2 * roofline.ROWS * roofline.COLS * 4 == 2 ** 31


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_stream_ceiling_refuses_the_cpu(device):
    with pytest.raises(ValueError, match="measures the card"):
        lt.stream_ceiling(device, rows=4, cols=8, k=2)


def test_stream_copy_counts_as_a_kernel():
    assert spmv.KERNELS[lt.stream_copy] == ("f32",)
    assert lt.stream_copy.kernel_name == "stream_copy"
    assert "stream_copy" in spmv.launch_counts(by_variant=True)
