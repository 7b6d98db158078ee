"""Name parity: every name of the JAX package's public surface exists in the
port's, except the few written here with the reason the port has none."""

import lsqr_tpu as lj
import lsqr_tpu_torch as lt

#: names of ``lsqr_tpu.__all__`` that the port leaves out, and why
LEFT_OUT = {
    "enable_x64": "JAX's global x64 switch; torch takes the dtype from the inputs",
}


def test_every_jax_name_is_in_the_port():
    missing = [name for name in lj.__all__ if name not in lt.__all__]
    assert sorted(missing) == sorted(LEFT_OUT)
    for name in lt.__all__:
        assert hasattr(lt, name), name


def test_the_ported_modules_names():
    """The names of the JAX package's batch, multidamp, regpath and implicit
    modules, which its ``__init__`` imports whether or not ``__all__`` lists
    them."""
    from lsqr_tpu import batch, implicit, multidamp, regpath

    for module in (batch, multidamp, regpath, implicit):
        for name in module.__all__:
            assert name in lt.__all__ and callable(getattr(lt, name)), name


def test_the_parallel_package_names():
    """``lsqr_tpu_torch.parallel`` exports the names of ``lsqr_tpu.parallel``,
    in its order, and its sharding module those of JAX's; every one is
    defined (the package's __init__ imports none of them, as JAX's)."""
    import lsqr_tpu.parallel as jp
    import lsqr_tpu.parallel.sharding as js
    import lsqr_tpu_torch.parallel as tp
    import lsqr_tpu_torch.parallel.sharding as ts

    assert tp.__all__ == jp.__all__
    assert ts.__all__ == js.__all__
    for name in tp.__all__:
        assert hasattr(tp, name), name
    assert not any(name.startswith("lsqr_sharded") or name == "make_mesh"
                   for name in lt.__all__)
