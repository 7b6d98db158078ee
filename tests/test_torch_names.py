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
