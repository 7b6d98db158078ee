"""Paths, names, seeds and file loading shared by the harness's parts."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

#: top-level modules that no run may load: JAX, its libraries and the JAX
#: package (whole names: ``lsqr_tpu_torch`` is not ``lsqr_tpu``)
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "lsqr_tpu"})


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run (the stripes, call i's
    right-hand sides, the sample), from ``--seed`` and the stream's name:
    any whole number gives a valid ``torch.Generator`` seed."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in ``path`` (a reader or a family), loaded by its file:
    names of the manifest may hold dots."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded(modules) -> list:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top-level name,
    the part before the first dot compared whole, is forbidden."""
    return sorted(name for name in modules if name.split(".")[0] in FORBIDDEN_MODULES)
