"""Smoke-run the port's examples (examples_torch/) in-process on the CPU,
and hold the directory to its rules: a counterpart of every example of
the JAX package, no import of JAX or of the JAX package, ``--device`` with
the card as its default.

The examples that finish in seconds here run with ``--device cpu`` (those
of tests/test_examples.py, and every other one but the card-sized 03, the
spawned ranks of 04 and the million-row 17 and 18, which the card test
``test_cuda_examples_run`` in tests/test_torch_cuda.py runs with the rest).
"""

import ast
import pathlib
import runpy
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples_torch"

FAST = ["01_readme_3x3.py", "02_damped_least_squares.py", "05_checkpoint_resume.py",
        "06_solver_family.py", "07_general_sparsity.py", "08_megakernel.py",
        "09_memory_capacity.py", "10_tikhonov_regularization.py",
        "11_differentiable_solves.py", "12_regularization_path.py",
        "13_hybrid_regularization.py", "14_randomized_preconditioning.py",
        "15_mixed_precision_refinement.py", "16_complex_least_squares.py"]


@pytest.mark.parametrize("name", FAST)
def test_example_runs_on_the_cpu(name, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out
    assert "istop" in out or "x" in out  # printed something sensible


def test_every_jax_example_has_a_counterpart():
    jax_names = sorted(p.name for p in (ROOT / "examples").glob("[0-9]*.py"))
    port_names = sorted(p.name for p in EXAMPLES.glob("[0-9]*.py"))
    assert len(jax_names) == len(port_names) == 18
    assert [n[:3] for n in jax_names] == [n[:3] for n in port_names]
    assert "03_large_banded_gpu.py" in port_names


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.py")), ids=lambda p: p.name)
def test_example_imports_no_jax_and_defaults_to_the_card(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "lsqr_tpu"), f"{path.name} imports {name}"
    text = path.read_text()
    assert 'add_argument("--device", default="cuda"' in text
    assert "TPU" not in text and "v5e" not in text
