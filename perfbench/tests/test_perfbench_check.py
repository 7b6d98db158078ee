"""The check: sound runs pass, the control and planted faults fail.

Each cell runs here on the CPU at a small size (``_small``), through the
harness's own set-up, window and check (``run.run``), with the program's
CPU twins in place of its CUDA kernels."""

import subprocess
import sys

import pytest
import torch

import lsqr_tpu_torch as lt
from perfbench import calibrate, core, run
from perfbench.common import ROOT, forbidden_loaded
from perfbench.tests import _small

CPU = torch.device("cpu")
CELLS = ["band11.batch16", "band11.mk"]
SEED = 2 ** 33 + 21


def result(name, seed=SEED):
    return run.run(_small.args(name, seed), CPU, _small.cell(name))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = result(name)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check" and set(out["check"]) == set(
        _small.cell(name).spec["check"]["limits"])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [5, 2 ** 35 + 1])
def test_the_control_is_not_correct(name, seed):
    cell = _small.cell(name)
    sound = calibrate.readings(cell, lt, seed, CPU, control=False)
    control = calibrate.readings(cell, lt, seed, CPU, control=True)
    assert core.verdict(cell.spec, sound, 0)[0] is True
    assert core.verdict(cell.spec, control, 0)[0] is False


def unchanged_state(monkeypatch):
    """Every solver step returns its state as it was."""
    from lsqr_tpu_torch import multidamp
    from lsqr_tpu_torch.ops import megakernel

    monkeypatch.setattr(multidamp, "_rows_step", lambda c, cond, body, *, shared: c)
    monkeypatch.setattr(megakernel, "lsqr_megakernel_call", lambda *a, **k: None)


def half_batch(monkeypatch):
    """Half of the right-hand sides solved; the rest get their mean."""
    solve = lt.lsqr_batch

    def halved(A, B, damp, **kw):
        res = solve(A, B[:B.shape[0] // 2], damp, **kw)
        fill = res.x.mean(0, keepdim=True).expand(B.shape[0] - res.x.shape[0], -1)
        return res._replace(x=torch.cat([res.x, fill]),
                            **{f: torch.cat([getattr(res, f)] * 2)[:B.shape[0]]
                               for f in ("istop", "itn", "rnorm", "xnorm")})

    monkeypatch.setattr(lt, "lsqr_batch", halved)


def altered_answer(monkeypatch):
    """The first answer of every call off by 1% where it is produced."""
    for entry in ("lsqr", "lsqr_batch"):
        solve = getattr(lt, entry)

        def altered(*a, _solve=solve, **kw):
            res = _solve(*a, **kw)
            x = res.x.clone()
            (x[0] if x.dim() == 2 else x).mul_(1.01)
            return res._replace(x=x)

        monkeypatch.setattr(lt, entry, altered)


def early_stop(monkeypatch):
    """Every solve stops early: atol and btol 50 times looser, or a quarter
    of its iteration limit cut off; the answer it reaches is left as it is."""
    for entry in ("lsqr", "lsqr_batch"):
        solve = getattr(lt, entry)

        def early(*a, _solve=solve, **kw):
            kw = {k: (50 * v if k in ("atol", "btol") else
                      v * 3 // 4 if k == "itnlim" else v) for k, v in kw.items()}
            return _solve(*a, **kw)

        monkeypatch.setattr(lt, entry, early)


FAULTS = [(cell, fault) for cell in CELLS
          for fault in (unchanged_state, altered_answer, early_stop)]
FAULTS += [(cell, half_batch) for cell in CELLS if cell != "band11.mk"]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    assert result(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_an_early_stop_fails_on_its_iterations(name, monkeypatch):
    """The planted early stop reads an answer close enough to pass on
    ``x_err``: the iteration count is what catches it."""
    early_stop(monkeypatch)
    check = result(name)["check"]
    assert check["itn_gap"]["value"] > check["itn_gap"]["limit"]
    assert check["x_err"]["value"] <= check["x_err"]["limit"]


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_loaded(["lsqr_tpu_torch", "lsqr_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["lsqr_tpu", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "lsqr_tpu"]


def test_the_reference_loads_nothing_of_the_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import perfbench.reference, "
            "perfbench.roofline, perfbench.timeline; from perfbench.common import load_module, "
            "HERE; [load_module(p, p.stem) for p in (HERE / 'families').glob('*.py')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('lsqr_tpu_torch', 'lsqr_tpu', 'jax', 'jaxlib', 'flax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True)
    assert done.returncode == 0, done.stdout + done.stderr


def test_a_run_without_the_card_prints_no_result():
    done = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", "band11.mk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert done.returncode != 0 and done.stdout == ""


def test_a_run_outside_a_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/: the program is
    missing, so set-up fails and no result is printed (past the card's
    check, which a run here does not reach, as ``run.run`` on the CPU)."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, json; sys.path.insert(0, '.'); import torch; "
            "from perfbench import run; from perfbench.tests import _small; "
            "print(json.dumps(run.run(_small.args('band11.mk'), torch.device('cpu'), "
            "_small.cell('band11.mk'))))")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True)
    assert done.returncode != 0 and done.stdout == ""
    assert "lsqr_tpu_torch" in done.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = _small.cell(name)
    dev = torch.device("cuda", 0)
    assert core.verdict(cell.spec, calibrate.readings(cell, lt, 3, dev, False), 0)[0]
    assert not core.verdict(cell.spec, calibrate.readings(cell, lt, 3, dev, True), 0)[0]
