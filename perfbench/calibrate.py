"""Readings for the check's limits: sound runs and the control, at a
cell's own size, in one process.

    python3 perfbench/calibrate.py --workload band11.batch16 --seeds 11,12 --control-seeds 11 \
        --fault early_stop --fault-seeds 12

For each seed: the cell's inputs, the operator from the traffic's builder,
one call of the traffic's entry on call 0's right-hand sides (what the
window's first call gets), then, for a control seed, the same call on the
family's lower-precision control (``families/<family>.py: control``), and
for a fault seed the same call with the planted fault's options in place
of the traffic's (``cells/<workload>.json: check.faults``), and every
check reading of each against the float64 reference on the same inputs
and the traffic's own options. One JSON line a seed and kind on standard
output. The limits in ``cells/<workload>.json`` are set from these
readings (PERF.md).
"""

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

from perfbench import core  # noqa: E402


def readings(cell, lt, seed, device, control: bool, fault=None) -> dict:
    """The check's readings of one call on a fresh operator (the control's
    where ``control``), with the planted fault ``fault``'s options where
    given, against the reference."""
    A, _ = core.build(lt, cell, cell.family.make(cell.config, seed, device), device,
                      control=control)
    B = core.rhs(cell, seed, 0, device)
    planted = cell
    if fault is not None:
        options = dict(cell.traffic["options"], **cell.spec["check"]["faults"][fault])
        planted = dataclasses.replace(cell, traffic=dict(cell.traffic, options=options))
    prog = core.answer(core.call(lt, planted, A, B))
    del A
    gc.collect()
    return core.judge_one(cell, core.reference_of(cell, seed, device), B, prog,
                          core.sample_rows(cell, seed, 0))


def calibrate(cell, seeds, control_seeds, device, fault=None, fault_seeds=()):
    import lsqr_tpu_torch as lt

    for seed in seeds:
        kinds = [("sound", False, None)]
        if seed in control_seeds:
            kinds.append(("control", True, None))
        if seed in fault_seeds:
            kinds.append((fault, False, fault))
        for kind, control, planted in kinds:
            got = readings(cell, lt, seed, device, control, planted)
            yield {"workload": cell.name, "seed": seed, "kind": kind, **got}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control-seeds", default="", help="seeds that also run the control")
    p.add_argument("--fault", default=None, help="a planted fault of the cell's check.faults")
    p.add_argument("--fault-seeds", default="", help="seeds that also run the fault")
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        core.log("calibrate reads the card; no CUDA device")
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faulty = {int(s) for s in args.fault_seeds.split(",") if s} if args.fault else set()
    for row in calibrate(cell, seeds + sorted((control | faulty) - set(seeds)), control,
                         torch.device("cuda", 0), args.fault, faulty):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
