"""The manifest's cells at sizes a CPU test run holds."""

from types import SimpleNamespace

from perfbench import core

#: per family: the sizes a test gives its configurations
SIZES = {"band": {"m": 4096, "n": 4096}}
#: right-hand sides a call at most (the CPU's products run a row at a time)
ROWS = 8
#: per traffic: options that keep a small cell's character. At 4096 rows
#: the band's f32 LSQR meets its machine-precision test (1 + test2 <= 1)
#: by iteration 27-28, so the fixed budget is cut below it, as 32 lies
#: below it at 2^23
OPTIONS = {"mk32": {"itnlim": 24}}


def cell(name):
    c = core.load_cell(name)
    c.config = dict(c.config, **SIZES[c.config["family"]])
    c.traffic = dict(c.traffic, rows=min(int(c.traffic["rows"]), ROWS),
                     options=dict(c.traffic["options"], **OPTIONS.get(c.traffic["name"], {})))
    return c


def args(name, seed=2 ** 40 + 7, seconds=0.0, trace=0):
    return SimpleNamespace(workload=name, seed=seed, seconds=seconds, trace=trace)
