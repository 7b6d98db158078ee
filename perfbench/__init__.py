"""The benchmark of ``lsqr_tpu_torch`` on one NVIDIA card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything
that belongs to one configuration, traffic mix, cell or metric lives in a
file of its own, found by the name the manifest gives it:

* ``configs/<config>.json``: sizes, source, damp and the operator family;
* ``families/<family>.py``: the seeded generator and the plain f64
  products of that family (the reference's half that knows the matrix);
* ``traffic/<traffic>.json``: the entry call, right-hand sides a call,
  options and the operator builder the user calls;
* ``cells/<workload>.json``: the check's sample, its limits and the
  traced slice of one cell;
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx)``.

Nothing here imports ``jax`` or the JAX package; the reference
(``reference.py`` and ``families/``) imports nothing of the program.
"""
