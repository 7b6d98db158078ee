#!/usr/bin/env python3
"""The WWCOO adjoint's two kernels at RWCOO's cold stream, timed apart.

    python3 tools/wwcoo_adjoint_split.py [ROOT] [--csr]

ROOT (default: this checkout) is a checkout whose ``lsqr_tpu_torch`` is
imported and built; a variant of the kernels is timed by copying
``lsqr_tpu_torch/`` into ``build/<name>/``, editing it there and passing
``build/<name>``. At ``bench.py``'s RWCOO Zipf shape (m = 2^21, n = 65,536,
10,485,760 entries, seed 0, through ``auto_operator``) it prints one line:
the adjoint's plan, its error against the twin, its mean device time
(this checkout's ``chip_smoke.time_ms``) and the profiler's mean device
time of the compaction (``cols_compact``) and the expansion
(``expand_columns``) over 20 calls; with ``--csr``, the cold stream's
``torch.sparse_csr_tensor`` A' @ u beside. Needs one CUDA device.
"""

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    args = [a for a in sys.argv[1:] if a != "--csr"]
    root = Path(args[0] if args else HERE).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import lsqr_tpu_torch as lt
    from lsqr_tpu_torch.models.synthetic import zipf_column_coo
    from lsqr_tpu_torch.ops import spmv_wcoo as sw

    assert Path(lt.__file__).resolve().is_relative_to(root), lt.__file__
    if not torch.cuda.is_available():
        print("wwcoo_adjoint_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    m, n = 2 ** 21, 65536
    trip = zipf_column_coo(m, n, 10 * 2 ** 20, seed=0)
    A = lt.auto_operator(m, n, *trip, device=dev)
    p = A.cold
    y = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    ref = sw.wwcoo_adjoint_plain(p, y)
    out = {"root": root.name,
           "plan": sw.wwcoo_adjoint_plan(p.vals.device.index, p.js * 128, p.eb, p.nc),
           "err": float((sw.wwcoo_adjoint(p, y) - ref).abs().max() / ref.abs().max())}
    if "--csr" in sys.argv:
        cold = ~np.isin(trip[2], A.hotmap.cpu().numpy())
        tri = [torch.from_numpy(a[cold]).to(dev) for a in (trip[1], trip[2], trip[0])]
        at = cs.csr_of(tri[1], tri[0], tri[2], n, m)
        out["cold_csr_t"] = cs.time_ms(lambda: at @ y, 50)
    out["cold_adjoint"] = cs.time_ms(lambda: sw.wwcoo_adjoint(p, y), 50)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            sw.wwcoo_adjoint(p, y)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if dt and ("compact" in ev.key or "expand" in ev.key):
            out[ev.key.split("::")[-1][:14]] = dt / 1e3 / ev.count
    out["card"] = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader").splitlines()[0]
    print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
