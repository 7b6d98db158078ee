"""solve_p95_ms: the 95th percentile of the wall times of all calls in the
window, in ms (linear interpolation between ranks). Read where the window
holds at least 200 calls, so that ten or more lie beyond it."""

import numpy as np

MIN_CALLS = 200


def read(ctx):
    times = ctx.window.call_s
    return 1e3 * float(np.percentile(times, 95)) if len(times) >= MIN_CALLS else None
