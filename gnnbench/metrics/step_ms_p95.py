"""step_ms_p95: the 95th percentile of the device time between the starts
of consecutive calls of the window (CUDA events recorded before each call),
over at least 200 intervals, so that ten or more lie beyond it."""

import statistics


def read(m):
    if len(m.step_ms) < 200:
        return None
    return statistics.quantiles(m.step_ms, n=20)[-1]
