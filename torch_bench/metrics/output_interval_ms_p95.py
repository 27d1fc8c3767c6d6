"""output_interval_ms_p95: the 95th percentile, over every output interval
of the window, of the wall milliseconds from one output (a time-series row
or a diagnostics write) to the next."""

import numpy as np


def read(rec):
    walls = rec.outputs()
    if len(walls) < 2:
        return None
    return float(np.percentile(np.diff(walls), 95)) * 1e3
