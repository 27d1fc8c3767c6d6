"""The program's own spans and counters (mara3_tpu_torch/app/tracing.py),
which the readers of the driver loop's per-layer metrics read.

The program records them only while torch.profiler runs, so in a run of
run.py they are the traced window's: the untraced set-up adds none, and a
process runs one window. A program without the tracer, or a window in
which it recorded no chunk, gives None.
"""

from __future__ import annotations


def window(rec):
    """({index: span} of the closed spans that lie inside the window, the
    counters), or None."""
    try:
        from mara3_tpu_torch.app import tracing
    except ImportError:  # a program that records no spans
        return None
    lo, hi = rec.start * 1e9, rec.end * 1e9
    inside = {i: s for i, s in enumerate(tracing.spans())
              if s.end_ns is not None and lo <= s.start_ns
              and s.end_ns <= hi}
    if not any(s.name == tracing.CHUNK for s in inside.values()):
        return None
    return inside, tracing.counts()
