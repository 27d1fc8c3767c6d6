"""loop_host_ms_per_chunk: the driver loop's host milliseconds a chunk,
from the program's spans: over the window's `mara3.chunk` spans, the mean
of each one's duration less its `mara3.wait` child's (the host waiting for
the device)."""

from collections import defaultdict

from torch_bench import program_spans


def read(rec):
    got = program_spans.window(rec)
    if got is None:
        return None
    spans, _ = got
    waited = defaultdict(int)
    for s in spans.values():
        if s.name == "mara3.wait":
            waited[s.parent] += s.end_ns - s.start_ns
    host = [s.end_ns - s.start_ns - waited[i] for i, s in spans.items()
            if s.name == "mara3.chunk"]
    return sum(host) / len(host) * 1e-6
