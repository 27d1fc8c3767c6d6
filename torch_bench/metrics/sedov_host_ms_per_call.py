"""sedov_host_ms_per_call: the host milliseconds of sedov's chunked loop
a B5 call (one call a chunk), from the program's spans: over the window's
`mara3.chunk` spans, the mean of each one's duration less its `mara3.wait`
child's. None where the program records no chunk span in the window."""

from torch_bench.metrics import loop_host_ms_per_chunk


def read(rec):
    return loop_host_ms_per_chunk.read(rec)
