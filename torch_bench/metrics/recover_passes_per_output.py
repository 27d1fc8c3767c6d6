"""recover_passes_per_output: the host reads of the SRHD Newton's
convergence (the program's `recover_passes` counter, one a pass of five
updates) over the window's rows and diagnostics writes (its
`outputs.write_time_series` and `outputs.write_diagnostics`). On the card
B5 recovers the steps' primitives inside the kernel, so every pass is an
output's. None where the program counts no such output or no pass."""

from torch_bench import program_spans

OUTPUTS = ("outputs.write_time_series", "outputs.write_diagnostics")


def read(rec):
    got = program_spans.window(rec)
    if got is None:
        return None
    _, counts = got
    outputs = sum(counts.get(k, 0) for k in OUTPUTS)
    passes = counts.get("recover_passes", 0)
    return passes / outputs if outputs and passes else None
