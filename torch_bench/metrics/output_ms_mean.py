"""output_ms_mean: the mean wall milliseconds of the window's outputs (a
time-series row with its replay and sample; a diagnostics or checkpoint
task), from the program's `mara3.output` spans."""

from torch_bench import program_spans


def read(rec):
    got = program_spans.window(rec)
    if got is None:
        return None
    spans, _ = got
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in spans.values()
          if s.name == "mara3.output"]
    return sum(ms) / len(ms) if ms else None
