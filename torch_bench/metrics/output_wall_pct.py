"""output_wall_pct: the share of the traced window's wall time that the
program spent inside its `mara3.output` spans (the tasks due at a chunk's
end: rows, diagnostics snapshots, checkpoints), in percent. None where the
program records no chunk span in the window."""

from torch_bench import program_spans


def read(rec):
    got = program_spans.window(rec)
    if got is None or rec.window_s <= 0:
        return None
    spans, _ = got
    ns = sum(s.end_ns - s.start_ns for s in spans.values()
             if s.name == "mara3.output")
    return 100.0 * ns * 1e-9 / rec.window_s
