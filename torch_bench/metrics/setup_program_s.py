"""setup_program_s: the seconds of the set-up that the program's phase
spans cover (mara3_tpu_torch/app/tracing.py): the union of its
`mara3.setup` (a subprogram's setup(): configuration, mesh, the initial
state on the card, with the CUDA context at the first allocation),
`mara3.build` (a kernel library built or loaded) and `mara3.tables`
(kernel B3's scan, B6's tables) spans that end before the window starts.
The rest of setup_s is the imports and the first steps and probe outside
those spans. None where the program records no such span (one that records
spans only under the profiler, which starts at the window)."""

PHASES = ("mara3.setup", "mara3.build", "mara3.tables")


def before_window(rec, names):
    """[(start ns, end ns)] of the program's closed spans named in `names`
    that end before the window starts, or None without the tracer."""
    try:
        from mara3_tpu_torch.app import tracing
    except ImportError:  # a program that records no spans
        return None
    start = rec.start * 1e9
    return [(s.start_ns, s.end_ns) for s in tracing.spans()
            if s.name in names and s.end_ns is not None
            and s.end_ns <= start]


def union_s(intervals) -> float:
    """The seconds in the union of [(start ns, end ns)]."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total, reach = total + e - s, e
        elif e > reach:
            total, reach = total + e - reach, e
    return total * 1e-9


def read(rec):
    spans = before_window(rec, PHASES)
    return union_s(spans) if spans else None
