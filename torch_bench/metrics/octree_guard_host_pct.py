"""octree_guard_host_pct: the octree machinery's share of the host's time
in blast3d's step, in percent: 100 x (the `mara3.guard` spans, the guard
slabs, plus the `mara3.correct` spans, the level-jump flux correction)
over the `mara3.step` spans that hold them, those of the traced window.
None where the program records no step span in the window."""

from torch_bench import program_spans


def read(rec):
    got = program_spans.window(rec)
    if got is None:
        return None
    spans = got[0]
    steps = {i: s.end_ns - s.start_ns for i, s in spans.items()
             if s.name == "mara3.step"}
    parts = sum(s.end_ns - s.start_ns for s in spans.values()
                if s.name in ("mara3.guard", "mara3.correct")
                and s.parent in steps)
    total = sum(steps.values())
    return 100.0 * parts / total if total > 0 else None
