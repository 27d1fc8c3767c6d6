"""octree_host_us_per_step: the mean of the program's `mara3.step` spans
(blast3d's octree step, mesh/euler3d.py) in the traced window, in
microseconds: the host's time to enqueue one step. Beside
main_kernel_us_per_step it says whether the host or the card paces a
step. None where the program records no such span in the window."""

from torch_bench import program_spans


def read(rec):
    got = program_spans.window(rec)
    if got is None:
        return None
    steps = [s.end_ns - s.start_ns for s in got[0].values()
             if s.name == "mara3.step"]
    return sum(steps) / len(steps) * 1e-3 if steps else None
