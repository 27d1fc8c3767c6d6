"""replay_steps_pct: the steps the driver loop ran again (to reach a
time-series due inside a chunk, or to rewind a faulted chunk) per hundred
useful steps, from the program's `replay_steps` and `steps` counters."""

from torch_bench import program_spans


def read(rec):
    got = program_spans.window(rec)
    if got is None:
        return None
    _, counts = got
    steps = counts.get("steps", 0)
    return 100.0 * counts.get("replay_steps", 0) / steps if steps else None
