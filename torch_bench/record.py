"""What a window leaves behind, and its reduction to the readers' inputs.

The program prints a progress line after every chunk (`[iteration]
orbits=... kzps=...` for binary, `[iteration] t=... kzps=...` for amrsand),
a line per regrid, and a line per step it retries in safe mode. `Stamped`
stands in for standard output during a window and keeps each line with the
host clock's reading when it arrives; `Record` turns the lines into
chunks, zone-updates and outputs, and holds the traced window's reduction
when there is a trace.
"""

from __future__ import annotations

import io
import math
import re
import time
from dataclasses import dataclass, field

PROGRESS = re.compile(r"^\[(\d+)\] (?:orbits|t)=([-+0-9.eE]+) kzps=")
REGRID = re.compile(r"^regrid: (?:\d+ -> )?(\d+) blocks")
RETRY = "step retried in safe mode"


class Stamped(io.TextIOBase):
    """A text stream that keeps each complete line with the time it
    arrived; nothing is echoed."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.lines = []
        self._part = ""

    def writable(self):
        return True

    def write(self, s):
        now = self.clock()
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines.extend((now, line) for line in done)
        return len(s)


@dataclass
class Record:
    """A window: its wall clock span, the stamped lines, the iteration,
    simulated time (in the progress lines' unit) and blocks it started
    from, the zones of a block, the output interval in the progress lines'
    unit (0 for none) and, with a trace, its reduction (trace.reduce)."""
    start: float
    end: float
    lines: list
    iteration0: int
    time0: float
    blocks0: int
    zones_per_block: int
    output_every: float = 0.0
    setup_s: float = 0.0
    config: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    trace: dict = None

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def progress(self):
        """[(wall, iteration, time)] of the progress lines."""
        out = []
        for wall, line in self.lines:
            m = PROGRESS.match(line)
            if m:
                out.append((wall, int(m.group(1)), float(m.group(2))))
        return out

    def retries(self) -> int:
        return sum(RETRY in line for _, line in self.lines)

    def chunks(self):
        """[(wall, steps, zone-updates, time)] of each progress line's
        chunk: every step counts the zones it had, a regrid's new block
        count applying to the steps after it."""
        zones = self.blocks0 * self.zones_per_block
        it, out = self.iteration0, []
        for wall, line in self.lines:
            m = REGRID.match(line)
            if m:
                zones = int(m.group(1)) * self.zones_per_block
                continue
            m = PROGRESS.match(line)
            if not m:
                continue
            i = int(m.group(1))
            out.append((wall, i - it, (i - it) * zones, float(m.group(2))))
            it = i
        return out

    def steps(self) -> int:
        return sum(c[1] for c in self.chunks())

    def zone_updates(self) -> int:
        return sum(c[2] for c in self.chunks())

    def outputs(self):
        """Wall times of the outputs (time-series rows or diagnostics
        writes) due in the window: each is the arrival of the first
        progress line whose time reaches it."""
        if self.output_every <= 0:
            return []
        # the lines print 7 decimals: half of their last digit is allowed
        due = lambda t: math.floor((t + 5e-8) / self.output_every)
        out, last = [], due(self.time0)
        for wall, _, _, t in self.chunks():
            k = due(t)
            out.extend([wall] * max(k - last, 0))
            last = max(k, last)
        return out
