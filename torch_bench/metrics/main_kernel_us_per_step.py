"""main_kernel_us_per_step: device microseconds of the configuration's main
kernels (their names listed in its file) in the traced window, per step."""

import re


def read(rec):
    steps = rec.steps()
    if rec.trace is None or steps == 0:
        return None
    pattern = re.compile("|".join(rec.config["main_kernels"]))
    seconds = sum(s for name, s in rec.trace["by_op"].items()
                  if pattern.search(name))
    return seconds / steps * 1e6 if seconds > 0 else None
