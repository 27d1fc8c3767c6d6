"""setup_build_s: the seconds of the set-up in the program's `mara3.build`
spans (mara3_tpu_torch/app/tracing.py: a kernel library built with nvcc or
loaded, at its first call in the process) that end before the window
starts, their union. Milliseconds where the libraries exist, seconds where
the run builds one. None where the program records no such span."""

from torch_bench.metrics import setup_program_s


def read(rec):
    spans = setup_program_s.before_window(rec, ("mara3.build",))
    return setup_program_s.union_s(spans) if spans else None
