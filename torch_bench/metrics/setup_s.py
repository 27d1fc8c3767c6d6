"""setup_s: seconds from the process's start to the window's, the imports,
the CUDA context, the program's set-up, the kernels' build or load, the
checked first steps and the pace probe."""


def read(rec):
    return rec.setup_s
