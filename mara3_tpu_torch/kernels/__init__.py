"""Hand-written GPU kernels, each beside its plain PyTorch version.

A kernel's wrapper takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; it never falls back from one to the
other. ``_build.py`` compiles ``csrc/*.cu`` with nvcc on first use.
"""
