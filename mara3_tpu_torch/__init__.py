"""mara3_tpu_torch — the PyTorch and CUDA port of mara3_tpu.

The JAX package ``mara3_tpu`` is the reference this package is held to;
the two live side by side and only the tests import both. This package
imports torch and never jax. Its layout mirrors the JAX package's
(``app/``, ``core/``, ``physics/``, ``mathx/``, ``mesh/``, ``models/``,
``schemes/``, ``kernels/``, ``subprograms/``), plus ``csrc/`` for the CUDA sources that
``kernels/_build.py`` compiles on first use.

What runs today: the flagship circumbinary disk,
``python -m mara3_tpu_torch binary key=val ...``, on the reference-shaped
driver loop (``fast_step=0``, kernel B2 ``csrc/binary_advance.cu`` per
advance) and on the device-resident loop (``fast_step=1``, the default on
a GPU, with K steps per launch of kernel B3 ``csrc/binary_multi.cu``); and
the Kelvin-Helmholtz shear layer, ``python -m mara3_tpu_torch kh ...``, on
a uniform periodic grid through kernel B1 ``csrc/iso2d_step.cu``; and the
1D spherical Sedov-Taylor blast (SRHD or Euler),
``python -m mara3_tpu_torch sedov ...``, through kernel B5
``csrc/sedov_step.cu``. On the CPU, which a caller must ask for, the same
functions run as plain torch ops.
"""

__version__ = "0.1.0"
