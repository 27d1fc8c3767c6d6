"""Build the CUDA sources under csrc/ with nvcc on first use.

Each `csrc/<name>.cu` becomes a shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library lands in `mara3_tpu_torch/_build/` (listed in .gitignore) under a
name that carries the hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Builds go to a temporary
file and are renamed into place, so concurrent processes never load half a
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from mara3_tpu_torch.app import tracing

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

# sm_90a: Hopper with its arch-specific instructions. --fmad=false keeps
# every product rounded as the plain PyTorch versions round it (see the
# note at the top of each source).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from csrc/ with it")


def _digest(source: Path) -> str:
    h = hashlib.sha256()
    for path in sorted([source, *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}-{_digest(source)}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists;
    returns the library's path. Raises with nvcc's output on failure. With
    `verbose`, builds with -Xptxas=-v, prints nvcc's report and keeps it at
    ptxas_log_path(name), rebuilding a library that has no report."""
    target = library_path(name)
    if target.exists() and not (verbose
                                and not ptxas_log_path(name).exists()):
        return target
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
        ptxas_log_path(name).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return target


def ptxas_log_path(name: str) -> Path:
    """Where a verbose build of csrc/<name>.cu keeps nvcc's -Xptxas=-v
    report (each kernel's registers, spills and shared memory)."""
    return library_path(name).with_suffix(".ptxas.log")


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it first if needed.
    The first load in a process is a `mara3.build` phase span (app/tracing:
    `kernel` the source's name, `built` whether nvcc ran) and a build
    counts `kernel_builds`."""
    lib = _loaded.get(name)
    if lib is None:
        with tracing.phase("mara3.build", kernel=name) as span:
            built = not library_path(name).exists()
            lib = ctypes.CDLL(str(build(name)))
            span.attrs["built"] = built
        if built:
            tracing.tally("kernel_builds")
        _loaded[name] = lib
    return lib
