"""HDF5 checkpoint / diagnostics serialization (h5py backend).

Re-design of the reference's I/O stack (src/core_hdf5.hpp, src/app_serialize.hpp,
src/app_serialize_tree.hpp) producing *byte-layout-compatible* files so the
reference's plotting tools (tools/plot_*.py) work unmodified:

- numbered filenames ``chkpt.%04d.h5`` (app_serialize.hpp:183-188)
- ``run_config`` group: one typed scalar dataset per parameter
  (app_serialize.hpp:129-141)
- ``schedule`` group: per-task subgroup with name / num_times_performed /
  last_performed (app_serialize.hpp:69-94)
- trees stored flat with ``"level:ii-jj"`` keys, zero-padded to the level's
  digit count (app_serialize_tree.hpp:72-121)

h5py supplies the RAII/exception-safe object model the reference hand-built
over the HDF5 C API (core_hdf5.hpp:81-104); numpy arrays cross the host
boundary once per scheduled task, never inside the advance. h5py itself is
imported by the callers that open files, so this module loads without it.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np

from mara3_tpu_torch.app.config import Config
from mara3_tpu_torch.app.schedule import Schedule, Task


def create_numbered_filename(prefix: str, count: int, extension: str = "h5",
                             directory: str = ".") -> str:
    """'chkpt', 4 -> 'chkpt.0004.h5' (reference app_serialize.hpp:183-188)."""
    name = f"{prefix}.{count:04d}.{extension}"
    return name if directory in (".", "") else os.path.join(directory, name)


# -----------------------------------------------------------------------------
# config round-trip
# -----------------------------------------------------------------------------

def write_config(group, config: Config):
    for key, value in config:
        if isinstance(value, str):
            group[key] = np.bytes_(value)
        elif isinstance(value, int):
            group[key] = np.int32(value)
        else:
            group[key] = np.float64(value)


def read_config(group) -> Dict[str, object]:
    """Read a run_config group back into a plain dict of python values."""
    out: Dict[str, object] = {}
    for key in group:
        v = group[key][()]
        if isinstance(v, bytes):
            out[key] = v.decode()
        elif np.issubdtype(np.asarray(v).dtype, np.integer):
            out[key] = int(v)
        elif np.issubdtype(np.asarray(v).dtype, np.floating):
            out[key] = float(v)
        else:
            out[key] = v
    return out


# -----------------------------------------------------------------------------
# schedule round-trip
# -----------------------------------------------------------------------------

def write_schedule(group, schedule: Schedule):
    for task in schedule:
        g = group.require_group(task.name)
        for k in ("name", "num_times_performed", "last_performed"):
            if k in g:
                del g[k]
        g["name"] = np.bytes_(task.name)
        g["num_times_performed"] = np.int32(task.num_times_performed)
        g["last_performed"] = np.float64(task.last_performed)


def read_schedule(group) -> Schedule:
    tasks = {}
    for name in group:
        g = group[name]
        tasks[name] = Task(
            name=name,
            num_times_performed=int(g["num_times_performed"][()]),
            last_performed=float(g["last_performed"][()]),
            is_due=False)
    return Schedule(tasks)


# -----------------------------------------------------------------------------
# tree (flat "level:ii-jj" keys) round-trip
# -----------------------------------------------------------------------------

def format_tree_index(level: int, coordinates) -> str:
    """'level:ii-jj' with zero padding to the digit count of 2^level
    (reference format_tree_index, app_serialize_tree.hpp:72-87)."""
    width = 1 + int(math.log10(1 << level)) if level > 0 else 1
    coords = "-".join(f"{c:0{width}d}" for c in coordinates)
    return f"{level}:{coords}"


def read_tree_index(key: str) -> Tuple[int, Tuple[int, ...]]:
    """Inverse of format_tree_index (reference app_serialize_tree.hpp:95-121)."""
    level_str, coords_str = key.split(":", 1)
    return int(level_str), tuple(int(c) for c in coords_str.split("-"))


def write_tree(group, indexes, blocks):
    """Write per-block arrays under flat tree-index keys.

    `indexes` is a sequence of (level, (i, j, ...)) and `blocks` the matching
    sequence of numpy-convertible arrays (reference write_tree,
    app_serialize_tree.hpp:166-180).
    """
    for (level, coords), block in zip(indexes, blocks):
        group[format_tree_index(level, coords)] = np.asarray(block)


def read_tree(group):
    """Read a flat tree group -> (indexes, blocks) sorted by key order."""
    indexes, blocks = [], []
    for key in group:
        indexes.append(read_tree_index(key))
        blocks.append(np.asarray(group[key][()]))
    return indexes, blocks


# -----------------------------------------------------------------------------
# extendable time-series tables (reference subprog_sedov.cpp:518-530, 600-614)
# -----------------------------------------------------------------------------

def require_time_series(h5file, name: str, dtype):
    """Create (if absent) an unlimited-length 1d compound dataset, chunked —
    the reference's extendable time_series.h5 layout."""
    if name in h5file:
        return h5file[name]
    return h5file.create_dataset(name, shape=(0,), maxshape=(None,),
                                 chunks=(256,), dtype=dtype)


def append_time_series(dataset, row):
    """Append one compound row via set_extent + hyperslab write (reference
    subprog_sedov.cpp:518-530)."""
    n = dataset.shape[0]
    dataset.resize((n + 1,))
    dataset[n] = row


# -----------------------------------------------------------------------------
# typed write/read dispatch with a user-extensible registry — the analog of
# the reference's hdf5_type_info<T> trait (core_hdf5.hpp:62-68, 421-500):
# every custom type plugs in a (writer, reader) pair once and then flows
# through the same mara::write / mara::read entry points
# (app_serialize.hpp:55-57, 129-165).
# -----------------------------------------------------------------------------

_TYPE_REGISTRY: Dict[type, Tuple[object, object]] = {}


def register_type(cls, writer, reader):
    """Register `cls` for the generic write()/read() dispatch.

    writer(group, name, value) stores the value under `name`;
    reader(group, name) -> value reconstructs it. Later registrations
    override earlier ones (like a more specific trait specialization)."""
    _TYPE_REGISTRY[cls] = (writer, reader)


def write(group, name: str, value):
    """Typed store: dispatch on the value's class (walking its MRO, so a
    subclass inherits its base's serializer), falling back to plain
    numpy conversion for array-likes."""
    for cls in type(value).__mro__:
        if cls in _TYPE_REGISTRY:
            _TYPE_REGISTRY[cls][0](group, name, value)
            return
    if name in group:
        del group[name]
    group[name] = np.asarray(value)


def read(group, name: str, cls):
    """Typed load: the inverse of write() for a registered `cls` (or a raw
    numpy array when unregistered)."""
    for c in cls.__mro__:
        if c in _TYPE_REGISTRY:
            return _TYPE_REGISTRY[c][1](group, name)
    return np.asarray(group[name][()])


def _write_str(group, name, value):
    if name in group:
        del group[name]
    group[name] = np.bytes_(value)


def _write_config(group, name, value):
    write_config(group.require_group(name), value)


def _write_schedule(group, name, value):
    write_schedule(group.require_group(name), value)


def _read_schedule(group, name):
    return read_schedule(group[name])


def _write_fraction(group, name, value):
    # the reference stores rationals as a [num, den] pair
    # (app_serialize.hpp:274-289)
    if name in group:
        del group[name]
    group[name] = np.asarray([value.numerator, value.denominator], np.int64)


def _read_fraction(group, name):
    from fractions import Fraction
    num, den = (int(v) for v in group[name][()])
    return Fraction(num, den)


def _write_scalar(group, name, value):
    # overwrite semantics, consistent with the str/Fraction writers and
    # the array fallback (h5py raises on assigning over an existing name)
    if name in group:
        del group[name]
    group[name] = value


register_type(str, _write_str, lambda g, n: g[n][()].decode())
register_type(bool, lambda g, n, v: _write_scalar(g, n, np.bool_(v)),
              lambda g, n: bool(g[n][()]))
register_type(int, lambda g, n, v: _write_scalar(g, n, np.int64(v)),
              lambda g, n: int(g[n][()]))
register_type(float, lambda g, n, v: _write_scalar(g, n, np.float64(v)),
              lambda g, n: float(g[n][()]))
register_type(Config, _write_config,
              lambda g, n: read_config(g[n]))
register_type(Schedule, _write_schedule, _read_schedule)

import fractions as _fractions  # noqa: E402
register_type(_fractions.Fraction, _write_fraction, _read_fraction)
