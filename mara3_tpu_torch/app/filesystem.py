"""Filesystem helpers (reference src/app_filesystem.hpp:45-231)."""

from __future__ import annotations

import os
import shutil


def listdir(path: str):
    return sorted(os.listdir(path))


def split(path: str):
    return path.split(os.sep)


def join(parts):
    return os.sep.join(parts)


def extension(path: str) -> str:
    _, ext = os.path.splitext(path)
    return ext.lstrip(".")


def parent(path: str) -> str:
    return os.path.dirname(path)


def require_dir(path: str) -> str:
    if path:
        os.makedirs(path, exist_ok=True)
    return path


def remove_file(path: str):
    os.remove(path)


def remove_recurse(path: str):
    shutil.rmtree(path)


def isfile(path: str) -> bool:
    return os.path.isfile(path)


def isdir(path: str) -> bool:
    return os.path.isdir(path)
