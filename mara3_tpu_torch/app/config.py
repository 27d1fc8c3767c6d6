"""Typed run-configuration system.

Re-design of the reference's config machinery (src/app_config.hpp:71-245):
a ``ConfigTemplate`` declares keys with typed defaults (int / float / str);
``Config`` is an immutable typed store that coerces string CLI values to the
declared type and raises on unknown keys or bad types. Restart precedence is
template defaults <- checkpoint's run_config group <- CLI overrides
(reference subprog_binary.cpp:155-164).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple


_ALLOWED_TYPES = (int, float, str)


def _coerce(key: str, declared: type, value: Any):
    """Coerce `value` to the declared parameter type (reference
    config_t::set, app_config.hpp:103-141): strings parse to int/float;
    ints promote to float; anything else is a type error."""
    if isinstance(value, bool):
        raise TypeError(f"config parameter '{key}': bool is not a valid type")
    if declared is str:
        if isinstance(value, str):
            return value
        raise TypeError(f"config parameter '{key}' expects str, got "
                        f"{type(value).__name__}")
    if declared is float:
        if isinstance(value, str):
            return float(value)
        if isinstance(value, (int, float)):
            return float(value)
    if declared is int:
        if isinstance(value, str):
            # match strict C++ std::stoi-like behavior but reject floats
            if any(c in value for c in ".eE") and not value.lstrip("+-").isdigit():
                raise TypeError(
                    f"config parameter '{key}' expects int, got '{value}'")
            return int(value)
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value == int(value):
            return int(value)
    raise TypeError(f"config parameter '{key}' expects "
                    f"{declared.__name__}, got {value!r}")


@dataclass(frozen=True)
class ConfigTemplate:
    """Declares parameter names and typed defaults (reference
    config_template_t, app_config.hpp:156-186)."""

    items_: Tuple[Tuple[str, type, Any], ...] = ()

    def item(self, key: str, default) -> "ConfigTemplate":
        t = type(default)
        if t not in _ALLOWED_TYPES:
            raise TypeError(f"config default for '{key}' must be int, float, "
                            f"or str, got {t.__name__}")
        if any(k == key for k, _, _ in self.items_):
            raise KeyError(f"duplicate config item '{key}'")
        return ConfigTemplate(self.items_ + ((key, t, default),))

    def create(self) -> "Config":
        return Config(types={k: t for k, t, _ in
                             ((k, t, d) for k, t, d in self.items_)},
                      values={k: d for k, _, d in self.items_})


@dataclass(frozen=True)
class Config:
    """Immutable typed key->value store (reference config_t)."""

    types: Mapping[str, type] = field(default_factory=dict)
    values: Mapping[str, Any] = field(default_factory=dict)

    def __contains__(self, key):
        return key in self.values

    def __iter__(self):
        return iter(self.values.items())

    def get(self, key: str):
        if key not in self.values:
            raise KeyError(f"no config parameter named '{key}'")
        return self.values[key]

    def get_int(self, key: str) -> int:
        v = self.get(key)
        if self.types[key] is not int:
            raise TypeError(f"config parameter '{key}' is not an int")
        return v

    def get_double(self, key: str) -> float:
        v = self.get(key)
        if self.types[key] is not float:
            raise TypeError(f"config parameter '{key}' is not a float")
        return v

    def get_string(self, key: str) -> str:
        v = self.get(key)
        if self.types[key] is not str:
            raise TypeError(f"config parameter '{key}' is not a str")
        return v

    def set(self, key: str, value) -> "Config":
        if key not in self.values:
            raise KeyError(f"no config parameter named '{key}'")
        new_values = dict(self.values)
        new_values[key] = _coerce(key, self.types[key], value)
        return Config(self.types, new_values)

    def update(self, mapping: Mapping[str, Any]) -> "Config":
        cfg = self
        for k, v in mapping.items():
            cfg = cfg.set(k, v)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.values)

    def pretty_print(self, out=None):
        """Banner print (reference app_config.hpp:197-221)."""
        import sys
        out = out or sys.stdout
        width = max((len(k) for k in self.values), default=0)
        lines = ["", "=" * 52]
        for k in sorted(self.values):
            lines.append(f"{k:>{width}} ... {self.values[k]}")
        lines.append("=" * 52 + "\n")
        out.write("\n".join(lines))


def argv_to_string_map(argv) -> Dict[str, str]:
    """Parse 'key=value' CLI arguments (reference argv_to_string_map,
    app_config.hpp:223-245). Non key=value tokens are ignored, matching the
    reference (they are subprogram names / restart files handled upstream).
    """
    out: Dict[str, str] = {}
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            out[k] = v
    return out
