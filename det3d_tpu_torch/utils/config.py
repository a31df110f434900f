"""Config files -> attribute dicts: the part of det3d_tpu/utils/config.py
that ``Config.fromfile`` needs, copied (the port imports nothing of the
JAX package).

``.py`` configs are imported as throwaway modules and their module-level
globals harvested, their ``det3d_tpu.config_presets`` imports resolved to
the port's copy (det3d_tpu_torch/config_presets/); ``.json`` files are
parsed. Values are wrapped in ``ConfigDict`` for attribute access.
"""

from __future__ import annotations

import builtins
import importlib.util
import json
import os
import sys
import types
from pathlib import Path
from typing import Any


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'")

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v)
                               for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in (*args, kwargs):
            for k, v in dict(src).items():
                self[k] = ConfigDict._wrap(v)


class Config:
    """The globals of a config file, as a ConfigDict."""

    def __init__(self, cfg_dict: dict | None = None):
        self._cfg_dict = ConfigDict(cfg_dict or {})

    @staticmethod
    def fromfile(filename: str | os.PathLike) -> "Config":
        path = Path(filename).expanduser().resolve()
        if not path.exists():
            raise FileNotFoundError(str(path))
        if path.suffix == ".py":
            cfg_dict = _exec_py_config(path)
        elif path.suffix == ".json":
            cfg_dict = json.loads(path.read_text())
        else:
            raise IOError(f"Only .py/.json configs supported, got "
                          f"{path.suffix}")
        return Config(cfg_dict)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()


# the JAX package's config presets, which a config file may import: the
# port has its own copy under det3d_tpu_torch
_PRESETS = "det3d_tpu.config_presets"


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` of a config file: ``det3d_tpu.config_presets[.*]``
    resolves to the port's copy; any other ``det3d_tpu`` import raises
    (the port imports nothing of the JAX package)."""
    if level == 0 and name.split(".")[0] == "det3d_tpu":
        if name != _PRESETS and not name.startswith(_PRESETS + "."):
            raise ImportError(f"config imports {name!r}: the port has no "
                              "copy of it and imports nothing of det3d_tpu")
        name = "det3d_tpu_torch" + name[len("det3d_tpu"):]
    return builtins.__import__(name, globals, locals, fromlist, level)


def _exec_py_config(path: Path) -> dict:
    """Import the .py config as a throwaway module and harvest its globals.
    The module runs with its own builtins, whose ``__import__`` is
    ``_config_import``; ``sys.modules`` gains no alias."""
    mod_name = f"_det3d_tpu_torch_cfg_{abs(hash(str(path)))}"
    spec = importlib.util.spec_from_file_location(mod_name, str(path))
    mod = importlib.util.module_from_spec(spec)
    mod.__builtins__ = dict(vars(builtins), __import__=_config_import)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("__") and not callable(v)
                and not isinstance(v, types.ModuleType)}
    finally:
        sys.modules.pop(mod_name, None)
