"""Name -> class registries with config-dict instantiation.

The port's own copy of det3d_tpu/utils/registry.py (the port imports
nothing of the JAX package).

API parity with the reference registry (reference: det3d/utils/registry.py:6,48):
``Registry.register_module`` decorates a class into the table and
``build_from_cfg({"type": Name, ...}, registry)`` instantiates it. This layer is
pure Python; it carries no device semantics.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, type] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, type]:
        return self._module_dict

    def get(self, key: str) -> Optional[type]:
        return self._module_dict.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def register_module(self, cls: Optional[type] = None, *, name: Optional[str] = None):
        """Register a class. Usable bare (``@R.register_module``) or with a
        custom name (``@R.register_module(name="Alias")``)."""
        if cls is None:
            return lambda c: self._register(c, name)
        return self._register(cls, name)

    def _register(self, cls: type, name: Optional[str] = None) -> type:
        if not inspect.isclass(cls) and not inspect.isfunction(cls):
            raise TypeError(f"module must be a class or function, got {type(cls)}")
        key = name or cls.__name__
        if key in self._module_dict:
            raise KeyError(f"{key} already registered in {self._name}")
        self._module_dict[key] = cls
        return cls


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, default_args: Optional[dict] = None):
    """Instantiate ``registry[cfg["type"]](**cfg_without_type, **default_args)``.

    Mirrors reference det3d/utils/registry.py:48: ``cfg`` must carry a ``type``
    key naming a registered class (or be the class itself).
    """
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
