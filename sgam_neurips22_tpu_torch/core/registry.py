"""Registry-based instantiation of YAML `target:` nodes — port of
`sgam_neurips22_tpu/core/registry.py`.

A target is a plain string key: the config files' own names
(`sgam_neurips22_tpu.VQModel`, ...) and the reference's dotted import
paths map to the port's factory functions, which register themselves
(`targets.py`, `training/data/datamodule.py`). Resolving a target imports
nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str, *aliases: str) -> Callable[[Callable], Callable]:
    def deco(fn: Callable) -> Callable:
        for key in (name, *aliases):
            if key in _REGISTRY and _REGISTRY[key] is not fn:
                raise KeyError(f"registry name collision: {key}")
            _REGISTRY[key] = fn
        return fn

    return deco


def get(name: str) -> Callable[..., Any]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown target {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def instantiate_from_config(cfg: Mapping, **extra: Any) -> Any:
    """The object a `{target: ..., params: {...}}` node describes."""
    if "target" not in cfg:
        raise KeyError("expected `target` key in config node")
    params = dict(cfg.get("params") or {})
    params.update(extra)
    return get(cfg["target"])(**params)


def known_targets() -> list[str]:
    return sorted(_REGISTRY)
