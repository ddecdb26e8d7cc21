"""Config system: YAML merge, dotlist overrides and attribute access — port
of `sgam_neurips22_tpu/core/config.py`.

The reference merges a list of YAMLs left to right, then applies CLI
`a.b.c=value` overrides, and instantiates `target:` / `params:` nodes. The
schema is the reference's, so its config files load as they are;
instantiation goes through the registry (`core/registry.py`).
"""
from __future__ import annotations

import copy
from typing import Any, Iterable, Mapping

import yaml


class ConfigDict(dict):
    """A dict with attribute access and recursive wrapping (the subset of
    OmegaConf the reference relies on)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, wrap(value))

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigDict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = value

    def to_plain(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Mapping):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def copy(self) -> "ConfigDict":  # type: ignore[override]
        return wrap(copy.deepcopy(self.to_plain()))


def wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        out = ConfigDict()
        for k, v in value.items():
            out[k] = v
        return out
    if isinstance(value, list):
        return [wrap(v) for v in value]
    return value


def load_yaml(path: str) -> ConfigDict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return wrap(data or {})


def merge(*configs: Mapping) -> ConfigDict:
    """Recursive merge, later configs winning (OmegaConf.merge)."""
    out = ConfigDict()
    for cfg in configs:
        _merge_into(out, cfg)
    return out


def _merge_into(dst: ConfigDict, src: Mapping) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], ConfigDict) and isinstance(v, Mapping):
            _merge_into(dst[k], v)
        else:
            dst[k] = v


def _parse_value(text: str) -> Any:
    """A CLI override's value with YAML typing (numbers, bools, null, lists)."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def apply_dotlist(cfg: ConfigDict, dotlist: Iterable[str]) -> ConfigDict:
    """Apply `a.b.c=value` overrides."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of form key=value")
        key, value = item.split("=", 1)
        cfg.set_path(key.strip(), _parse_value(value))
    return cfg


def load_configs(paths: Iterable[str], overrides: Iterable[str] = ()) -> ConfigDict:
    """Left-to-right YAML merge, then the dotlist overrides."""
    cfg = merge(*[load_yaml(p) for p in paths])
    return apply_dotlist(cfg, overrides)


def save_yaml(cfg: Mapping, path: str) -> None:
    plain = cfg.to_plain() if isinstance(cfg, ConfigDict) else dict(cfg)
    with open(path, "w") as f:
        yaml.safe_dump(plain, f, sort_keys=False)
