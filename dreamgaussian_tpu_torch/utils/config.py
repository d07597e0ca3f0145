"""Minimal OmegaConf-style config: YAML file merged with dotlist overrides.

The port's copy of ``dreamgaussian_tpu/utils/config.py``. ``yaml`` is
imported only by the functions that parse YAML, so the module imports on
a machine without PyYAML (a trainer built from a Python dict needs none).
"""

from __future__ import annotations

from typing import Any, Iterable

MANDATORY = "???"


class Config(dict):
    """A dict with attribute access and mandatory-field checking."""

    def __getattr__(self, key: str) -> Any:
        try:
            value = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(value, str) and value == MANDATORY:
            raise ValueError(f"config field '{key}' is mandatory but unset (???)")
        return value

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get(self, key: str, default: Any = None) -> Any:  # attr-consistent get
        value = super().get(key, default)
        if isinstance(value, str) and value == MANDATORY:
            return default
        return value


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _parse_value(text: str) -> Any:
    """YAML-parse a CLI value ('true' -> bool, '1e-3' -> float, ...)."""
    import yaml

    if text == "":
        return None
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        # YAML 1.1 doesn't parse dotless scientific notation ('1e-3').
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if not isinstance(node.get(k), dict):
            node[k] = Config()
        node = node[k]
    node[keys[-1]] = value


def from_cli(args: Iterable[str]) -> Config:
    """Parse a dotlist ['a=1', 'b.c=2'] into a nested Config."""
    cfg = Config()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"CLI override must look like key=value, got: {arg!r}")
        key, _, value = arg.partition("=")
        _set_dotted(cfg, key.strip(), _parse_value(value.strip()))
    return cfg


def merge(*configs: dict) -> Config:
    """Deep-merge configs left-to-right (rightmost wins)."""
    out: Config = Config()
    for cfg in configs:
        for k, v in cfg.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge(out[k], v)
            else:
                out[k] = _wrap(v)
    return out


def load(path: str) -> Config:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config root must be a mapping: {path}")
    return _wrap(data)


def load_with_cli(path: str, cli_args: Iterable[str] = ()) -> Config:
    return merge(load(path), from_cli(cli_args))
