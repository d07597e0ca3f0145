"""Minimal OmegaConf-style config: YAML file merged with dotlist overrides.

The port's copy of ``dreamgaussian_tpu/utils/config.py``, without PyYAML.
It reads the YAML subset that ``configs/*.yaml`` are written in, and
parses each dotlist value with the same scalar rules:

- flat ``key: value`` lines, blank lines and ``#`` comments;
- an empty value and ``null`` are None; ``True``/``False`` (or
  lower-case) are booleans; decimal ints; floats, also with a dotless
  exponent (``1e-3``, a string to YAML 1.1); any other plain text is a
  string;
- single- and double-quoted strings without escapes;
- flat lists of plain scalars (``[32, 64]``).

Anything else (nested or indented blocks, block lists, flow maps,
anchors, tags, escapes, octal or hex ints, dates) raises ValueError
rather than being read some other way.
"""

from __future__ import annotations

import re
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


_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+|[0-9]+(?=[eE]))(?:[eE][-+]?[0-9]+)?")
# A plain scalar that starts with one of YAML's indicators, or holds a
# mapping's ': ', is not a flat scalar.
_INDICATOR = re.compile(r"[\[\]{}&*!|>%@`,#'\"]|[-?:](?:\s|$)|.*(?::\s|:$)")
_COMMENT = re.compile(r"(?:^|\s+)#.*")
_KEY_LINE = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*):(?:[ \t]+(.*))?")


def _plain(text: str) -> Any:
    """A plain (unquoted) scalar of the subset."""
    if text in ("", "null"):
        return None
    if text in ("True", "true", "False", "false"):
        return text in ("True", "true")
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    # Octal, hex, sexagesimal, dates: numbers or dates to YAML, none here.
    if re.match(r"[-+.]?[0-9]", text) or _INDICATOR.match(text):
        raise ValueError(f"{text!r} is outside the YAML subset that configs are read in")
    return text


def parse_scalar(text: str) -> Any:
    """One value of the subset (see the module docstring), with its
    trailing comment. Used for file values and dotlist values alike."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        end = text.find(text[0], 1)
        rest = text[end + 1:].strip() if end > 0 else ""
        if end < 0 or rest[:1] not in ("", "#") or text[0] == '"' and "\\" in text[:end]:
            raise ValueError(f"{text!r}: quoted strings are read without escapes")
        return text[1:end]
    text = _COMMENT.sub("", text)
    if text[:1] == "[" and text.endswith("]"):
        items = [t.strip() for t in text[1:-1].split(",")] if text[1:-1].strip() else []
        if any(not t or t[0] in "'\"" or _INDICATOR.match(t) for t in items):
            raise ValueError(f"{text!r}: lists hold plain scalars only")
        return [_plain(t) for t in items]
    return _plain(text)


def parse_yaml(text: str, source: str = "<string>") -> dict:
    """The flat mapping of a YAML document in the subset."""
    out: dict = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        m = _KEY_LINE.fullmatch(line.rstrip())
        if m is None:
            raise ValueError(f"{source}:{n}: {line!r} is not a flat 'key: value' line "
                             "(the YAML subset that configs are read in)")
        try:
            out[m.group(1)] = parse_scalar(m.group(2) or "")
        except ValueError as e:
            raise ValueError(f"{source}:{n}: {e}") from None
    return out


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
        _set_dotted(cfg, key.strip(), parse_scalar(value))
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
    with open(path, "r") as f:
        return _wrap(parse_yaml(f.read(), path))


def load_with_cli(path: str, cli_args: Iterable[str] = ()) -> Config:
    return merge(load(path), from_cli(cli_args))
