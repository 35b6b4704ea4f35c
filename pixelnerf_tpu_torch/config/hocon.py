"""Minimal HOCON reader, API-compatible with the subset of pyhocon the
reference uses (conf.get_bool/get_int/get_float/get_string/get_list with
defaults, nested subtrees, ``include required("...")`` inheritance).

The port keeps its own copy of the JAX package's reader
(``pixelnerf_tpu/config/hocon.py``) so that it imports nothing of that
package; pyhocon is not a dependency, so the needed subset is parsed here and
all shipped reference-style .conf files load unchanged.

Supported syntax: ``#``/``//`` comments, ``key = value``, ``key { ... }``
blocks (recursively merged on duplicate), ``include required("path")``
relative to the including file, booleans / ints / floats / quoted or bare
strings / (nested) lists.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Any, Iterator, Optional, Tuple


class ConfigNode(dict):
    """A nested config dict with typed getters (pyhocon-like)."""

    _MISSING = object()

    def __getitem__(self, key: str) -> Any:
        cur: Any = self
        for part in key.split("."):
            cur = dict.__getitem__(cur, part)
        return cur

    def _get(self, key: str, default: Any) -> Any:
        try:
            return self[key]
        except KeyError:
            if default is ConfigNode._MISSING:
                raise
            return default

    def get(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        return self._get(key, default)

    def get_bool(self, key: str, default: Any = _MISSING) -> bool:
        v = self._get(key, default)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_int(self, key: str, default: Any = _MISSING) -> int:
        return int(self._get(key, default))

    def get_float(self, key: str, default: Any = _MISSING) -> float:
        return float(self._get(key, default))

    def get_string(self, key: str, default: Any = _MISSING) -> Optional[str]:
        v = self._get(key, default)
        return v if v is None else str(v)

    def get_list(self, key: str, default: Any = _MISSING) -> Optional[list]:
        v = self._get(key, default)
        return v if v is None or isinstance(v, list) else list(v)

    def get_config(self, key: str, default: Any = _MISSING) -> "ConfigNode":
        v = self._get(key, default)
        return v if isinstance(v, ConfigNode) or v is default else ConfigNode(v)

    def merge(self, other: "ConfigNode") -> "ConfigNode":
        """Recursively merge ``other`` over ``self`` (other wins)."""
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) and isinstance(v, dict):
                dict.__getitem__(self, k).merge(v)
            else:
                dict.__setitem__(self, k, v)
        return self


_COMMENT_RE = re.compile(r"(?<!:)(#|//).*$")
_INCLUDE_RE = re.compile(r'^\s*include\s+required\(\s*"(.+?)"\s*\)\s*$')
_KV_RE = re.compile(r"^\s*([\w.\-]+)\s*[=:]\s*(.*?)\s*,?\s*$")
_BLOCK_RE = re.compile(r"^\s*([\w.\-]+)\s*\{\s*$")


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            inner = text.strip()[1:-1].strip()
            if not inner:
                return []
            return [_parse_value(t) for t in inner.split(",")]
    if text.startswith(('"', "'")):
        return ast.literal_eval(text)
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _strip(line: str) -> str:
    """Remove #/// comments, respecting quoted strings."""
    if '"' not in line and "'" not in line:
        return _COMMENT_RE.sub("", line).strip()
    out = []
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            out.append(ch)
        elif ch == "#" or line[i : i + 2] == "//":
            break
        else:
            out.append(ch)
        i += 1
    return "".join(out).strip()


def _parse_lines(lines: Iterator[Tuple[int, str]], base_dir: str) -> ConfigNode:
    node = ConfigNode()
    for lineno, raw in lines:
        line = _strip(raw)
        if not line:
            continue
        if line == "}":
            return node
        m = _INCLUDE_RE.match(line)
        if m:
            # HOCON later-wins: the include overrides keys parsed before it;
            # keys after the include override the included tree (they land
            # via setitem / block-merge below).
            inc = load_config(os.path.join(base_dir, m.group(1)))
            node.merge(inc)
            continue
        m = _BLOCK_RE.match(line)
        if m:
            child = _parse_lines(lines, base_dir)
            key = m.group(1)
            if key in node and isinstance(node.get(key), ConfigNode):
                dict.__getitem__(node, key).merge(child)
            else:
                dict.__setitem__(node, key, child)
            continue
        m = _KV_RE.match(line)
        if m:
            key, val = m.group(1), m.group(2)
            if val == "{":
                # HOCON merges duplicate keys when both values are objects,
                # for every syntax form ('key {', 'key = {', 'key: {')
                child = _parse_lines(lines, base_dir)
                if key in node and isinstance(node.get(key), ConfigNode):
                    dict.__getitem__(node, key).merge(child)
                else:
                    dict.__setitem__(node, key, child)
            else:
                dict.__setitem__(node, key, _parse_value(val))
            continue
        raise ValueError(f"Cannot parse config line {lineno}: {raw!r}")
    return node


def parse_string(text: str, base_dir: str = ".") -> ConfigNode:
    return _parse_lines(iter(enumerate(text.splitlines(), 1)), base_dir)


def load_config(path: str) -> ConfigNode:
    with open(path, "r") as f:
        text = f.read()
    return parse_string(text, os.path.dirname(os.path.abspath(path)))
