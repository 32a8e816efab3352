"""Minimal HOCON-subset reader.

The reference drives everything from pyhocon HOCON files
(reference: code/confs/embedder_conf_var/*/dtu_fixed_cameras.conf); pyhocon is
not available here, so this module implements the subset those files use:

  * nested blocks:  ``name { ... }``  (brace may follow the name on the same
    line or the next line)
  * assignments:    ``key = value``
  * comments:       ``#`` and ``//`` (full-line or trailing)
  * values: ints, floats (incl. ``1.0e-4``), bools, lists ``[a, b, c]``,
    bare/quoted strings.

The result is a plain nested ``dict``; :class:`Config` wraps it with the
pyhocon-style accessors the rest of the code uses (``get_int``, ``get_config``,
dotted paths like ``ray_tracer.object_bounding_sphere``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional


def _strip_comment(line: str) -> str:
    # Strip # / // comments, respecting simple quoted strings.
    out = []
    in_quote: Optional[str] = None
    i = 0
    while i < len(line):
        ch = line[i]
        if in_quote:
            out.append(ch)
            if ch == in_quote:
                in_quote = None
        elif ch in "\"'":
            in_quote = ch
            out.append(ch)
        elif ch == "#":
            break
        elif ch == "/" and i + 1 < len(line) and line[i + 1] == "/":
            break
        else:
            out.append(ch)
        i += 1
    return "".join(out)


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [parse_value(t) for t in inner.split(",")]
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    if _NUM_RE.match(tok):
        if re.match(r"^[+-]?\d+$", tok):
            return int(tok)
        return float(tok)
    return tok


def parse_string(text: str) -> Dict[str, Any]:
    """Parse HOCON-subset text into a nested dict."""
    root: Dict[str, Any] = {}
    stack: List[Dict[str, Any]] = [root]
    pending_key: Optional[str] = None  # block name waiting for '{'

    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        while line:
            if pending_key is not None:
                if not line.startswith("{"):
                    raise ValueError(f"expected '{{' after block name {pending_key!r}")
                new: Dict[str, Any] = {}
                stack[-1][pending_key] = new
                stack.append(new)
                pending_key = None
                line = line[1:].strip()
                continue
            if line.startswith("}"):
                if len(stack) == 1:
                    raise ValueError("unbalanced '}'")
                stack.pop()
                line = line[1:].strip()
                continue
            m = re.match(r"^([\w.\-]+)\s*(\{|=|:)\s*(.*)$", line)
            if not m:
                # bare block name, '{' on a later line
                m2 = re.match(r"^([\w.\-]+)\s*$", line)
                if m2:
                    pending_key = m2.group(1)
                    line = ""
                    continue
                raise ValueError(f"cannot parse line: {raw!r}")
            key, sep, rest = m.group(1), m.group(2), m.group(3)
            if sep == "{":
                new = {}
                stack[-1][key] = new
                stack.append(new)
                line = rest.strip()
            else:
                # value may itself open a block: "key = {" is not used by the
                # reference confs; treat rest of line as the value.
                # Trailing '}' tokens may share the line.
                closers = 0
                v = rest.strip()
                while v.endswith("}") and not v.endswith("]}"):
                    # only treat as closer when not inside a bracket expr
                    if v.count("[") == v.count("]"):
                        v = v[:-1].rstrip()
                        closers += 1
                    else:
                        break
                stack[-1][key] = parse_value(v)
                for _ in range(closers):
                    if len(stack) == 1:
                        raise ValueError("unbalanced '}'")
                    stack.pop()
                line = ""
    if len(stack) != 1:
        raise ValueError("unbalanced '{' (unclosed block)")
    return root


class Config:
    """pyhocon-flavoured accessor over a nested dict (dotted-path lookups)."""

    def __init__(self, data: Dict[str, Any]):
        self._data = data

    # -- raw access -------------------------------------------------------
    @property
    def data(self) -> Dict[str, Any]:
        return self._data

    def _lookup(self, path: str, default=..., ):
        node: Any = self._data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                if default is ...:
                    raise KeyError(path)
                return default
            node = node[part]
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self._lookup(path)
            return True
        except KeyError:
            return False

    def __getitem__(self, path: str):
        return self._lookup(path)

    # -- typed accessors (pyhocon API surface used by the reference) ------
    def get(self, path: str, default=None):
        return self._lookup(path, default)

    def get_int(self, path: str, default=...) -> int:
        return int(self._lookup(path, default))

    def get_float(self, path: str, default=...) -> float:
        return float(self._lookup(path, default))

    def get_bool(self, path: str, default=...) -> bool:
        return bool(self._lookup(path, default))

    def get_string(self, path: str, default=...) -> str:
        return str(self._lookup(path, default))

    def get_list(self, path: str, default=...) -> list:
        v = self._lookup(path, default)
        return list(v) if v is not None else v

    def get_config(self, path: str, default=...) -> "Config":
        v = self._lookup(path, default)
        if v is None or v is default and not isinstance(v, dict):
            return v
        if not isinstance(v, dict):
            raise TypeError(f"{path} is not a config block")
        return Config(v)

    def put(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self._data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def copy(self) -> "Config":
        import copy as _copy

        return Config(_copy.deepcopy(self._data))

    def dump(self, indent: int = 0) -> str:
        """Re-serialize to HOCON text (for runconf.conf snapshots)."""
        lines = []
        pad = "    " * indent
        for k, v in self._data.items():
            if isinstance(v, dict):
                lines.append(f"{pad}{k} {{")
                lines.append(Config(v).dump(indent + 1))
                lines.append(f"{pad}}}")
            elif isinstance(v, list):
                lines.append(f"{pad}{k} = [" + ", ".join(str(x) for x in v) + "]")
            elif isinstance(v, bool):
                lines.append(f"{pad}{k} = {str(v)}")
            elif isinstance(v, str):
                lines.append(f"{pad}{k} = {v}")
            else:
                lines.append(f"{pad}{k} = {v}")
        return "\n".join(lines)


def parse_file(path: str) -> Config:
    with open(path, "r") as f:
        return Config(parse_string(f.read()))


def parse(text: str) -> Config:
    return Config(parse_string(text))
