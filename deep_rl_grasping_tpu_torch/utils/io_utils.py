"""YAML configuration reading and writing without PyYAML.

`load_yaml` reads the YAML subset the repo's configs use: block mappings,
block sequences, flow lists and maps (nested), plain and quoted scalars,
and comments. Scalars resolve as PyYAML's `safe_load` resolves them
(YAML 1.1 booleans such as `True`/`yes`, `null`/`~`, ints, and floats that
need a dot, like `1.0e-4`, `0.` or `100.`), so a config reads the same
through either reader. `save_yaml` writes block mappings that both readers
read back to the same tree.
"""

from __future__ import annotations

import os
import re

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        return body.replace("''", "'") if tok[0] == "'" else bytes(
            body, "utf-8").decode("unicode_escape")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return float("-inf") if tok.startswith("-") else float("inf")
    if _NAN.match(tok):
        return float("nan")
    return tok


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is outside quotes and starts a token."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Recursive-descent parser for one flow collection (`[...]`, `{...}`)."""

    def __init__(self, text):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def value(self):
        self._ws()
        ch = self.s[self.i]
        if ch == "[":
            self.i += 1
            out = []
            self._ws()
            if self.s[self.i] == "]":
                self.i += 1
                return out
            while True:
                out.append(self.value())
                self._ws()
                ch = self.s[self.i]
                self.i += 1
                if ch == "]":
                    return out
                if ch != ",":
                    raise ValueError(f"bad flow list near {self.s[:self.i]!r}")
        if ch == "{":
            self.i += 1
            out = {}
            self._ws()
            if self.s[self.i] == "}":
                self.i += 1
                return out
            while True:
                key = self.token(stop=":")
                self.i += 1  # ':'
                out[_scalar(key)] = self.value()
                self._ws()
                ch = self.s[self.i]
                self.i += 1
                if ch == "}":
                    return out
                if ch != ",":
                    raise ValueError(f"bad flow map near {self.s[:self.i]!r}")
        return _scalar(self.token(stop=",]}"))

    def token(self, stop):
        self._ws()
        start = self.i
        if self.s[self.i] in "'\"":
            q = self.s[self.i]
            self.i = self.s.index(q, self.i + 1) + 1
            return self.s[start:self.i]
        while self.i < len(self.s) and self.s[self.i] not in stop:
            self.i += 1
        return self.s[start:self.i].strip()


def _inline(text: str):
    text = text.strip()
    if text[:1] in "[{":
        p = _Flow(text)
        v = p.value()
        if text[p.i:].strip():
            raise ValueError(f"trailing text after flow value: {text!r}")
        return v
    return _scalar(text)


def _split_key(content: str):
    """`key: rest` -> (key, rest) or None when the line is not a mapping entry."""
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            return None
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] in " \t"):
            return content[:i].strip(), content[i + 1:].strip()
    return None


def _parse_block(lines, pos, indent):
    """Parse the block starting at lines[pos] with the given indent."""
    is_seq = lines[pos][1].startswith("- ") or lines[pos][1] == "-"
    out = [] if is_seq else {}
    while pos < len(lines):
        ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"unexpected indent at {content!r}")
        if is_seq:
            if not (content.startswith("- ") or content == "-"):
                break
            rest = content[1:].strip()
            if not rest:
                value, pos = _parse_block(lines, pos + 1, lines[pos + 1][0])
                out.append(value)
                continue
            if _split_key(rest) is not None or rest.startswith("- ") or rest == "-":
                # "- key: value" opens a mapping and "- - x" a sequence,
                # each indented past the dash
                sub_indent = ind + (len(content) - len(rest))
                lines[pos] = (sub_indent, rest)
                value, pos = _parse_block(lines, pos, sub_indent)
                out.append(value)
                continue
            out.append(_inline(rest))
            pos += 1
            continue
        kv = _split_key(content)
        if kv is None:
            raise ValueError(f"expected 'key: value', got {content!r}")
        key, rest = kv
        pos += 1
        if rest:
            out[_scalar(key)] = _inline(rest)
        elif pos < len(lines) and (
            lines[pos][0] > indent
            or (lines[pos][0] == indent and lines[pos][1].startswith("-"))
        ):
            out[_scalar(key)], pos = _parse_block(lines, pos, lines[pos][0])
        else:
            out[_scalar(key)] = None
    return out, pos


def parse_yaml(text: str):
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None and not lines[0][1].startswith("-"):
        return _inline(lines[0][1])
    value, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"could not parse YAML past {lines[pos][1]!r}")
    return value


def load_yaml(file_path):
    with open(os.path.expanduser(file_path), "r") as f:
        return parse_yaml(f.read())



_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _emit_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, _, exp = r.partition("e")
        if "." not in mant:  # YAML 1.1 floats need a dot
            mant += ".0"
        return mant + (f"e{'+' if not exp.startswith('-') else ''}{exp.lstrip('+')}" if exp
                       else "")
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _emit_key(k) -> str:
    k = str(k)
    return k if _PLAIN_KEY.match(k) and _scalar(k) == k else _emit_scalar(k)


def _emit_flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_emit_key(k)}: {_emit_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_flow(x) for x in v) + "]"
    return _emit_scalar(v)


def _emit_block(data, indent, out):
    pad = " " * indent
    for k, v in data.items():
        if isinstance(v, dict) and v:
            out.append(f"{pad}{_emit_key(k)}:")
            _emit_block(v, indent + 2, out)
        else:
            out.append(f"{pad}{_emit_key(k)}: {_emit_flow(v)}")


def dump_yaml(data: dict) -> str:
    out = []
    _emit_block(data, 0, out)
    return "\n".join(out) + "\n"


def save_yaml(data: dict, file_path):
    """Write a config tree (nested dicts; lists, strings, numbers, booleans,
    None) as YAML."""
    with open(os.path.expanduser(file_path), "w") as f:
        f.write(dump_yaml(data))
