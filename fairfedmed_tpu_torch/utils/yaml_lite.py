"""A small YAML reader and writer for the config files, with no PyYAML.

It reads the subset of YAML that the files under ``configs/`` use: nested
block mappings, block and flow lists (``[a, b]``), quoted and bare scalars,
blank lines and ``#`` comments.  Scalars resolve as PyYAML's ``safe_load``
resolves them (YAML 1.1): ``1e-5`` has no dot and stays the string ``'1e-5'``,
``yes``/``off`` are booleans, ``~`` and ``null`` are None, ``0o17``-style
octal is not an int but ``017`` is.  Anything else (anchors, aliases, tags,
block scalars, flow mappings, several documents) raises ``YamlError`` naming
the file and line; the reader never guesses.

``dump`` writes a plain tree (dicts, lists, scalars) back as YAML that both
this reader and ``yaml.safe_load`` read to the same tree.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
# PyYAML's implicit resolvers (resolver.py), without the sexagesimal forms,
# which raise instead
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"'}
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+|$)(.*)$")


class YamlError(ValueError):
    """Input outside the supported subset, with its file and line."""

    def __init__(self, msg: str, filename: str = "<string>", line: int = 0):
        super().__init__(f"{filename}:{line}: {msg}")


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def resolve_scalar(text: str, filename: str = "<string>", line: int = 0) -> Any:
    """A bare (unquoted) scalar as ``yaml.safe_load`` types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if _SEXAGESIMAL.match(text):
        raise YamlError(f"sexagesimal number {text!r} is not supported", filename, line)
    if text[0] in "&*!|>%@`{":
        raise YamlError(f"unsupported YAML syntax {text!r}", filename, line)
    if ": " in text or text.endswith(":"):
        raise YamlError(f"a mapping is not allowed here: {text!r}", filename, line)
    return text


def _strip_comment(text: str) -> str:
    """Drop a ``#`` comment that starts a line or follows a space, outside
    quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _quoted(text: str, filename: str, line: int) -> Tuple[str, int]:
    """The quoted scalar at the start of ``text`` and the index after it."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise YamlError(f"unsupported escape \\{esc}", filename, line)
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlError(f"unterminated quoted scalar {text!r}", filename, line)


def _flow_list(text: str, filename: str, line: int) -> list:
    """``[a, 'b', [c]]`` -> a list, scalars resolved."""
    items: List[Any] = []
    i = 1
    expect_item = True
    while True:
        while i < len(text) and text[i] in " \t":
            i += 1
        if i >= len(text):
            raise YamlError(f"unterminated flow list {text!r}", filename, line)
        ch = text[i]
        if ch == "]":
            if len(text[i + 1:].strip()):
                raise YamlError(f"text after a flow list: {text!r}", filename, line)
            return items
        if ch == ",":
            if expect_item:
                raise YamlError(f"empty item in flow list {text!r}", filename, line)
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise YamlError(f"missing ',' in flow list {text!r}", filename, line)
        if ch in "'\"":
            value, n = _quoted(text[i:], filename, line)
            i += n
        elif ch == "[":
            depth, j = 0, i
            while j < len(text):
                depth += {"[": 1, "]": -1}.get(text[j], 0)
                if depth == 0:
                    break
                j += 1
            value, i = _flow_list(text[i:j + 1], filename, line), j + 1
        elif ch == "{":
            raise YamlError("flow mappings are not supported", filename, line)
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            value, i = resolve_scalar(text[i:j].strip(), filename, line), j
        items.append(value)
        expect_item = False


def parse_value(text: str, filename: str = "<string>", line: int = 0) -> Any:
    """One inline value: a flow list, a quoted scalar or a bare scalar."""
    text = _strip_comment(text).strip()
    if text.startswith("["):
        return _flow_list(text, filename, line)
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, filename, line)
        if text[end:].strip():
            raise YamlError(f"text after a quoted scalar: {text!r}", filename, line)
        return value
    return resolve_scalar(text, filename, line)


def loads(text: str, filename: str = "<string>") -> Any:
    """A YAML document -> nested dicts/lists/scalars (None when empty)."""
    lines = []  # (line number, indent, content)
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError("tab in indentation", filename, no)
        content = _strip_comment(raw)
        if not content.strip():
            continue
        if content.strip() in ("---", "..."):
            if lines:
                raise YamlError("several documents are not supported", filename, no)
            continue
        lines.append((no, len(content) - len(content.lstrip()), content.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][1], filename)
    if pos != len(lines):
        no = lines[pos][0]
        raise YamlError("unexpected indentation", filename, no)
    return value


def _block(lines, pos, indent, filename):
    """The mapping or list whose items start at ``indent``."""
    no, _, content = lines[pos]
    if content == "-" or content.startswith("- "):
        return _block_list(lines, pos, indent, filename)
    if _KEY.match(content):
        return _block_map(lines, pos, indent, filename)
    if len(lines) == 1:
        return parse_value(content, filename, no), pos + 1
    raise YamlError(f"expected a mapping or a list: {content!r}", filename, no)


def _child(lines, pos, indent, filename):
    """The nested block after a ``key:`` or ``-`` with nothing inline."""
    if pos < len(lines) and lines[pos][1] > indent:
        return _block(lines, pos, lines[pos][1], filename)
    return None, pos


def _block_map(lines, pos, indent, filename):
    out = {}
    while pos < len(lines) and lines[pos][1] == indent:
        no, _, content = lines[pos]
        m = _KEY.match(content)
        if not m:
            raise YamlError(f"expected 'key: value': {content!r}", filename, no)
        key, rest = m.group(1), m.group(2)
        if key in out:
            raise YamlError(f"duplicate key {key!r}", filename, no)
        if rest:
            out[key] = parse_value(rest, filename, no)
            pos += 1
        else:
            out[key], pos = _child(lines, pos + 1, indent, filename)
    if pos < len(lines) and lines[pos][1] > indent:
        raise YamlError("unexpected indentation", filename, lines[pos][0])
    return out, pos


def _block_list(lines, pos, indent, filename):
    out = []
    while pos < len(lines) and lines[pos][1] == indent:
        no, _, content = lines[pos]
        if not (content == "-" or content.startswith("- ")):
            raise YamlError(f"expected a list item: {content!r}", filename, no)
        rest = content[1:].strip()
        if not rest:
            value, pos = _child(lines, pos + 1, indent, filename)
            out.append(value)
            continue
        if _KEY.match(rest):
            raise YamlError("mappings inside list items are not supported", filename, no)
        out.append(parse_value(rest, filename, no))
        pos += 1
    return out, pos


# --------------------------------------------------------------------------- #
# writing
# --------------------------------------------------------------------------- #

def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text and "e" in text:  # YAML 1.1 floats need a dot
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump(tree: dict) -> str:
    """A plain nested dict -> YAML text, keys sorted, lists as flow lists."""
    out: List[str] = []

    def inline(v):
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(inline(x) for x in v) + "]"
        return _scalar_text(v)

    def rec(node, indent):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                if not v:  # would need a flow mapping, which the reader refuses
                    raise TypeError(f"cannot write the empty mapping {k!r}")
                out.append(f"{' ' * indent}{k}:")
                rec(v, indent + 2)
            else:
                out.append(f"{' ' * indent}{k}: {inline(v)}")

    rec(tree, 0)
    return "\n".join(out) + "\n"
