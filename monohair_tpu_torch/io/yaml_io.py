"""The subset of YAML that the stage configs use, read and written without
PyYAML, so that the stage CLIs import nothing outside torch, numpy and scipy.

What is read: block mappings by indentation, block sequences of scalars,
flow sequences of scalars (`[1920, 1080]`), comments, and plain or quoted
scalars resolved as PyYAML's safe loader resolves them (YAML 1.1: null, bool,
decimal int, float, else str). Anything else (anchors, flow mappings, multi-line
scalars, documents, octal or hex ints) raises ValueError instead of being read
another way. What is written is read back the same by both readers; for the
repository's configs it is byte for byte what yaml.safe_dump(d,
default_flow_style=False, indent=4) writes.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# ints in other bases and sexagesimal numbers: PyYAML reads them as ints
_OTHER_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                        r"|[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# strings yaml.safe_dump writes unquoted (a conservative subset of its rule)
_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./~][A-Za-z0-9_./~+ -]*(?<! )$")


def _resolve(text: str) -> Any:
    """A plain scalar's value."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _OTHER_INT.match(text):
        raise ValueError(f"unsupported YAML int {text!r}")
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if ":" in t:
            raise ValueError(f"unsupported YAML float {text!r}")
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        return math.nan if t == ".nan" else float(t)
    if text[0] in "&*!|>%@`{" or ": " in text or text.endswith(":"):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


def _quoted(text: str) -> Tuple[str, str]:
    """A quoted scalar at the start of `text` -> (value, what follows it)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}
            nxt = text[i + 1:i + 2]
            if nxt not in esc:
                raise ValueError(f"unsupported YAML escape in {text!r}")
            out.append(esc[nxt])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise ValueError(f"unterminated YAML string {text!r}")


def _no_trailer(rest: str, text: str) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"unexpected text after a YAML value: {text!r}")


def _strip_comment(text: str) -> str:
    at = text.find(" #")
    return (text if at < 0 else text[:at]).strip()


def parse_scalar(text: str) -> Any:
    """One value as yaml.safe_load reads it: a scalar, a flow sequence of
    scalars or an empty mapping, with an optional trailing comment."""
    text = text.strip()
    if text.startswith("#"):
        return None
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text)
        _no_trailer(rest, text)
        return value
    if text.startswith("{}"):
        _no_trailer(text[2:], text)
        return {}
    if text.startswith("["):
        end = text.find("]")
        if end < 0 or "[" in text[1:end] or "{" in text[1:end]:
            raise ValueError(f"unsupported YAML sequence {text!r}")
        _no_trailer(text[end + 1:], text)
        inner = text[1:end].strip()
        return [parse_scalar(x) for x in inner.split(",")] if inner else []
    return _resolve(_strip_comment(text))


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if body in ("---", "...") or body.startswith("%"):
            raise ValueError(f"unsupported YAML line {raw!r}")
        out.append((len(raw) - len(raw.lstrip(" ")), body))
    return out


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The mapping or sequence whose lines start at lines[i], indented `indent`."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        items = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1][:1] == "-":
            body = lines[i][1][1:].strip()
            if not body or body.startswith("- ") or ": " in body or body.endswith(":"):
                raise ValueError(f"unsupported YAML sequence item {lines[i][1]!r}")
            items.append(parse_scalar(body))
            i += 1
        return items, i
    out = {}
    while i < len(lines) and lines[i][0] >= indent:
        ind, body = lines[i]
        if ind > indent:
            raise ValueError(f"bad YAML indentation at {body!r}")
        key, sep, rest = body.partition(":")
        if not sep or (rest and rest[0] != " ") or key[:1] in "'\"-[{?":
            raise ValueError(f"unsupported YAML line {body!r}")
        key = key.strip()
        if key in out:
            raise ValueError(f"duplicate YAML key {key!r}")
        i += 1
        if parse_scalar(rest) is None and not _strip_comment(rest) and i < len(lines) and (
                lines[i][0] > ind or (lines[i][0] == ind and lines[i][1][:1] == "-")):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = parse_scalar(rest) if rest.strip() else None
    return out, i


def load_yaml(text: str) -> Any:
    """A document of the subset -> dict (None for an empty document)."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"bad YAML indentation at {lines[i][1]!r}")
    return value


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and _resolve(v) == v:
            return v
        if any(not c.isprintable() for c in v):
            raise ValueError(f"cannot write {v!r} in the YAML subset")
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write a {type(v).__name__} in the YAML subset")


def dump_yaml(d: dict, indent: int = 0) -> str:
    """yaml.safe_dump(d, default_flow_style=False, indent=4) for a mapping of
    scalars, lists of scalars and such mappings."""
    pad = " " * indent
    out = []
    for key in sorted(d):
        v = d[key]
        if isinstance(v, dict):
            out.append(f"{pad}{key}:\n{dump_yaml(v, indent + 4)}" if v else f"{pad}{key}: {{}}\n")
        elif isinstance(v, (list, tuple)):
            if any(isinstance(x, (dict, list, tuple)) for x in v):
                raise TypeError(f"cannot write nested sequences in the YAML subset ({key})")
            out.append(f"{pad}{key}:\n" + "".join(f"{pad}- {_scalar_text(x)}\n" for x in v)
                       if v else f"{pad}{key}: []\n")
        else:
            out.append(f"{pad}{key}: {_scalar_text(v)}\n")
    return "".join(out)
