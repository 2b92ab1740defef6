"""A reader (and a writer) for the subset of YAML that the repository's
config files use, without PyYAML.

The port reads ``configs.yml`` (``--config-file``) and the DLRM feature spec
(``feature_spec.yaml``), which the JAX package reads with
``yaml.safe_load`` and writes with ``yaml.safe_dump``. This module is the
only YAML code of the port, on every machine, so the CPU tests exercise the
code that runs beside the card.

What it reads: block mappings nested by indentation (spaces), ``#``
comments, and plain scalars, resolved as PyYAML's ``SafeLoader`` resolves
them (YAML 1.1: ``true``/``yes``/``on`` and their opposites are bools,
``null``/``~``/nothing is None, decimal ints, floats only with a dot and, if
any, a signed exponent: ``1.0e-05`` is a float but ``1e-5`` and ``1.0e5``
stay strings). Everything else raises ``YamlSubsetError`` naming the line:
quoted scalars, flow collections, anchors, aliases, tags, block sequences,
block scalars, complex keys, merge keys, directives and multi-document
files, and the plain scalars PyYAML gives another type that this reader
does not build (octal, hex, binary and sexagesimal numbers, timestamps).
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YamlSubsetError", "dump", "load", "loads"]


class YamlSubsetError(ValueError):
    """Text outside the subset (or malformed), with its line number."""


# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
     (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# characters that may not start a plain scalar here (flow, anchor, alias,
# tag, block scalar, quote, reserved, directive, complex key)
_INDICATORS = "[]{},&*!|>'\"@`%?"


def _fail(lineno: int, what: str) -> None:
    raise YamlSubsetError(f"line {lineno}: {what} is outside the YAML subset "
                          "this reader takes")


def _plain(text: str, lineno: int) -> Any:
    """A plain scalar, resolved as PyYAML's SafeLoader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        if not _DECIMAL.match(text):
            _fail(lineno, f"the octal, hex, binary or sexagesimal int {text!r}")
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if ":" in v:
            _fail(lineno, f"the sexagesimal float {text!r}")
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if _TIMESTAMP.match(text):
        _fail(lineno, f"the timestamp {text!r}")
    if text in ("<<", "="):
        _fail(lineno, f"the {text!r} key")
    if text[0] in _INDICATORS or text.startswith(("- ", "-\t")) or text == "-":
        _fail(lineno, f"{text!r} (a quoted scalar, flow collection, anchor, "
              "alias, tag, block sequence or block scalar)")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(lineno, f"the plain scalar {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """The line without its ``#`` comment (one that starts the line or
    follows whitespace), and without trailing spaces."""
    m = re.search(r"(^|[ \t])#", line)
    return (line[:m.start()] if m else line).rstrip()


def _split_key(body: str, lineno: int) -> tuple[str, str | None]:
    """``key: value`` or ``key:`` -> (key text, value text or None)."""
    idx = body.find(": ")
    if idx == -1:
        if body.endswith(":"):
            return body[:-1].rstrip(), None
        _fail(lineno, f"{body!r} (not a 'key: value' line)")
    return body[:idx].rstrip(), body[idx + 2:].strip() or None


def loads(text: str) -> Any:
    """The document in ``text``: a dict of dicts and scalars, one scalar,
    or None for an empty document, as ``yaml.safe_load`` gives it."""
    lines: list[tuple[int, int, str]] = []  # (line number, indent, body)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if raw.startswith(("---", "...", "%")):
            _fail(lineno, f"{raw.strip()!r} (a directive or document marker: "
                  "one document only)")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent] == "\t":
            _fail(lineno, "a tab in the indentation")
        lines.append((lineno, indent, body[indent:]))
    if not lines:
        return None
    first = lines[0]
    if len(lines) == 1 and not re.search(r"(^|[^:]): |:$", first[2]):
        return _plain(first[2], first[0])
    value, end = _mapping(lines, 0, first[1])
    if end != len(lines):
        _fail(lines[end][0], "a line indented less than the document's first")
    return value


def _mapping(lines, start: int, indent: int) -> tuple[dict, int]:
    """The block mapping whose keys sit at ``indent``, from ``lines[start]``;
    returns it and the index of the first line after it."""
    out: dict = {}
    i = start
    while i < len(lines):
        lineno, ind, body = lines[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "an indentation that opens no mapping")
        if body.startswith(("- ", "-\t")) or body == "-":
            _fail(lineno, "a block sequence")
        if body[0] in _INDICATORS:
            _fail(lineno, f"{body!r} (a quoted or complex key, a flow "
                  "collection, anchor, alias or tag)")
        key_text, value_text = _split_key(body, lineno)
        key = _plain(key_text, lineno)
        i += 1
        if value_text is not None:
            out[key] = _plain(value_text, lineno)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _mapping(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def load(path: str) -> Any:
    """``loads`` of the file at ``path``."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


def dump(data: dict) -> str:
    """``yaml.safe_dump(data)``'s text for a dict nested of dicts, with str
    keys and int or str values that PyYAML writes plain: keys sorted,
    two spaces an indent. Raises ``YamlSubsetError`` for anything else."""
    out: list[str] = []

    def plain_ok(s: str) -> bool:
        try:
            return bool(s) and s == s.strip() and _plain(s, 0) == s and (
                s[0] not in "-#" and "'" not in s and '"' not in s)
        except YamlSubsetError:
            return False

    def walk(d: dict, depth: int) -> None:
        for key in sorted(d):
            if not isinstance(key, str) or not plain_ok(key):
                raise YamlSubsetError(f"key {key!r} needs more than a plain "
                                      "scalar")
            v = d[key]
            pad = "  " * depth
            if isinstance(v, dict):
                if not v:
                    raise YamlSubsetError(f"empty mapping under {key!r}")
                out.append(f"{pad}{key}:")
                walk(v, depth + 1)
            elif isinstance(v, int) and not isinstance(v, bool):
                out.append(f"{pad}{key}: {v}")
            elif isinstance(v, str) and plain_ok(v):
                out.append(f"{pad}{key}: {v}")
            else:
                raise YamlSubsetError(f"value {v!r} of {key!r} needs more "
                                      "than a plain int or str")

    walk(data, 0)
    return "".join(line + "\n" for line in out)
