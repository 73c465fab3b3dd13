"""A reader of the YAML subset the experiment configs use, without pyyaml.

The card's machine has no pyyaml, so the port parses ``configs/**/*.yaml``
itself. The subset: block mappings and block lists (a list may sit at its
key's indent), flow mappings ``{...}`` and flow lists ``[...]`` (nested,
over several lines, with a trailing comma), single- and double-quoted
and plain scalars, and comments. Plain scalars resolve as pyyaml's
``safe_load`` resolves them (YAML 1.1): null (``~``, ``null``, empty),
bools (``true``/``yes``/``on`` and their opposites, in three cases), ints
(decimal, ``0x``, ``0b``, leading-zero octal, ``_`` separators) and floats
(a dot required, an exponent signed; ``.inf``, ``.nan``); anything else is
a string. Block scalars (``|``, ``>``), anchors, aliases, tags and
multi-document streams raise ValueError.
"""
from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as safe_load types it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v == ".nan":
            return float("nan")
        return float(v)
    if text[0] in "&*!|>%@`" or text == "---":
        raise ValueError(f"YAML feature outside the supported subset: "
                         f"{text!r}")
    return text


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after)."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if s[j + 1: j + 2] == "'":          # '' is an escaped quote
                j += 2
                continue
            return s[i + 1: j].replace("''", "'"), j + 1
        if q == '"':
            if s[j] == "\\":
                j += 2
                continue
            if s[j] == '"':
                return json.loads(s[i: j + 1]), j + 1
        j += 1
    raise ValueError(f"unterminated quoted scalar: {s[i:]!r}")


def _scan(text: str):
    """(index, char) of ``text``'s characters outside quoted scalars (a
    quote opens at the start or after a blank or an indicator)."""
    j, n = 0, len(text)
    while j < n:
        ch = text[j]
        if ch in "'\"" and (j == 0 or text[j - 1] in " \t:[{,-"):
            try:
                j = _quoted(text, j)[1]
            except ValueError:
                return                    # unterminated: no comment after
            continue
        yield j, ch
        j += 1


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at its start or after blank,
    outside quotes."""
    for j, ch in _scan(line):
        if ch == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j]
    return line


def _depth(text: str) -> int:
    """Open flow brackets left unclosed by ``text`` (outside quotes)."""
    depth = 0
    for _, ch in _scan(text):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


class _Flow:
    """Recursive descent over one flow collection's text."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, ch: str):
        if self.peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.s[self.i:]!r}")
        self.i += 1

    def scalar(self, stops: str) -> Any:
        self.ws()
        if self.peek() in "'\"":
            v, self.i = _quoted(self.s, self.i)
            return v
        j = self.i
        while j < len(self.s) and self.s[j] not in stops \
                and not (self.s[j] == ":" and (j + 1 == len(self.s)
                                               or self.s[j + 1] in " ,]}")):
            j += 1
        text, self.i = self.s[self.i: j].strip(), j
        return resolve_plain(text)

    def value(self) -> Any:
        ch = self.peek()
        if ch == "{":
            return self.mapping()
        if ch == "[":
            return self.sequence()
        return self.scalar(",]}")

    def mapping(self) -> dict:
        self.expect("{")
        out = {}
        while self.peek() != "}":
            key = self.scalar(",}")
            if self.peek() == ":":
                self.i += 1
                out[key] = self.value()
            else:
                out[key] = None
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise ValueError(f"expected ',' or '}}' at "
                                 f"{self.s[self.i:]!r}")
        self.i += 1
        return out

    def sequence(self) -> list:
        self.expect("[")
        out = []
        while self.peek() != "]":
            out.append(self.value())
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise ValueError(f"expected ',' or ']' at "
                                 f"{self.s[self.i:]!r}")
        self.i += 1
        return out


def _inline(text: str) -> Any:
    """A value written on its key's (or list item's) line."""
    if text[:1] in "{[":
        f = _Flow(text)
        v = f.value()
        if f.peek():
            raise ValueError(f"trailing text after a flow collection: "
                             f"{text!r}")
        return v
    if text[:1] in "'\"":
        v, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after a quoted scalar: {text!r}")
        return v
    return resolve_plain(text)


def _split_key(text: str) -> Tuple[Any, str]:
    """'key: value' -> (key, value text); raises if there is no key."""
    if text[:1] in "'\"":
        key, j = _quoted(text, 0)
        rest = text[j:].lstrip()
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after the key in {text!r}")
        return key, rest[1:].strip()
    m = re.search(r":(\s|$)", text)
    if m is None:
        raise ValueError(f"expected 'key: value', got {text!r}")
    return resolve_plain(text[: m.start()].strip()), text[m.end():].strip()


def _logical_lines(src: str) -> List[Tuple[int, str]]:
    """(indent, text) per line, comments and blank lines dropped, a flow
    collection left open joined with the lines that close it."""
    out: List[Tuple[int, str]] = []
    pending = None
    for raw in src.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
        else:
            pending = (len(line) - len(line.lstrip()), line.strip())
        if _depth(pending[1]) <= 0:
            out.append(pending)
            pending = None
    if pending is not None:
        raise ValueError(f"unclosed flow collection: {pending[1]!r}")
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at lines[i] (at ``indent``)."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent \
                and _is_item(lines[i][1]):
            text = lines[i][1][1:].strip()
            if not text:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    v, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    v, i = None, i + 1
            elif _is_item(text) or (text[:1] not in "{['\""
                                    and re.search(r":(\s|$)", text)):
                # a list or a mapping that starts on the item's line
                sub = indent + len(lines[i][1]) - len(text)
                lines[i] = (sub, text)
                v, i = _block(lines, i, sub)
            else:
                v, i = _inline(text), i + 1
            out.append(v)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent \
            and not _is_item(lines[i][1]):
        key, text = _split_key(lines[i][1])
        i += 1
        if text:
            out[key] = _inline(text)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def safe_load(src: str) -> Any:
    """The document in ``src`` as plain dicts, lists and scalars (what
    yaml.safe_load returns for the subset)."""
    lines = _logical_lines(src)
    if not lines:
        return None
    if len(lines) == 1 and not _is_item(lines[0][1]) \
            and not re.search(r":(\s|$)", lines[0][1]):
        return _inline(lines[0][1])
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected line {lines[i][1]!r}")
    return value
