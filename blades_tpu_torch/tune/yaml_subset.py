"""A small reader for the experiment files' subset of YAML.

``load(text)`` returns what ``yaml.safe_load`` returns for the files the
repo ships (``blades_tpu/tuned_examples/*.yaml``), without PyYAML:

- block mappings and block sequences by indentation, a sequence item that
  opens a mapping on its own line (``- type: Mean`` followed by more keys);
- single-line flow mappings and sequences, nested (``{type: DnC}``,
  ``[[0, 0.1], [1500, 0.1]]``);
- plain, single-quoted and double-quoted scalars, full-line and trailing
  comments;
- PyYAML's YAML 1.1 resolver for plain scalars: ``true`` / ``True`` /
  ``yes`` / ``on`` ... are booleans, ``~`` / ``null`` / empty are None, an
  int takes ``0b``, ``0x``, a leading-zero octal and ``_``, and a float
  needs a dot or a leading dot and a signed exponent, so ``1.0e-6`` is a
  float while ``1e-6`` and ``1.0e6`` stay strings.

Anything else (anchors and aliases, tags, block scalars, several
documents, directives, complex keys, multi-line plain scalars or flow
collections, timestamps, tabs) raises :class:`YamlSubsetError` naming the
construct.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
# PyYAML's implicit resolvers (resolver.py), YAML 1.1.
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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}


class YamlSubsetError(ValueError):
    """A construct outside the subset, or malformed input."""


def _sexagesimal(body: str, cast):
    value = 0
    for part in body.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    if t[0] in "+-":
        t = t[1:]
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t[0] == "0":
        return sign * int(t, 8)
    if ":" in t:
        return sign * _sexagesimal(t, int)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    if t[0] in "+-":
        t = t[1:]
    if t == ".inf":
        return sign * float("inf")
    if t == ".nan":
        return float("nan")
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as PyYAML's YAML 1.1 resolver gives it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text):
        raise YamlSubsetError(f"timestamps are not taken: {text!r}")
    return text


def _refuse_plain(text: str) -> None:
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`", "?"):
        what = {"&": "anchors", "*": "aliases", "!": "tags",
                "|": "block scalars", ">": "block scalars",
                "%": "directives", "?": "complex keys"}.get(
                    text[0], "reserved indicators")
        raise YamlSubsetError(f"{what} are not taken: {text!r}")


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]``: ``(value, end index)``."""
    q = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            codes = {"x": 2, "u": 4, "U": 8}
            if e in codes:
                n = codes[e]
                out.append(chr(int(text[j + 2:j + 2 + n], 16)))
                j += 2 + n
                continue
            raise YamlSubsetError(f"unknown escape \\{e} in {text!r}")
        out.append(c)
        j += 1
    raise YamlSubsetError(f"unterminated quoted scalar (multi-line scalars "
                          f"are not taken): {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after
    whitespace, outside quotes) and trailing whitespace."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            _, i = _quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """A single-line flow collection or scalar, parsed by recursive
    descent."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        self.ws()
        c = self.s[self.i:self.i + 1]
        if c == "{":
            return self.collection("}")
        if c == "[":
            return self.collection("]")
        if c in ("'", '"'):
            v, self.i = _quoted(self.s, self.i)
            return v
        return resolve_plain(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if in_flow and c in ",]}":
                break
            if in_flow and c == ":" and self.s[self.i + 1:self.i + 2] in (
                    " ", ",", "]", "}", ""):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        _refuse_plain(text)
        return text

    def collection(self, close: str) -> Any:
        self.i += 1
        out: Any = {} if close == "}" else []
        while True:
            self.ws()
            if self.i >= len(self.s):
                raise YamlSubsetError(
                    "unterminated flow collection (multi-line flow "
                    f"collections are not taken): {self.s!r}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            if close == "}":
                key = self.value(True)
                self.ws()
                if self.s[self.i:self.i + 1] == ":":
                    self.i += 1
                    val = self.value(True)
                else:
                    val = None
                out[key] = val
            else:
                out.append(self.value(True))
            self.ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != close:
                raise YamlSubsetError(f"malformed flow collection: {self.s!r}")


def _inline(text: str) -> Any:
    """A value written on the line of its key or dash."""
    p = _Flow(text)
    if text[0] in "{['\"":
        v = p.value(False)
        p.ws()
        if p.i != len(text):
            raise YamlSubsetError(f"trailing text after a value: {text!r}")
        return v
    return p.value(False)


def _split_key(text: str):
    """``(key, rest)`` when ``text`` opens a mapping entry, else None."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
        rest = text[j:].lstrip()
        if rest[:1] == ":" and rest[1:2] in ("", " "):
            return key, rest[1:].strip()
        return None
    if text[0] in "{[":
        return None
    m = re.search(r":( |$)", text)
    if m is None:
        return None
    key = text[:m.start()].rstrip()
    _refuse_plain(key)
    return resolve_plain(key), text[m.end():].strip()


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines

    def node(self, i: int, indent: int):
        text = self.lines[i][1]
        if text == "-" or text.startswith("- "):
            return self.seq(i, indent)
        if _split_key(text) is not None:
            return self.mapping(i, indent)
        if i + 1 < len(self.lines) and self.lines[i + 1][0] >= indent:
            raise YamlSubsetError(
                f"multi-line plain scalars are not taken: {text!r}")
        return _inline(text), i + 1

    def child(self, i: int, indent: int, seq_ok: bool):
        """The block under the entry at line ``i - 1`` (None if absent)."""
        if i < len(self.lines):
            ind, text = self.lines[i]
            is_item = text == "-" or text.startswith("- ")
            if ind > indent or (seq_ok and ind == indent and is_item):
                return self.node(i, ind)
        return None, i

    def mapping(self, i: int, indent: int):
        out = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            text = self.lines[i][1]
            kv = _split_key(text)
            if kv is None:
                break
            key, rest = kv
            if rest:
                value = _inline(rest)
                i += 1
                if i < len(self.lines) and self.lines[i][0] > indent:
                    raise YamlSubsetError(
                        "multi-line plain scalars are not taken: "
                        f"{self.lines[i][1]!r}")
            else:
                value, i = self.child(i + 1, indent, seq_ok=True)
            out[key] = value
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise YamlSubsetError(f"bad indentation at {self.lines[i][1]!r}")
        return out, i

    def seq(self, i: int, indent: int):
        out = []
        while i < len(self.lines) and self.lines[i][0] == indent:
            text = self.lines[i][1]
            if not (text == "-" or text.startswith("- ")):
                break
            rest = text[1:].lstrip()
            if not rest:
                value, i = self.child(i + 1, indent, seq_ok=False)
            elif rest == "-" or rest.startswith("- ") or (
                    _split_key(rest) is not None):
                col = indent + len(text) - len(rest)
                self.lines[i] = (col, rest)
                value, i = self.node(i, col)
            else:
                value = _inline(rest)
                i += 1
            out.append(value)
        return out, i


def load(text: str) -> Any:
    """Parse ``text`` as ``yaml.safe_load`` would, within the subset."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"tabs in indentation are not taken: "
                                  f"{raw!r}")
        line = _strip_comment(raw)
        body = line.lstrip()
        if not body:
            continue
        if body.startswith(("---", "...")) and line == body:
            raise YamlSubsetError(
                f"document markers (several documents) are not taken: "
                f"{raw!r}")
        if body[0] in "%?":
            _refuse_plain(body)
        lines.append((len(line) - len(body), body))
    if not lines:
        return None
    block = _Block(lines)
    value, i = block.node(0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"bad indentation at {lines[i][1]!r}")
    return value


def load_file(path) -> Any:
    with open(path) as f:
        return load(f.read())
