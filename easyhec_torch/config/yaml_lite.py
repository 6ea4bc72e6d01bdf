"""A YAML reader for configuration files, on the standard library alone.

``load(text)`` returns what PyYAML 6's ``yaml.safe_load`` (YAML 1.1) returns
for every document it accepts, and raises ``ValueError`` naming the line and
column for anything outside its subset; it never returns a different value.
The subset is what the configuration files, the run directories'
``config.yaml`` (JSON) and the command-line overrides use:

- block mappings and block sequences by indentation, a sequence at its key's
  indentation included; ``#`` comments, full-line and trailing; an empty
  document reads as None; of duplicate keys the last one wins;
- flow sequences and mappings, nested, spanning lines, with JSON's quoted
  keys (``{"a":1}``) and trailing commas;
- double-quoted scalars with their escapes, single-quoted ones with ``''``;
- plain scalars resolved by the SafeLoader's implicit resolvers, quirks
  included: ``3e-3`` and ``1.0e3`` are strings (a float needs a dot and a
  signed exponent), ``010`` is 8, ``1:30`` is 90, ``on``/``off`` are bools.

Outside it, and raising: anchors, aliases, tags, ``|`` and ``>`` block
scalars, complex (``?``) keys, directives and document markers, scalars
spanning lines, single-pair mappings inside a flow sequence, tabs outside
quotes and comments, and timestamps (PyYAML returns a date; no config field
takes one).
"""
from __future__ import annotations

import re
from typing import Any

__all__ = ["load"]

# PyYAML's SafeLoader implicit resolvers (yaml/resolver.py), in the order it
# tries them.
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# The characters PyYAML's reader refuses anywhere in a stream.
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010ffff]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_INDICATORS = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
               ">": "block scalars", "%": "directives", "@": "reserved '@'",
               "`": "reserved '`'"}
_FLOW_INDICATORS = ",[]{}"
_INF = float("inf")


def _blank(c: str) -> bool:
    """End of input, a space, a line break or a tab (which then raises)."""
    return c in ("", " ", "\n", "\t")


def _construct_int(v: str) -> int:
    v = v.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        out, base = 0, 1
        for digit in reversed([int(p) for p in v.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * int(v)


def _construct_float(v: str) -> float:
    v = v.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * _INF
    if v == ".nan":
        return -_INF / _INF  # PyYAML's NaN, sign bit included
    if ":" in v:
        out, base = 0.0, 1
        for digit in reversed([float(p) for p in v.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * float(v)


class _Parser:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):  # PyYAML skips a leading byte-order mark
            text = text[1:]
        self.s = text.replace("\r\n", "\n")
        self.n = len(self.s)
        self.i = 0
        bad = _NON_PRINTABLE.search(self.s)
        if bad:
            self.fail(f"unprintable character {bad.group()!r}", bad.start())
        for brk in ("\r", "\x85", "\u2028", "\u2029"):
            if brk in self.s:
                self.fail(f"line break {brk!r} outside the supported subset", self.s.index(brk))

    # -- positions and errors ----------------------------------------------
    def col(self, i: int) -> int:
        return i - (self.s.rfind("\n", 0, i) + 1)

    def fail(self, msg: str, i: int | None = None):
        i = self.i if i is None else i
        line = self.s.count("\n", 0, i) + 1
        raise ValueError(f"YAML line {line}, column {self.col(i) + 1}: {msg}")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < self.n else ""

    # -- whitespace ----------------------------------------------------------
    def spaces(self):
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "\t":
            self.fail("tab outside a quoted scalar or comment")

    def comment(self):
        end = self.s.find("\n", self.i)
        self.i = self.n if end < 0 else end

    def blank_lines(self):
        """Skip spaces, comments and line breaks to the next token."""
        while True:
            self.spaces()
            c = self.peek()
            if c == "#":
                self.comment()
            elif c == "\n":
                self.i += 1
                if self.s.startswith(("---", "..."), self.i) and _blank(self.peek(3)):
                    self.fail("document markers (several documents)")
            else:
                return

    def end_line(self):
        """After a block node: only spaces and a comment to the line's end."""
        self.spaces()
        if self.peek() == "#":
            self.comment()
        c = self.peek()
        if c == ":":
            self.fail("a mapping value is not allowed here")
        if c not in ("", "\n"):
            self.fail(f"unexpected {c!r} after the node")

    # -- block context ---------------------------------------------------------
    def document(self) -> Any:
        if self.s.startswith(("---", "...")) and _blank(self.peek(3)):
            self.fail("document markers (several documents)")
        self.blank_lines()
        if self.peek() == "":
            return None
        val = self.block_node()
        self.blank_lines()
        if self.peek() != "":
            self.fail("content after the document's root node")
        return val

    def block_node(self) -> Any:
        """The node at self.i; a block collection here takes its column as
        its indentation."""
        col = self.col(self.i)
        if self.peek() == "-" and _blank(self.peek(1)):
            return self.block_seq(col)
        start = self.i
        node = self.flow_node(flow=False)
        self.spaces()
        if self.peek() == ":" and _blank(self.peek(1)):
            if self.s[start] in "[{":
                self.fail("a collection as a mapping key", start)
            return self.block_map(col, node)
        self.end_line()
        return node

    def block_map(self, indent: int, key: Any) -> dict:
        out = {}
        while True:
            self.i += 1  # the ':'
            out[key] = self.block_value(indent)
            self.blank_lines()
            if self.peek() == "":
                return out
            col = self.col(self.i)
            if col < indent:
                return out
            if col > indent:
                self.fail("unexpected indentation")
            if self.peek() == "-" and _blank(self.peek(1)):
                self.fail("a sequence entry where a mapping key was expected")
            start = self.i
            if self.peek() in "[{":
                self.fail("a collection as a mapping key")
            key = self.flow_node(flow=False)
            self.spaces()
            if not (self.peek() == ":" and _blank(self.peek(1))):
                self.fail("expected ':' after the mapping key", start)

    def block_value(self, indent: int) -> Any:
        self.spaces()
        c = self.peek()
        if c in ("", "\n", "#"):
            self.blank_lines()
            if self.peek() == "":
                return None
            col = self.col(self.i)
            if col > indent:
                return self.block_node()
            if col == indent and self.peek() == "-" and _blank(self.peek(1)):
                return self.block_seq(indent)  # a sequence at its key's indentation
            return None
        if c == "-" and _blank(self.peek(1)):
            self.fail("a block sequence cannot start on its key's line")
        node = self.flow_node(flow=False)
        self.end_line()
        return node

    def block_seq(self, indent: int) -> list:
        out = []
        while True:
            self.i += 1  # the '-'
            self.spaces()
            if self.peek() in ("", "\n", "#"):
                self.blank_lines()
                nested = self.peek() != "" and self.col(self.i) > indent
                out.append(self.block_node() if nested else None)
            else:
                out.append(self.block_node())
            self.blank_lines()
            if self.peek() == "":
                return out
            col = self.col(self.i)
            if col > indent:
                self.fail("unexpected indentation")
            if col < indent or not (self.peek() == "-" and _blank(self.peek(1))):
                return out

    # -- flow context and scalars ---------------------------------------------
    def flow_node(self, flow: bool) -> Any:
        c = self.peek()
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c == '"':
            return self.double_quoted()
        if c == "'":
            return self.single_quoted()
        if c in _INDICATORS:
            self.fail(f"{_INDICATORS[c]} are outside the supported subset")
        if c in ",]}" or c == "":
            self.fail("expected a node")
        if c in "?:" and (flow or _blank(self.peek(1))):
            self.fail("complex mapping keys ('?', ':') are outside the supported subset")
        if c == "-" and _blank(self.peek(1)):
            self.fail("a block sequence entry is not allowed here")
        start = self.i
        value = self.plain(flow)
        return self.resolve(value, start)

    def plain(self, flow: bool) -> str:
        """A plain scalar on one line, ended as PyYAML's scanner ends it."""
        s, j = self.s, self.i
        stops = _FLOW_INDICATORS if flow else ""
        while j < self.n:
            c = s[j]
            if c in " \t":
                k = j
                while k < self.n and s[k] in " \t":
                    k += 1
                nxt = s[k] if k < self.n else ""
                if nxt in ("", "\n", "#") or nxt in stops or (
                        nxt == ":" and (k + 1 >= self.n or s[k + 1] in " \t\n" + stops)):
                    break
                if "\t" in s[j:k]:
                    self.fail("tab outside a quoted scalar or comment", j + s[j:k].index("\t"))
                j = k
                continue
            if c == "\n" or c in stops:
                break
            if c == ":" and (j + 1 >= self.n or s[j + 1] in " \t\n" + stops):
                break
            if flow and c == "?":
                self.fail("'?' inside a flow scalar", j)
            j += 1
        value = s[self.i:j]
        self.i = j
        return value

    def resolve(self, v: str, start: int) -> Any:
        if _BOOL.match(v):
            return _BOOLS[v.lower()]
        try:
            if _FLOAT.match(v):
                return _construct_float(v)
            if _INT.match(v):
                return _construct_int(v)
        except ValueError as e:  # PyYAML raises these too ('0b_', '0x_')
            self.fail(f"{v!r}: {e}", start)
        if v == "<<":
            self.fail("merge keys ('<<') are outside the supported subset", start)
        if _NULL.match(v):
            return None
        if _TIMESTAMP.match(v):
            self.fail(f"{v!r} is a timestamp, which no config field takes", start)
        if v == "=":
            self.fail("the value key ('=') is outside the supported subset", start)
        return v

    def double_quoted(self) -> str:
        s, j, out = self.s, self.i + 1, []
        while True:
            c = s[j] if j < self.n else ""
            if c == "":
                self.fail("unterminated double-quoted scalar")
            if c == "\n":
                self.fail("a quoted scalar spanning lines", j)
            if c == '"':
                self.i = j + 1
                return "".join(out)
            if c != "\\":
                out.append(c)
                j += 1
                continue
            e = s[j + 1] if j + 1 < self.n else ""
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                digits = s[j + 2:j + 2 + _HEX_ESCAPES[e]]
                if len(digits) < _HEX_ESCAPES[e] or any(
                        d not in "0123456789ABCDEFabcdef" for d in digits):
                    self.fail(f"bad escape \\{e}{digits}", j)
                code = int(digits, 16)
                if code > 0x10FFFF:
                    self.fail(f"escape \\{e}{digits} is out of range", j)
                out.append(chr(code))
                j += 2 + len(digits)
            else:
                self.fail(f"unknown escape \\{e}" if e not in ("", "\n")
                          else "a quoted scalar spanning lines", j)

    def single_quoted(self) -> str:
        s, j, out = self.s, self.i + 1, []
        while True:
            c = s[j] if j < self.n else ""
            if c == "":
                self.fail("unterminated single-quoted scalar")
            if c == "\n":
                self.fail("a quoted scalar spanning lines", j)
            if c == "'":
                if s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                self.i = j + 1
                return "".join(out)
            out.append(c)
            j += 1

    def flow_seq(self) -> list:
        open_at, out = self.i, []
        self.i += 1
        while True:
            self.blank_lines()
            if self.peek() == "]":
                self.i += 1
                return out
            if self.peek() == "":
                self.fail("unterminated '['", open_at)
            out.append(self.flow_node(flow=True))
            self.blank_lines()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c == ":":
                self.fail("a mapping inside a flow sequence is outside the supported subset")
            elif c != "]":
                self.fail("expected ',' or ']'" if c else "unterminated '['",
                          None if c else open_at)

    def flow_map(self) -> dict:
        open_at, out = self.i, {}
        self.i += 1
        while True:
            self.blank_lines()
            c = self.peek()
            if c == "}":
                self.i += 1
                return out
            if c == "":
                self.fail("unterminated '{'", open_at)
            if c in "[{":
                self.fail("a collection as a mapping key")
            key = self.flow_node(flow=True)
            self.spaces()
            if self.peek() != ":":
                self.fail("expected ':' after the flow mapping key")
            self.i += 1
            self.blank_lines()
            out[key] = None if self.peek() in (",", "}") else self.flow_node(flow=True)
            self.blank_lines()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                self.fail("expected ',' or '}'" if c else "unterminated '{'",
                          None if c else open_at)


def load(text: str) -> Any:
    """The value of one YAML document, as ``yaml.safe_load`` returns it."""
    return _Parser(text).document()
