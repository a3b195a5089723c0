"""A standard-library reader for the YAML that the files in ``configs/`` use.

The JAX package reads its configs with PyYAML (a ``SafeLoader`` that also
evaluates ``!!python/object/apply:eval``); the port carries this reader
instead, so that it needs nothing beyond the standard library. It gives the
same Python values as that loader for the subset below, and raises
:class:`YamlError` naming the file and line for anything else:

* block mappings nested by indentation (spaces only), with plain or quoted
  keys; a key with no value and no indented block under it is ``None``;
* flow sequences ``[...]``, nested and spanning lines;
* plain scalars, folded with a space where they continue on more-indented
  lines; single- and double-quoted scalars on one line;
* comments: ``#`` at the start of a line or after whitespace, outside quotes;
* YAML 1.1 implicit types as PyYAML resolves them: booleans
  (``true``/``yes``/``on`` ...), null (``~``, ``null``, empty), ints (decimal,
  ``0x``, ``0b`` and leading-zero octal, with ``_`` separators) and floats
  (a dot is required; an exponent needs its sign: ``1e-4`` stays a string);
* ``!!python/object/apply:eval ["expr"]``, evaluated with no builtins.

Not supported: block sequences (``- item``), flow mappings, anchors and
aliases, block scalars (``|``, ``>``), other tags, timestamps, sexagesimal
numbers, several documents.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

EVAL_TAG = "!!python/object/apply:eval"

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# Forms PyYAML resolves that this reader does not construct.
_UNSUPPORTED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlError(ValueError):
    """A construct outside the supported subset, or malformed YAML."""

    def __init__(self, message: str, filename: str, line: int):
        super().__init__(f"{filename}:{line}: {message}")


def load_file(path: str) -> Any:
    """Read ``path`` (UTF-8) and return its value."""
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read(), path)


def load(text: str, filename: str = "<string>") -> Any:
    """The value of one YAML document (``None`` when it is empty)."""
    return _Parser(text, filename).document()


def resolve_plain(text: str, filename: str = "<string>", line: int = 0) -> Any:
    """A plain scalar's value under PyYAML's implicit resolvers."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        if s.endswith((".inf", ".nan")):
            return float(s.replace(".", ""))
        return float(s)
    if _UNSUPPORTED.match(text):
        raise YamlError(f"unsupported scalar form {text!r}", filename, line)
    return text


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


class _Parser:
    def __init__(self, text: str, filename: str):
        self.filename = filename
        self.lines: List[_Line] = []
        for number, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
                raise YamlError("tabs in indentation", filename, number)
            if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
                raise YamlError("document markers and directives are not supported",
                                filename, number)
            self.lines.append(_Line(number, len(body) - len(stripped), stripped))

    def error(self, message: str, line: int):
        return YamlError(message, self.filename, line)

    def document(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        if _find_key_colon(first.text) is None:
            value, i = self.value_lines(0, -1)
            if i != len(self.lines):
                raise self.error("unexpected content after a top-level value",
                                 self.lines[i].number)
            return value
        value, i = self.mapping(0, first.indent)
        if i != len(self.lines):
            raise self.error("unexpected indentation", self.lines[i].number)
        return value

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines):
            line = self.lines[i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error("unexpected indentation", line.number)
            if line.text.startswith("- ") or line.text == "-":
                raise self.error("block sequences are not supported", line.number)
            colon = _find_key_colon(line.text)
            if colon is None:
                raise self.error("expected 'KEY: value'", line.number)
            key = self.scalar(line.text[:colon].strip(), line.number)
            rest = line.text[colon + 1:].strip()
            if rest:
                value, i = self.value_lines(i, indent, rest)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                value, i = self.mapping(i + 1, self.lines[i + 1].indent)
            else:
                value, i = None, i + 1
            out[key] = value
        return out, i

    def value_lines(self, i: int, indent: int, text: Optional[str] = None) -> Tuple[Any, int]:
        """The value starting on line ``i`` (``text``, or the whole line),
        with the lines it continues on; returns it and the next line."""
        line = self.lines[i]
        text = line.text if text is None else text
        number = line.number
        parts = [text]
        i += 1
        if _opens_flow(text):
            depth = _bracket_depth(text)
            while depth > 0:
                if i >= len(self.lines):
                    raise self.error("unterminated flow sequence", number)
                parts.append(self.lines[i].text)
                depth += _bracket_depth(self.lines[i].text)
                i += 1
            return self.flow_value("\n".join(parts), number), i
        while i < len(self.lines) and self.lines[i].indent > indent:
            if text[0] in "\"'":
                raise self.error("multi-line quoted scalars are not supported", number)
            if _find_key_colon(self.lines[i].text) is not None:
                raise self.error("mapping values are not allowed here", self.lines[i].number)
            parts.append(self.lines[i].text)
            i += 1
        return self.scalar(" ".join(p.strip() for p in parts), number), i

    def flow_value(self, text: str, number: int) -> Any:
        text = text.strip()
        if text.startswith("!"):
            tag, _, rest = text.partition(" ")
            if tag != EVAL_TAG:
                raise self.error(f"unsupported tag {tag}", number)
            args = self.flow_value(rest, number)
            if not (isinstance(args, list) and len(args) == 1 and isinstance(args[0], str)):
                raise self.error(f"unsupported eval form: {args}", number)
            return eval(args[0], {"__builtins__": {}}, {})  # noqa: S307 (no builtins)
        value, pos = _FlowReader(text, self, number).sequence(0)
        if text[pos:].strip():
            raise self.error("unexpected text after a flow sequence", number)
        return value

    def scalar(self, text: str, number: int) -> Any:
        if not text:
            return None
        head = text[0]
        if head in "\"'":
            value, end = _quoted(text, 0, self, number)
            if text[end:].strip():
                raise self.error("unexpected text after a quoted scalar", number)
            return value
        if head in "[!":
            return self.flow_value(text, number)
        if head in "{&*|>@`%":
            raise self.error(f"unsupported construct {text[:20]!r}", number)
        return resolve_plain(text, self.filename, number)


class _FlowReader:
    """Flow sequences: ``[a, "b", [c, d]]`` with plain and quoted items."""

    def __init__(self, text: str, parser: _Parser, number: int):
        self.text, self.parser, self.number = text, parser, number

    def skip(self, pos: int) -> int:
        while pos < len(self.text) and self.text[pos] in " \n":
            pos += 1
        return pos

    def sequence(self, pos: int) -> Tuple[list, int]:
        pos = self.skip(pos)
        if pos >= len(self.text) or self.text[pos] != "[":
            raise self.parser.error("expected a flow sequence", self.number)
        items: list = []
        pos = self.skip(pos + 1)
        while True:
            if pos >= len(self.text):
                raise self.parser.error("unterminated flow sequence", self.number)
            if self.text[pos] == "]":
                return items, pos + 1
            item, pos = self.item(pos)
            items.append(item)
            pos = self.skip(pos)
            if pos < len(self.text) and self.text[pos] == ",":
                pos = self.skip(pos + 1)
            elif pos < len(self.text) and self.text[pos] != "]":
                raise self.parser.error("expected ',' or ']' in a flow sequence", self.number)

    def item(self, pos: int) -> Tuple[Any, int]:
        c = self.text[pos]
        if c == "[":
            return self.sequence(pos)
        if c in "\"'":
            return _quoted(self.text, pos, self.parser, self.number)
        if c in "{!&*":
            raise self.parser.error(f"unsupported flow item starting with {c!r}", self.number)
        end = pos
        while end < len(self.text) and self.text[end] not in ",[]{}":
            if self.text[end] == ":" and (end + 1 == len(self.text) or self.text[end + 1] in " \n"):
                raise self.parser.error("flow mappings are not supported", self.number)
            end += 1
        plain = " ".join(self.text[pos:end].split())
        return resolve_plain(plain, self.parser.filename, self.number), end


def _quoted(text: str, pos: int, parser: _Parser, number: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``; returns it and the index
    after its closing quote."""
    quote = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1: i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = text[i + 1: i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2: i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise parser.error(f"bad escape \\{e}{digits}", number)
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise parser.error(f"unsupported escape \\{e}", number)
            continue
        if c == "\n":
            raise parser.error("multi-line quoted scalars are not supported", number)
        out.append(c)
        i += 1
    raise parser.error("unterminated quoted scalar", number)


def _scan(text: str):
    """Yield ``(index, char, in_quotes)`` over ``text``, tracking quotes."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote is None:
            if c in "\"'" and (i == 0 or text[i - 1] in " \t[,:"):
                quote = c
                yield i, c, True
            else:
                yield i, c, False
        elif quote == '"':
            yield i, c, True
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        else:
            yield i, c, True
            if c == "'":
                if text[i + 1: i + 2] == "'":
                    i += 1
                else:
                    quote = None
        i += 1


def _strip_comment(raw: str) -> str:
    for i, c, quoted in _scan(raw):
        if c == "#" and not quoted and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
    return raw


def _find_key_colon(text: str) -> Optional[int]:
    """Index of the ``:`` that ends a mapping key (outside quotes and flow
    brackets, followed by a space or the end of the line)."""
    if text.startswith(("[", "!")):
        return None
    depth = 0
    for i, c, quoted in _scan(text):
        if quoted:
            continue
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] == " "):
            return i
    return None


def _opens_flow(text: str) -> bool:
    return text.startswith("[") or (text.startswith(EVAL_TAG) and "[" in text)


def _bracket_depth(text: str) -> int:
    depth = 0
    for _, c, quoted in _scan(text):
        if not quoted:
            depth += (c == "[") - (c == "]")
    return depth
