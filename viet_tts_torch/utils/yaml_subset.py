"""A reader of the YAML subset that the repo's config files use.

The card has no ``pyyaml``, so the port reads ``config/*.yaml`` (and a
``config.yaml`` sidecar written by ``yaml.safe_dump``) itself. The subset:

- block mappings and block sequences (a sequence may sit at its key's own
  indentation, as ``safe_dump`` writes it, and items may nest: ``- - 1``,
  ``- key: value``);
- flow mappings and sequences on one line (``{a: 1, b: [2, 3]}``);
- plain, single-quoted and double-quoted scalars, resolved as
  ``yaml.safe_load`` resolves them: null (``null``, ``~``, empty), YAML 1.1
  booleans (``true``, ``yes``, ``on``, ...), decimal integers, floats with
  a dot (``2.0e-4``, ``.inf``, ``.nan``), everything else a string;
- comments.

Anything outside it raises ``YamlSubsetError`` (anchors, aliases, tags,
block scalars, multi-line scalars or flow collections, documents markers,
tabs, octal, hexadecimal or sexagesimal numbers, timestamps, complex keys):
a file is read as ``safe_load`` reads it, or not at all.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# forms safe_load resolves to types this reader does not produce
_UNSUPPORTED = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*|<<|=)$")
_INDICATORS = "&*!|>%@`?"


class YamlSubsetError(ValueError):
    """The text is not in the subset this reader accepts."""


def _resolve(text: str) -> Any:
    """A plain scalar -> the value ``yaml.safe_load`` gives it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _UNSUPPORTED.match(text):
        raise YamlSubsetError(f"scalar {text!r} is outside the supported subset")
    if text[0] in _INDICATORS or text.startswith(("- ", ": ")) or text == "-":
        raise YamlSubsetError(f"plain scalar {text!r} starts with an indicator")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlSubsetError(f"plain scalar {text!r} holds a mapping indicator")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]`` -> (value, index past it)."""
    quote = s[i]
    out: List[str] = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if quote == "'" and c == "'":
            if s[j + 1: j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and c == '"':
            return "".join(out), j + 1
        if quote == '"' and c == "\\":
            e = s[j + 1: j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None or not re.fullmatch(r"[0-9a-fA-F]+", s[j + 2: j + 2 + width]):
                raise YamlSubsetError(f"bad escape in {s!r}")
            out.append(chr(int(s[j + 2: j + 2 + width], 16)))
            j += 2 + width
            continue
        out.append(c)
        j += 1
    raise YamlSubsetError(f"unterminated or multi-line quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at the start or after a blank,
    outside quotes)."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 2
                continue
            if c == quote:
                if quote == "'" and line[i + 1: i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _split_key(text: str) -> Tuple[Any, str, bool]:
    """``key: rest`` -> (key, rest, True); (None, text, False) when the
    text is no mapping entry."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
        rest = text[j:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip(), True
        return None, text, False
    if text[0] in "[{":
        return None, text, False
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None, text, False
    key = text[: m.start()].rstrip()
    if not key:
        raise YamlSubsetError(f"empty key in {text!r}")
    return _resolve(key), text[m.end():].strip(), True


class _Flow:
    """A flow collection or scalar on one line."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def node(self) -> Any:
        self._ws()
        if self.i >= len(self.s):
            raise YamlSubsetError(f"flow collection {self.s!r} is cut short")
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "'\"":
            value, self.i = _quoted(self.s, self.i)
            return value
        m = re.compile(r"[^,\[\]{}]*").match(self.s, self.i)
        text = m.group(0)
        end = self.i + len(text)
        colon = re.search(r":(?: |$)", text)
        if colon is not None:  # a key of a flow mapping ends at its colon
            text, end = text[: colon.start()], self.i + colon.start()
        self.i = end
        text = text.strip()
        if not text:
            raise YamlSubsetError(f"empty flow entry in {self.s!r}")
        return _resolve(text)

    def _seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.s[self.i: self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self._sep("]")

    def _map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self._ws()
            if self.s[self.i: self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node()
            self._ws()
            if self.s[self.i: self.i + 1] != ":":
                raise YamlSubsetError(f"flow mapping entry without ':' in {self.s!r}")
            self.i += 1
            self._ws()
            out[key] = None if self.s[self.i: self.i + 1] in (",", "}") else self.node()
            self._sep("}")

    def _sep(self, close: str):
        self._ws()
        c = self.s[self.i: self.i + 1]
        if c == ",":
            self.i += 1
        elif c != close:
            raise YamlSubsetError(f"expected ',' or {close!r} in {self.s!r}")


def _value(text: str) -> Any:
    """The value of an entry written on one line."""
    if text[0] in "[{":
        flow = _Flow(text)
        value = flow.node()
        if flow.s[flow.i:].strip():
            raise YamlSubsetError(f"text after a flow collection: {text!r}")
        return value
    if text[0] in "'\"":
        value, j = _quoted(text, 0)
        if text[j:].strip():
            raise YamlSubsetError(f"text after a quoted scalar: {text!r}")
        return value
    return _resolve(text)


class _Block:
    """Indentation-driven parse of (indent, text) lines."""

    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def node(self, indent: int) -> Any:
        ind, text = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self._seq(indent)
        key, _, is_map = _split_key(text)
        if is_map:
            return self._map(indent)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YamlSubsetError(f"multi-line scalar at {text!r}")
        return _value(text)

    def _child(self, indent: int, allow_seq_here: bool) -> Any:
        """The value of an entry whose text ended at its ':' or '-'."""
        if self.i >= len(self.lines):
            return None
        ind, text = self.lines[self.i]
        if ind > indent:
            return self.node(ind)
        if ind == indent and allow_seq_here and (text == "-" or text.startswith("- ")):
            return self._seq(indent)
        return None

    def _item(self, indent: int, text: str) -> Any:
        """One sequence item's content, ``text``, at column ``indent``."""
        if not text:
            self.i += 1
            return self._child(indent - 1, False)
        self.lines[self.i] = (indent, text)
        return self.node(indent)

    def _seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"bad indentation at {text!r}")
            if not (text == "-" or text.startswith("- ")):
                break
            rest = text[1:]
            content = rest.lstrip(" ")
            out.append(self._item(indent + 1 + len(rest) - len(content), content))
        return out

    def _map(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"bad indentation at {text!r}")
            key, rest, is_map = _split_key(text)
            if not is_map:
                if text == "-" or text.startswith("- "):
                    break
                raise YamlSubsetError(f"expected 'key: value', got {text!r}")
            self.i += 1
            if rest:
                if self.i < len(self.lines) and self.lines[self.i][0] > indent:
                    raise YamlSubsetError(f"multi-line value at {text!r}")
                out[key] = _value(rest)
            else:
                out[key] = self._child(indent, True)
        return out


def safe_load(text: str) -> Any:
    """Parse ``text`` as ``yaml.safe_load`` would, within the subset."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"tab in indentation: {raw!r}")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.startswith(("---", "...", "%")):
            raise YamlSubsetError(f"document markers and directives are not supported: {raw!r}")
        lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    parser = _Block(lines)
    value = parser.node(lines[0][0])
    if parser.i != len(lines):
        raise YamlSubsetError(f"unexpected text at {lines[parser.i][1]!r}")
    return value


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf8") as f:
        return safe_load(f.read())
