"""A reader and writer for the YAML the repo's configs use, without PyYAML.

The machine with the card has no PyYAML, and the repo's configs
(``models/asf/config/**/*.yaml``) are YAML in block and flow style. This
module reads the subset those files use, with PyYAML's ``safe_load``
semantics (YAML 1.1):

* block mappings (``KEY: value``, ``KEY:`` over a more indented block or a
  block list at the key's own indent) and block lists (``- item``) whose
  items are scalars, flow collections or block lists in the compact form
  PyYAML writes (``- - a``), so that a config ``asf_tpu`` dumped reads back;
* flow lists and flow mappings (``[a, [b, c]]``, ``{A: 1, B: [x]}``), nested,
  over as many lines as their brackets need;
* plain scalars resolved as YAML 1.1 does: ``null``/``~``/empty, the twelve
  booleans (``yes``/``no``/``true``/``false``/``on``/``off`` in three
  casings), decimal integers, floats (``1.5``, ``1.0e-4``, ``.5``, ``.inf``,
  ``.nan``), anything else a string (``1e-4`` is a string in YAML 1.1);
  single- and double-quoted strings; ``#`` comments.

Anything outside the subset raises ``ValueError`` with its line number,
never a silent misreading: anchors, aliases, tags, block scalars (``|``,
``>``), documents (``---``), maps inside block lists, duplicate keys, and
plain scalars that YAML 1.1 would read as octal, hexadecimal, binary or
base-60 numbers or timestamps. ``dump`` writes a nested dict back in that
subset (block mappings, flow lists), which ``load`` and ``yaml.safe_load``
read back to the same values.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF_NAN = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# Plain scalars that YAML 1.1 resolves to types this reader does not build.
_OTHER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"  # binary, octal, hex
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"  # base 60
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*"  # timestamps
    r"|<<|=)$")
_INDICATORS = "&*!|>%@`"  # anchors, aliases, tags, block scalars, directives, reserved


class _Error(ValueError):
    def __init__(self, line: int, msg: str):
        super().__init__(f"line {line}: {msg}")


def _resolve(text: str, line: int) -> Any:
    """A plain scalar's value, as YAML 1.1 resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF_NAN.match(text):
        low = text.lower()
        return float("nan") if "nan" in low else float("-inf" if low[0] == "-" else "inf")
    if _OTHER.match(text):
        raise _Error(line, f"{text!r} is a YAML 1.1 number or date form this reader does not take")
    if text[0] in _INDICATORS or text.startswith(("---", "...")):
        raise _Error(line, f"{text!r}: anchors, aliases, tags, block scalars and "
                           "documents are outside the subset")
    return text


def _quote_end(text: str, i: int) -> int:
    """The index of the quote that closes the one at ``text[i]`` (``''``
    escapes a single quote, a backslash the next character in double
    quotes); -1 when it is not closed."""
    q, j = text[i], i + 1
    while j < len(text):
        if q == '"' and text[j] == "\\":
            j += 2
        elif text[j] == q and q == "'" and text[j + 1 : j + 2] == "'":
            j += 2
        elif text[j] == q:
            return j
        else:
            j += 1
    return -1


def _strip_comment(text: str) -> str:
    """``text`` without a ``#`` comment (one at its start or after a space,
    outside quotes)."""
    i = 0
    while i < len(text):
        ch = text[i]
        if ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            end = _quote_end(text, i)
            i = len(text) if end < 0 else end + 1
            continue
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
        i += 1
    return text


class _Flow:
    """A recursive-descent reader of one flow node (with its continuation lines)."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def error(self, msg: str) -> _Error:
        return _Error(self.line, f"{msg} in {self.s.strip()!r}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, in_flow: bool) -> Any:
        self.skip()
        ch = self.s[self.i] if self.i < len(self.s) else ""
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        if ch in ("'", '"'):
            return self.quoted()
        return self.plain(in_flow)

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.s[self.i : self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node(True))
            self.skip()
            ch = self.s[self.i : self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "]":
                raise self.error("expected ',' or ']'")

    def map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.s[self.i : self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node(True)
            self.skip()
            if self.s[self.i : self.i + 1] != ":":
                raise self.error("expected ':' after a flow mapping key")
            self.i += 1
            self.skip()
            value = None if self.s[self.i : self.i + 1] in (",", "}") else self.node(True)
            if not isinstance(key, str) or key in out:
                raise self.error(f"flow mapping key {key!r} is not a new string")
            out[key] = value
            self.skip()
            ch = self.s[self.i : self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "}":
                raise self.error("expected ',' or '}'")

    def quoted(self) -> str:
        q, j = self.s[self.i], _quote_end(self.s, self.i)
        if j < 0:
            raise self.error("unterminated quoted scalar")
        body = self.s[self.i + 1 : j]
        self.i = j + 1
        if q == "'":
            return body.replace("''", "'")
        try:
            return json.loads(f'"{body}"')
        except ValueError as e:
            raise self.error(f"double-quoted escape outside the JSON subset ({e})") from None

    def plain(self, in_flow: bool) -> Any:
        stops = ",[]{}" if in_flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stops:
            if self.s[j] == ":" and (j + 1 == len(self.s) or self.s[j + 1] in " \t" + stops):
                break
            if in_flow and self.s[j] == ":":
                raise self.error("':' inside a flow plain scalar")
            j += 1
        text = " ".join(self.s[self.i : j].split())
        self.i = j
        return _resolve(text, self.line)


def _split_key(body: str, line: int) -> Tuple[str, str]:
    """(key, rest) of a block mapping entry ``key: rest`` or ``key:``."""
    flow = _Flow(body, line)
    key = flow.node(True) if body[:1] in ("'", '"') else flow.plain(False)
    flow.skip()
    if flow.s[flow.i : flow.i + 1] != ":":
        raise _Error(line, f"expected 'key: value', got {body.strip()!r}")
    if not isinstance(key, str):
        raise _Error(line, f"mapping key {key!r} is not a string")
    return key, body[flow.i + 1 :].strip()


def _is_item(body: str) -> bool:
    return body.startswith("-") and body[1:2] in ("", " ")


def _is_entry(body: str, line: int) -> bool:
    """Whether ``body`` is a block mapping entry ``key: ...``."""
    if body[:1] in ("[", "{") or _is_item(body):
        return False
    try:
        _split_key(body, line)
    except ValueError:
        return False
    return True


def _lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of the lines that hold something."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise _Error(n, "tab in indentation")
        out.append((n, len(body) - len(stripped), stripped))
    return out


class _Block:
    def __init__(self, text: str):
        self.lines = _lines(text)
        self.k = 0

    def value(self, rest: str, line: int, indent: int) -> Any:
        """The value that starts with ``rest`` on ``line``: a flow node, with
        the more indented lines after it where its brackets stay open."""
        text = rest
        if rest[:1] in ("[", "{"):
            while _open(text, line) and self.k < len(self.lines):
                n, ind, body = self.lines[self.k]
                if ind <= indent:
                    break
                text += " " + body
                self.k += 1
        flow = _Flow(text, line)
        out = flow.node(False)
        flow.skip()
        if flow.i != len(flow.s):
            raise _Error(line, f"unexpected {flow.s[flow.i:]!r} after a value")
        if self.k < len(self.lines) and self.lines[self.k][1] > indent:
            raise _Error(self.lines[self.k][0], "a more indented line after a value "
                         "(a multi-line plain scalar is outside the subset)")
        return out

    def node(self, indent: int) -> Any:
        return (self.seq if _is_item(self.lines[self.k][2]) else self.map)(indent)

    def seq(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            n, ind, body = self.lines[self.k]
            if ind < indent or (ind == indent and not _is_item(body)):
                break  # the list ends; a mapping around it may go on
            if ind > indent:
                raise _Error(n, f"unexpected indent {ind} in a list at indent {indent}")
            item = body[1:].strip()
            if _is_item(item):
                # A list in a list, as PyYAML writes one ("- - a"): its items
                # sit at the inner dash's column, the first on this line.
                inner = ind + len(body) - len(item)
                self.lines[self.k] = (n, inner, item)
                out.append(self.seq(inner))
                continue
            self.k += 1
            if not item or _is_entry(item, n):
                raise _Error(n, "nested block nodes in a block list are outside the subset")
            out.append(self.value(item, n, indent))
        return out

    def map(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            n, ind, body = self.lines[self.k]
            if ind < indent:
                break
            if ind > indent:
                raise _Error(n, f"unexpected indent {ind} (expected {indent})")
            key, rest = _split_key(body, n)
            if key in out:
                raise _Error(n, f"duplicate key {key!r}")
            self.k += 1
            if rest:
                out[key] = self.value(rest, n, ind)
                continue
            nxt = self.lines[self.k] if self.k < len(self.lines) else None
            if nxt is not None and (nxt[1] > ind or (nxt[1] == ind and _is_item(nxt[2]))):
                out[key] = self.node(nxt[1])  # a block list may sit at its key's indent
            else:
                out[key] = None
        return out


def _open(text: str, line: int) -> bool:
    """Whether ``text`` leaves a flow bracket open (quotes skipped)."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    if depth < 0:
        raise _Error(line, "unbalanced brackets")
    return depth > 0


def load(text: str) -> Any:
    """The document ``text`` as dicts, lists and scalars (``None`` when empty)."""
    block = _Block(text)
    if not block.lines:
        return None
    n, indent, body = block.lines[0]
    if _is_item(body) or _is_entry(body, n):
        out = block.node(indent)
    else:  # a flow node or a scalar: every line after the first continues it
        block.k = 1
        out = block.value(body, n, -1)
    if block.k < len(block.lines):
        raise _Error(block.lines[block.k][0], "unexpected content after the document")
    return out


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read())


def _scalar(v: Any) -> str:
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
        if "." not in text and "e" in text:  # 1e-10 is a string in YAML 1.1
            text = text.replace("e", ".0e")
        return text
    if isinstance(v, str):
        try:
            plain = (v == v.strip() and not any(c in v for c in ":#,[]{}'\"\n\t")
                     and not v.startswith(("-", "?")) and isinstance(_resolve(v, 0), str))
        except ValueError:
            plain = False
        return v if plain else json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r}")


def _flow(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    return _scalar(v)


def dump(tree: dict, indent: int = 0) -> str:
    """``tree`` (nested dicts of scalars and lists) as block mappings with
    flow lists, keys in their order."""
    lines = []
    for k, v in tree.items():
        key = " " * indent + _scalar(k) + ":"
        if isinstance(v, dict) and v:
            lines.append(key)
            lines.append(dump(v, indent + 2).rstrip("\n"))
        else:
            lines.append(f"{key} {_flow(v)}")
    return "\n".join(lines) + "\n"
