"""Minimal EDN reader and writer.

Reads the reference's on-disk `history.edn` (one op map per line,
written by `util/pwrite-history!`, reference
jepsen/src/jepsen/store.clj:351-362), and writes EDN the way
`jepsen_tpu.edn.dumps` does, byte for byte (the service's WAL stores
keys and ops in it). A copy of `jepsen_tpu.edn`, so that the port
imports nothing of the JAX package.

Mapping to Python:
    nil            -> None
    true/false     -> bool
    integers       -> int          (incl. trailing N bigints)
    floats         -> float        (incl. trailing M decimals)
    strings        -> str
    :keyword       -> Keyword      (interned; == compares by name)
    symbol         -> Symbol
    \\c chars      -> str of length 1
    (...) [...]    -> list
    {...}          -> dict
    #{...}         -> frozenset
    #tag value     -> Tagged(tag, value)   (#inst kept as Tagged)
"""

from __future__ import annotations

import io
from typing import Any, Iterator


class Keyword:
    """An EDN keyword (`:foo` / `:foo/bar`). Interned: equal names are `is`."""

    __slots__ = ("name",)
    _interned: dict = {}

    def __new__(cls, name: str):
        k = cls._interned.get(name)
        if k is None:
            k = object.__new__(cls)
            k.name = name
            cls._interned[name] = k
        return k

    def __repr__(self):
        return ":" + self.name

    def __hash__(self):
        return hash(self.name) ^ 0x9E3779B9

    def __eq__(self, other):
        if isinstance(other, Keyword):
            return self.name == other.name
        return NotImplemented

    def __reduce__(self):  # pickle support
        return (Keyword, (self.name,))


class Symbol:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name

    def __hash__(self):
        return hash(self.name) ^ 0x85EBCA6B

    def __eq__(self, other):
        return isinstance(other, Symbol) and self.name == other.name


class Tagged:
    """A tagged literal `#tag value` we don't interpret."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value: Any):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"#{self.tag} {self.value!r}"

    def __eq__(self, other):
        return (
            isinstance(other, Tagged)
            and self.tag == other.tag
            and self.value == other.value
        )

    def __hash__(self):
        return hash((self.tag, repr(self.value)))


_WS = set(" \t\r\n,")
_DELIM = set('()[]{}"; ')
_CHAR_NAMES = {
    "newline": "\n",
    "space": " ",
    "tab": "\t",
    "return": "\r",
    "backspace": "\b",
    "formfeed": "\f",
}
_STR_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    '"': '"',
    "\\": "\\",
    "b": "\b",
    "f": "\f",
}


class _Reader:
    def __init__(self, s: str):
        self.s = s
        self.i = 0
        self.n = len(s)

    def _skip_ws(self):
        s, n = self.s, self.n
        while self.i < n:
            c = s[self.i]
            if c in _WS:
                self.i += 1
            elif c == ";":
                while self.i < n and s[self.i] != "\n":
                    self.i += 1
            elif c == "#" and self.i + 1 < n and s[self.i + 1] == "_":
                self.i += 2
                self.read()  # discard next form
            else:
                return

    def eof(self) -> bool:
        self._skip_ws()
        return self.i >= self.n

    def read(self) -> Any:
        self._skip_ws()
        if self.i >= self.n:
            raise EOFError("EDN: unexpected end of input")
        c = self.s[self.i]
        if c == "(":
            return self._read_seq(")")
        if c == "[":
            return self._read_seq("]")
        if c == "{":
            return self._read_map()
        if c == '"':
            return self._read_string()
        if c == ":":
            return self._read_keyword()
        if c == "\\":
            return self._read_char()
        if c == "#":
            return self._read_dispatch()
        return self._read_atom()

    def _read_seq(self, close: str) -> list:
        self.i += 1
        out = []
        while True:
            self._skip_ws()
            if self.i >= self.n:
                raise EOFError(f"EDN: unterminated sequence, expected {close}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            out.append(self.read())

    def _read_map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self._skip_ws()
            if self.i >= self.n:
                raise EOFError("EDN: unterminated map")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            k = self.read()
            v = self.read()
            out[_freeze(k)] = v

    def _read_string(self) -> str:
        self.i += 1
        buf = io.StringIO()
        s, n = self.s, self.n
        while self.i < n:
            c = s[self.i]
            if c == '"':
                self.i += 1
                return buf.getvalue()
            if c == "\\":
                self.i += 1
                if self.i >= n:
                    raise EOFError("EDN: unterminated string")
                e = s[self.i]
                if e == "u":
                    hexs = s[self.i + 1 : self.i + 5]
                    if len(hexs) < 4:
                        raise EOFError("EDN: unterminated string")
                    buf.write(chr(int(hexs, 16)))
                    self.i += 5
                    continue
                buf.write(_STR_ESCAPES.get(e, e))
                self.i += 1
            else:
                buf.write(c)
                self.i += 1
        raise EOFError("EDN: unterminated string")

    def _read_keyword(self) -> Keyword:
        self.i += 1
        return Keyword(self._read_token())

    def _read_char(self) -> str:
        self.i += 1
        tok = self._read_token()
        if len(tok) == 1:
            return tok
        if tok in _CHAR_NAMES:
            return _CHAR_NAMES[tok]
        if tok.startswith("u"):
            return chr(int(tok[1:], 16))
        raise ValueError(f"EDN: bad char literal \\{tok}")

    def _read_dispatch(self) -> Any:
        self.i += 1
        c = self.s[self.i]
        if c == "{":  # set
            return frozenset(_freeze(x) for x in self._read_seq_set())
        # tagged literal
        tag = self._read_token()
        value = self.read()
        return Tagged(tag, value)

    def _read_seq_set(self) -> list:
        return self._read_seq("}")

    def _read_token(self) -> str:
        start = self.i
        s, n = self.s, self.n
        while self.i < n and s[self.i] not in _WS and s[self.i] not in _DELIM:
            self.i += 1
        return s[start : self.i]

    def _read_atom(self) -> Any:
        tok = self._read_token()
        if tok == "nil":
            return None
        if tok == "true":
            return True
        if tok == "false":
            return False
        c = tok[0]
        if c.isdigit() or (c in "+-" and len(tok) > 1 and tok[1].isdigit()):
            return _parse_num(tok)
        return Symbol(tok)


def _parse_num(tok: str):
    t = tok
    if t.endswith("N") or t.endswith("M"):
        t = t[:-1]
    if "/" in t:  # ratio -> float
        num, den = t.split("/")
        return int(num) / int(den)
    try:
        if any(ch in t for ch in ".eE") and not t.startswith("0x"):
            return float(t)
        return int(t, 0) if t.startswith(("0x", "-0x")) else int(t)
    except ValueError:
        return float(t)


def _freeze(x: Any) -> Any:
    """Make a parsed form hashable so it can be a map key / set element."""
    if isinstance(x, list):
        return tuple(_freeze(e) for e in x)
    if isinstance(x, dict):
        return tuple(sorted(((k, _freeze(v)) for k, v in x.items()), key=repr))
    return x


# ---------------------------------------------------------------- public API


def loads(s: str) -> Any:
    """Parse a single EDN form."""
    return _Reader(s).read()


def loads_all(s: str) -> list:
    """Parse every form in the string (e.g. a whole history.edn file)."""
    r = _Reader(s)
    out = []
    while not r.eof():
        out.append(r.read())
    return out


def iter_forms(s: str) -> Iterator[Any]:
    r = _Reader(s)
    while not r.eof():
        yield r.read()


def dumps(x: Any) -> str:
    buf = io.StringIO()
    _write(x, buf)
    return buf.getvalue()


def _write(x: Any, w: io.StringIO):
    if x is None:
        w.write("nil")
    elif x is True:
        w.write("true")
    elif x is False:
        w.write("false")
    elif isinstance(x, Keyword):
        w.write(":" + x.name)
    elif isinstance(x, Symbol):
        w.write(x.name)
    elif isinstance(x, str):
        w.write('"')
        w.write(
            x.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        )
        w.write('"')
    elif isinstance(x, (int, float)):
        w.write(repr(x))
    elif isinstance(x, Tagged):
        w.write(f"#{x.tag} ")
        _write(x.value, w)
    elif isinstance(x, dict):
        w.write("{")
        first = True
        for k, v in x.items():
            if not first:
                w.write(", ")
            first = False
            _write(k, w)
            w.write(" ")
            _write(v, w)
        w.write("}")
    elif isinstance(x, (frozenset, set)):
        w.write("#{")
        w.write(" ".join(dumps(e) for e in x))
        w.write("}")
    elif isinstance(x, (list, tuple)):
        w.write("[")
        w.write(" ".join(dumps(e) for e in x))
        w.write("]")
    else:
        # fall back to string representation
        _write(str(x), w)
