"""Operation histories: schema, canonicalisation, call pairing.

The history is the framework's central artifact: an ordered list of ops

    {:index i, :time nanos, :process p, :type t, :f f, :value v}

exactly the schema the reference produces (op contract documented at
jepsen/src/jepsen/generator.clj:371-380 and knossos.history, used by
jepsen/src/jepsen/core.clj:230 `history/index`). Types:

    invoke  a client begins an operation
    ok      it completed and took effect
    fail    it completed and did NOT take effect
    info    indeterminate (crashed) — may or may not have taken effect;
            the process is dead and its op stays concurrent with
            everything after it (knossos crash semantics)

This module provides:
  * `Op` — a dict with attribute access (op.type, op["type"] both work),
  * `History` — a list of ops + canonicalisation (index/pair/complete,
    the knossos.history equivalents) and the EDN reader,
  * `calls()` — invocation/completion pairing into `Call` records, the
    input to linearizability checking,
  * `Intern` — the value <-> int table the encoder packs values with.

A trimmed copy of `jepsen_tpu.history`: what the port's checker uses,
and `op_to_edn_str`, the one-op writer the service's WAL stores ops
with. The history writers, the query helpers and the columnar and npz
codecs are left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

from jepsen_tpu_torch import edn
from jepsen_tpu_torch.edn import Keyword

TYPES = ("invoke", "ok", "fail", "info")

NEMESIS = "nemesis"  # the nemesis pseudo-process


class Op(dict):
    """An operation: a dict with attribute sugar.

    Extra keys (:error, :debug, anything a client attaches) ride along,
    matching the reference's open-map ops.
    """

    __slots__ = ()

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            if k in ("index", "time", "process", "type", "f", "value", "error"):
                return None
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v

    # -- predicates (knossos.op equivalents: invoke?/ok?/fail?/info?,
    #    used pervasively e.g. jepsen/src/jepsen/checker.clj:154-156)
    @property
    def is_invoke(self):
        return self.get("type") == "invoke"

    @property
    def is_ok(self):
        return self.get("type") == "ok"

    @property
    def is_fail(self):
        return self.get("type") == "fail"

    @property
    def is_info(self):
        return self.get("type") == "info"

    def __repr__(self):
        core = {k: self.get(k) for k in ("index", "type", "process", "f", "value")
                if k in self}
        extra = {k: v for k, v in self.items() if k not in core}
        core.update(extra)
        inner = ", ".join(f"{k}={v!r}" for k, v in core.items())
        return f"Op({inner})"


# --------------------------------------------------------------- conversion


def _from_edn(x: Any) -> Any:
    """EDN values -> plain Python. Keywords become strings."""
    if isinstance(x, Keyword):
        return x.name
    if isinstance(x, list):
        return [_from_edn(e) for e in x]
    if isinstance(x, tuple):
        return tuple(_from_edn(e) for e in x)
    if isinstance(x, dict):
        return {_from_edn(k): _from_edn(v) for k, v in x.items()}
    if isinstance(x, frozenset):
        return frozenset(_from_edn(e) for e in x)
    return x


def op_from_edn(form: dict) -> Op:
    return Op(_from_edn(form))


def op_to_edn_str(o: Op) -> str:
    """Render an op as the reference's EDN map (keyword keys; keyword-ish
    string values for :type/:f/:process where the reference uses keywords)."""
    parts = []
    for k, v in o.items():
        parts.append(":" + str(k))
        if k in ("type", "f") and isinstance(v, str):
            parts.append(":" + v)
        elif k == "process" and v == NEMESIS:
            parts.append(":nemesis")
        else:
            parts.append(edn.dumps(v))
    return "{" + ", ".join(
        f"{parts[i]} {parts[i+1]}" for i in range(0, len(parts), 2)
    ) + "}"


class History(list):
    """A list of `Op` with canonicalisation and the EDN reader."""

    # ------------------------------------------------------------- creation
    @classmethod
    def wrap(cls, ops: Iterable) -> "History":
        h = cls()
        for o in ops:
            h.append(o if isinstance(o, Op) else Op(o))
        return h

    # ----------------------------------------------------------------- IO
    @classmethod
    def from_edn(cls, text: str) -> "History":
        """Parse a reference-format history.edn (one op map per line, as
        written by jepsen/src/jepsen/store.clj:351-362)."""
        return cls.wrap(op_from_edn(f) for f in edn.iter_forms(text))

    # --------------------------------------------------------- canonicalise
    def index(self) -> "History":
        """Assign :index 0..n-1 in order (knossos.history/index, called at
        jepsen/src/jepsen/core.clj:230 before any checker runs)."""
        for i, o in enumerate(self):
            o["index"] = i
        return self

    def pairs(self) -> "History":
        """Pair invocations with completions: each op gets a :pair-index
        pointing at its counterpart (completion of the same process), or -1
        for unpaired ops (knossos.history pairing semantics).

        A process executes at most one op at a time, so matching is by
        process: an invoke pairs with the next ok/fail/info of the same
        process. Nemesis ops pair the same way.
        """
        if any(o.get("index") is None for o in self):
            self.index()
        open_by_process: dict = {}
        for o in self:
            p = o.get("process")
            if o.is_invoke:
                o["pair-index"] = -1
                open_by_process[p] = o
            else:
                inv = open_by_process.pop(p, None)
                if inv is not None:
                    inv["pair-index"] = o["index"]
                    o["pair-index"] = inv["index"]
                else:
                    o["pair-index"] = -1
        return self

    def complete(self) -> "History":
        """knossos.history/complete semantics (used by the reference at
        jepsen/src/jepsen/checker.clj:756 and checker/timeline.clj:172):
        fill each invocation's :value from its ok completion when the
        invocation's value is nil (reads learn their value at completion).
        """
        self.pairs()
        by_index = {o["index"]: o for o in self if o.get("index") is not None}
        for o in self:
            if o.is_invoke and o.get("pair-index", -1) >= 0:
                comp = by_index[o["pair-index"]]
                if comp.is_ok and o.get("value") is None:
                    o["value"] = comp.get("value")
        return self

# ------------------------------------------------------------------- Calls


@dataclass
class Call:
    """An invocation/completion pair — the unit of linearizability checking.

    crashed=True means the completion was :info (or missing): the op may or
    may not have taken effect and stays concurrent with the rest of the
    history (knossos crash semantics — SURVEY.md §7.3 hard part #2).
    """

    index: int          # dense call id, 0..m-1 in invocation order
    process: Any
    f: str
    value: Any          # invocation value (args)
    result: Any         # completion value (None if crashed)
    invoke_index: int   # position of invocation in the history
    complete_index: int # position of completion; crashed -> len(history)
    crashed: bool

    def __repr__(self):
        tail = " CRASHED" if self.crashed else f" -> {self.result!r}"
        return f"Call#{self.index}(p{self.process} {self.f} {self.value!r}{tail})"


def calls(history: History, drop_failed: bool = True) -> list:
    """Pair invocations with completions into Call records.

    With drop_failed (the default), failed ops are dropped — they did not
    take effect (knossos `without-failures` preprocessing); otherwise they
    are kept with failed=True. Nemesis and non-client ops are skipped.
    Crashed (:info) calls get complete_index = len(history).
    """
    n = len(history)
    open_by_process: dict = {}
    out: list = []
    failed: set = set()
    for i, o in enumerate(history):
        p = o.get("process")
        if not isinstance(p, int):
            continue
        if o.is_invoke:
            c = Call(
                index=-1, process=p, f=o.get("f"), value=o.get("value"),
                result=None, invoke_index=i, complete_index=n, crashed=True,
            )
            open_by_process[p] = c
            out.append(c)
        else:
            c = open_by_process.pop(p, None)
            if c is None:
                continue
            if o.is_ok:
                c.result = o.get("value")
                c.complete_index = i
                c.crashed = False
            elif o.is_fail:
                c.complete_index = i
                c.crashed = False
                failed.add(id(c))
    if drop_failed:
        out = [c for c in out if id(c) not in failed]
    for j, c in enumerate(out):
        c.index = j
    return out


def prune_wildcard_calls(cs: list) -> list:
    """Drop calls that cannot constrain a linearizability search: crashed
    reads. A crashed read's value is unknown, so its model step is the
    identity and always succeeds — it may be linearized at any point or
    never, and removing it is sound. This avoids exponential blowup from
    forever-open crashed calls (each open crashed call doubles the
    frontier's mask space; cf. the reference's tractability caps,
    jepsen/src/jepsen/tests/linearizable_register.clj:30-32). Crashed
    mutating ops (writes, cas, acquire/release, dequeue) must stay — even
    value-less ones mutate state. Re-numbers the surviving dense indices."""
    out = [c for c in cs if not (c.crashed and c.f == "read")]
    for j, c in enumerate(out):
        c.index = j
    return out


# ----------------------------------------------------------------- Intern


class Intern:
    """Bidirectional value <-> int table. nil is always code -1."""

    def __init__(self):
        self._to_code: dict = {}
        self._values: list = []

    def code(self, v) -> int:
        if v is None:
            return -1
        key = _hashable(v)
        c = self._to_code.get(key)
        if c is None:
            c = len(self._values)
            self._to_code[key] = c
            self._values.append(v)
        return c

    def value(self, code: int):
        return None if code < 0 else self._values[code]

    def __len__(self):
        return len(self._values)


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(e) for e in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, set):
        return frozenset(_hashable(e) for e in v)
    return v
