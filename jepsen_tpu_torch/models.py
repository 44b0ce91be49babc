"""Consistency models (knossos.model equivalents).

A model is an immutable object with `step(op) -> model'` raising/returning
`Inconsistent` when the op cannot apply — exactly the knossos.model
contract the reference consumes (`model/step`, `model/inconsistent?` at
jepsen/src/jepsen/checker.clj:230-233; `model/cas-register` at
tendermint/src/jepsen/tendermint/core.clj:363).

Two tiers:

  * Host models (`Register`, `CASRegister`, `Mutex`, `UnorderedQueue`,
    `FIFOQueue`, `GSet`) — general Python objects, used by the CPU
    reference checker (`jepsen_tpu_torch.checker.wgl`) and by simple checkers
    like `checker.queue`.

  * Packed models — fixed-width integer state + an elementwise torch
    step function, the device tier (`jepsen_tpu_torch.parallel.steps`:
    step(state, op) -> (state', ok); state packed into fixed-width
    ints). `pack_spec(model)` returns a `PackedSpec` when the model
    family is device-packable; the linearizability dispatcher falls
    back to the host checker otherwise (SURVEY.md §7.3 hard part #4).

A copy of `jepsen_tpu.models`, kept so that the port imports nothing of
the JAX package; encodings and reprs must stay identical to it.

Op convention for model steps: ops are `history.Op`-like with .f and
.value; read ops carry the *returned* value (filled by
`History.complete()`), or None when unknown (crashed reads).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np


class Inconsistent:
    """The op cannot be applied to this state (knossos.model/inconsistent)."""

    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"

    def __eq__(self, other):
        return isinstance(other, Inconsistent)

    def __hash__(self):
        return hash("Inconsistent")


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


class Model:
    """Base: immutable; subclasses implement step and value-based equality."""

    def step(self, op) -> "Model | Inconsistent":
        raise NotImplementedError

    # Subclasses must be hashable on their state — the visited cache
    # (both host DFS and device hash set) depends on it.


@dataclass(frozen=True)
class Register(Model):
    """A single read/write register (knossos.model/register)."""

    value: Any = None

    def step(self, op):
        if op.f == "write":
            return Register(op.value)
        if op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(f"read {op.value!r} from register {self.value!r}")
        return inconsistent(f"unknown op f={op.f}")


@dataclass(frozen=True)
class CASRegister(Model):
    """Read/write/compare-and-set register (knossos.model/cas-register) —
    the model of the Tendermint cas-register workload
    (tendermint/src/jepsen/tendermint/core.clj:363)."""

    value: Any = None

    def step(self, op):
        if op.f == "write":
            return CASRegister(op.value)
        if op.f == "cas":
            if op.value is None:
                return self  # crashed CAS with unknown args: can't constrain
            old, new = op.value
            if self.value == old:
                return CASRegister(new)
            return inconsistent(f"cas {old!r}->{new!r} on {self.value!r}")
        if op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(f"read {op.value!r} from {self.value!r}")
        return inconsistent(f"unknown op f={op.f}")


@dataclass(frozen=True)
class Mutex(Model):
    """Lock with acquire/release (knossos.model/mutex)."""

    locked: bool = False

    def step(self, op):
        if op.f == "acquire":
            if self.locked:
                return inconsistent("acquire on locked mutex")
            return Mutex(True)
        if op.f == "release":
            if not self.locked:
                return inconsistent("release on unlocked mutex")
            return Mutex(False)
        return inconsistent(f"unknown op f={op.f}")


@dataclass(frozen=True)
class UnorderedQueue(Model):
    """Queue where dequeue may return any pending element
    (knossos.model/unordered-queue, used by the reference's queue checker
    test, jepsen/test/jepsen/checker_test.clj:70)."""

    pending: frozenset = frozenset()  # of (value, count) — multiset as tuples

    @staticmethod
    def of(*vals):
        from collections import Counter
        return UnorderedQueue(frozenset(Counter(vals).items()))

    def _counter(self):
        from collections import Counter
        return Counter(dict(self.pending))

    def step(self, op):
        c = self._counter()
        if op.f == "enqueue":
            c[op.value] += 1
            return UnorderedQueue(frozenset(c.items()))
        if op.f == "dequeue":
            if op.value is None:
                return self  # unknown dequeue result: unconstrained
            if c.get(op.value, 0) > 0:
                c[op.value] -= 1
                if c[op.value] == 0:
                    del c[op.value]
                return UnorderedQueue(frozenset(c.items()))
            return inconsistent(f"dequeue {op.value!r} not pending")
        return inconsistent(f"unknown op f={op.f}")


@dataclass(frozen=True)
class FIFOQueue(Model):
    """Strict FIFO queue (knossos.model/fifo-queue)."""

    items: tuple = ()

    def step(self, op):
        if op.f == "enqueue":
            return FIFOQueue(self.items + (op.value,))
        if op.f == "dequeue":
            if not self.items:
                return inconsistent("dequeue from empty queue")
            head, rest = self.items[0], self.items[1:]
            if op.value is None or head == op.value:
                return FIFOQueue(rest)
            return inconsistent(f"dequeue {op.value!r}, head is {head!r}")
        return inconsistent(f"unknown op f={op.f}")


@dataclass(frozen=True)
class GSet(Model):
    """Grow-only set with add/read (knossos.model/set)."""

    items: frozenset = frozenset()

    def step(self, op):
        if op.f == "add":
            return GSet(self.items | {op.value})
        if op.f == "read":
            if op.value is None:
                return self
            got = frozenset(op.value)
            if got == self.items:
                return self
            return inconsistent(
                f"read {sorted(got, key=repr)} != {sorted(self.items, key=repr)}"
            )
        return inconsistent(f"unknown op f={op.f}")


# Clojure-flavoured constructors matching knossos.model names
def register(value=None):
    return Register(value)


def cas_register(value=None):
    return CASRegister(value)


def mutex():
    return Mutex()


def unordered_queue():
    return UnorderedQueue()


def fifo_queue():
    return FIFOQueue()


def gset():
    return GSet()


# =====================================================================
# Packed (device) tier
# =====================================================================

# f-codes shared by host encoder and device step functions
F_READ, F_WRITE, F_CAS, F_ACQUIRE, F_RELEASE = 0, 1, 2, 3, 4
F_ADD, F_ENQ, F_DEQ = 5, 6, 7


@dataclass
class PackedSpec:
    """Device encoding of a model family.

    state0        initial state as int32
    f_codes       map f-name -> small int code
    encode_call   (f, invoke_value, result, crashed) ->
                  (f_code, arg0, arg1, wildcard) ints; values interned via
                  the supplied Intern table
    step_name     key into jepsen_tpu_torch.parallel.steps registry of
                  elementwise step functions step(state, f, a0, a1,
                  wild) -> (state', ok) — kept as a name so specs stay
                  picklable.
    """

    state0: int
    step_name: str
    encode_call: Callable[..., Tuple[int, int, int, bool]]
    f_codes: dict
    # optional bulk hook: (calls) -> (f, a0, a1, wild) numpy arrays —
    # row i identical to encode_call(calls[i].f, .value, .result,
    # .crashed), including the interning ORDER (encode() must produce
    # the same arrays whichever path runs). Exists because the
    # per-call Python loop is the measured constant on the batched
    # end-to-end path (PERF_R05: encode-bound, not search-bound); the
    # bulk form preallocates the arrays and keeps the dispatch
    # overhead to one call per history instead of one per op.
    encode_calls: Callable = None
    # dense-engine state domain: states are the contiguous ints
    # [state_lo, state_lo + n_states(intern)); register family uses
    # interned value codes with nil = -1, mutex uses {0, 1}
    state_lo: int = -1
    n_states: Callable = None  # (intern) -> int
    # (packed state, intern) -> Model instance at that state — lets the
    # host seed a re-search from a device frontier checkpoint
    # (counterexample extraction for long histories)
    unpack_state: Callable = None
    # optional pre-pass over the full (pruned) call list, run by
    # encode() before any encode_call: models whose packing needs
    # global knowledge of the history (GSet element lanes, queue count
    # widths) build their tables here and may raise EncodeError to
    # send the history to the host engine
    prepare: Callable = None


def pack_spec(model: Model, intern) -> Optional[PackedSpec]:
    """Return the PackedSpec for device-packable models, else None.

    Packable today — all six knossos model families: Register /
    CASRegister (state = interned value id, nil = -1), Mutex (state =
    0/1), GSet (state = element bitmask, up to 31 distinct elements),
    UnorderedQueue (state = packed count lanes, up to 31 total bits),
    and FIFOQueue (state = v-bit value-code lanes, head at the low
    bits, depth bound x width <= 31). GSet/queue packing is
    history-bounded, not unbounded: their `prepare` pass sizes the
    state from the actual call list and raises EncodeError past the
    31-bit budget, falling back to the host checker (SURVEY.md §7.3 #4).
    """
    if isinstance(model, (Register, CASRegister)):
        state0 = intern.code(model.value)

        def encode_call(f, value, result, crashed):
            if f == "read":
                # reads learn their value at completion; crashed/nil reads
                # are wildcards (any state linearizes them)
                v = result if result is not None else value
                if crashed or v is None:
                    return (F_READ, -1, -1, True)
                return (F_READ, intern.code(v), -1, False)
            if f == "write":
                if value is None:
                    return (F_READ, -1, -1, True)  # unknown write: no-op? —
                    # a write with unknown value can't occur in practice;
                    # treat as wildcard read to stay sound-ish
                return (F_WRITE, intern.code(value), -1, False)
            if f == "cas":
                if value is None:
                    return (F_READ, -1, -1, True)
                old, new = value
                return (F_CAS, intern.code(old), intern.code(new), False)
            raise ValueError(f"register family: unknown f {f!r}")

        def encode_calls(cs):
            # bulk row-wise mirror of encode_call — same branches, same
            # interning order (read interns only when constraining).
            # Accumulates in Python lists and converts once at the end:
            # per-element numpy stores cost more than the whole row's
            # logic, and the per-call tuple + function call are the
            # measured overhead this hook exists to remove
            # (tools/perf_encode.py).
            fs, a0, a1, wild = [], [], [], []
            code = intern.code
            for c in cs:
                cf = c.f
                w = False
                x0 = x1 = -1
                if cf == "read":
                    v = c.result if c.result is not None else c.value
                    fc = F_READ
                    if c.crashed or v is None:
                        w = True
                    else:
                        x0 = code(v)
                elif cf == "write":
                    if c.value is None:
                        fc = F_READ
                        w = True
                    else:
                        fc = F_WRITE
                        x0 = code(c.value)
                elif cf == "cas":
                    if c.value is None:
                        fc = F_READ
                        w = True
                    else:
                        old, new = c.value
                        fc = F_CAS
                        x0 = code(old)
                        x1 = code(new)
                else:
                    raise ValueError(f"register family: unknown f {cf!r}")
                fs.append(fc)
                a0.append(x0)
                a1.append(x1)
                wild.append(w)
            return (np.array(fs, np.int32), np.array(a0, np.int32),
                    np.array(a1, np.int32), np.array(wild, bool))

        cls = type(model)
        return PackedSpec(
            state0=state0,
            step_name="register",
            encode_call=encode_call,
            encode_calls=encode_calls,
            f_codes={"read": F_READ, "write": F_WRITE, "cas": F_CAS},
            state_lo=-1,
            n_states=lambda intern: len(intern) + 1,
            unpack_state=lambda code, intern: cls(intern.value(code)),
        )

    if isinstance(model, Mutex):
        def encode_call(f, value, result, crashed):
            if f == "acquire":
                return (F_ACQUIRE, -1, -1, False)
            if f == "release":
                return (F_RELEASE, -1, -1, False)
            raise ValueError(f"mutex: unknown f {f!r}")

        def encode_calls(cs):
            fs = []
            for c in cs:
                if c.f == "acquire":
                    fs.append(F_ACQUIRE)
                elif c.f == "release":
                    fs.append(F_RELEASE)
                else:
                    raise ValueError(f"mutex: unknown f {c.f!r}")
            n = len(cs)
            return (np.array(fs, np.int32), np.full(n, -1, np.int32),
                    np.full(n, -1, np.int32), np.zeros(n, bool))

        return PackedSpec(
            state0=1 if model.locked else 0,
            step_name="mutex",
            encode_call=encode_call,
            encode_calls=encode_calls,
            f_codes={"acquire": F_ACQUIRE, "release": F_RELEASE},
            state_lo=0,
            n_states=lambda intern: 2,
            unpack_state=lambda code, intern: Mutex(bool(code)),
        )

    if isinstance(model, GSet):
        return _gset_spec(model)

    if isinstance(model, UnorderedQueue):
        return _uqueue_spec(model)

    if isinstance(model, FIFOQueue):
        return _fifo_spec(model)

    return None


def _encode_error(msg: str):
    from jepsen_tpu_torch.parallel.encode import EncodeError
    return EncodeError(msg)


def _gset_spec(model: "GSet") -> PackedSpec:
    """GSet packing: state IS the element bitmask. Lanes (element ->
    bit) are assigned by `prepare` from the history — adds first, then
    read sets — so the device step sees only small ints."""
    lanes: dict = {}

    def prepare(cs, intern):
        elems = list(model.items)
        for c in cs:
            # None is an ordinary addable element (the host model adds
            # it literally, and reads observe it) — lane like any other
            if c.f == "add":
                elems.append(c.value)
        for c in cs:
            if c.f == "read" and not c.crashed and c.result is not None:
                elems.extend(c.result)
        lanes.clear()
        try:
            for v in elems:
                if v not in lanes:
                    lanes[v] = len(lanes)
        except TypeError as err:  # unhashable element
            raise _encode_error(f"gset element not hashable: {err}")
        if len(lanes) > 31:
            raise _encode_error(
                f"gset has {len(lanes)} distinct elements; the packed "
                f"bitmask state holds 31 — use the host engine")
        spec.state0 = _gset_mask(model.items)

    def _gset_mask(items):
        m = 0
        for v in items:
            m |= 1 << lanes[v]
        return m

    def encode_call(f, value, result, crashed):
        if f == "add":
            return (F_ADD, lanes[value], -1, False)
        if f == "read":
            v = result if not crashed else None
            if v is None:
                return (F_READ, -1, -1, True)
            return (F_READ, _gset_mask(v), -1, False)
        raise ValueError(f"gset: unknown f {f!r}")

    def encode_calls(cs):
        fs, a0, wild = [], [], []
        for c in cs:
            if c.f == "add":
                fs.append(F_ADD)
                a0.append(lanes[c.value])
                wild.append(False)
            elif c.f == "read":
                v = c.result if not c.crashed else None
                fs.append(F_READ)
                if v is None:
                    a0.append(-1)
                    wild.append(True)
                else:
                    a0.append(_gset_mask(v))
                    wild.append(False)
            else:
                raise ValueError(f"gset: unknown f {c.f!r}")
        return (np.array(fs, np.int32), np.array(a0, np.int32),
                np.full(len(cs), -1, np.int32), np.array(wild, bool))

    def unpack_state(code, intern):
        return GSet(frozenset(v for v, b in lanes.items()
                              if (code >> b) & 1))

    spec = PackedSpec(
        state0=0,  # finalized by prepare (needs the lane table)
        step_name="gset",
        encode_call=encode_call,
        encode_calls=encode_calls,
        f_codes={"add": F_ADD, "read": F_READ},
        state_lo=0,
        n_states=lambda intern: 1 << len(lanes),
        unpack_state=unpack_state,
        prepare=prepare,
    )
    return spec


def _fifo_spec(model: "FIFOQueue") -> PackedSpec:
    """FIFOQueue packing: the queue IS the state — v-bit value-code
    lanes (code 0 = empty, codes 1..K assigned by `prepare`), head at
    the low bits, depth implicit in the bit length. `prepare` proves a
    depth bound B = initial depth + max over event positions of
    (enqueues invoked so far - ok-dequeues completed so far): any
    config reachable at any return event holds <= B elements (a
    completed dequeue must have linearized; an open enqueue may have),
    so B*v <= 31 guarantees enqueue shifts stay inside the int32.
    Past that budget the history goes to the host engine."""
    lanes: dict = {}        # value -> code 1..K
    width = [0]             # v bits per lane
    bound = [0]

    def prepare(cs, intern):
        try:
            for v in model.items:
                if v not in lanes:
                    lanes[v] = len(lanes) + 1
            for c in cs:
                # None is an ordinary enqueueable value (the host model
                # appends it literally), so it gets a lane like any other
                if c.f == "enqueue":
                    if c.value not in lanes:
                        lanes[c.value] = len(lanes) + 1
                elif c.f == "dequeue" and not c.crashed \
                        and c.result is not None:
                    if c.result not in lanes:
                        lanes[c.result] = len(lanes) + 1
        except TypeError as err:
            raise _encode_error(f"fifo element not hashable: {err}")
        width[0] = max(1, len(lanes).bit_length())
        events = []
        for c in cs:
            if c.f == "enqueue":
                events.append((c.invoke_index, 1))
            elif c.f == "dequeue" and not c.crashed:
                events.append((c.complete_index, -1))
        events.sort()
        depth = peak = len(model.items)
        for _, d in events:
            depth += d
            peak = max(peak, depth)
        bound[0] = max(1, peak)
        if bound[0] * width[0] > 31:
            raise _encode_error(
                f"fifo needs {bound[0]} lanes x {width[0]} bits; the "
                f"packed state holds 31 — use the host engine")
        s0 = 0
        for i, v in enumerate(model.items):
            s0 |= lanes[v] << (i * width[0])
        spec.state0 = s0

    def encode_call(f, value, result, crashed):
        if f == "enqueue":
            return (F_ENQ, lanes[value], width[0], False)
        if f == "dequeue":
            # dequeues are completion-valued; a crashed dequeue's result
            # is unknown regardless of its invoke value (the host oracle
            # sets value=None for crashed dequeues, wgl._StepOp) and
            # pops ANY head — match-any, not a wildcard identity
            v = None if crashed else result
            if v is None:
                return (F_DEQ, -1, width[0], False)
            return (F_DEQ, lanes[v], width[0], False)
        raise ValueError(f"fifo-queue: unknown f {f!r}")

    def encode_calls(cs):
        fs, a0 = [], []
        for c in cs:
            if c.f == "enqueue":
                fs.append(F_ENQ)
                a0.append(lanes[c.value])
            elif c.f == "dequeue":
                v = None if c.crashed else c.result
                fs.append(F_DEQ)
                a0.append(-1 if v is None else lanes[v])
            else:
                raise ValueError(f"fifo-queue: unknown f {c.f!r}")
        n = len(cs)
        return (np.array(fs, np.int32), np.array(a0, np.int32),
                np.full(n, width[0], np.int32), np.zeros(n, bool))

    def unpack_state(code, intern):
        by_code = {c: v for v, c in lanes.items()}
        items = []
        v = width[0]
        while code:
            items.append(by_code[code & ((1 << v) - 1)])
            code >>= v
        return FIFOQueue(tuple(items))

    spec = PackedSpec(
        state0=0,  # finalized by prepare
        step_name="fifo",
        encode_call=encode_call,
        encode_calls=encode_calls,
        f_codes={"enqueue": F_ENQ, "dequeue": F_DEQ},
        state_lo=0,
        n_states=lambda intern: 1 << (bound[0] * width[0]),
        unpack_state=unpack_state,
        prepare=prepare,
    )
    return spec


def _uqueue_spec(model: "UnorderedQueue") -> PackedSpec:
    """UnorderedQueue packing: one count lane per distinct value, width
    sized by `prepare` from the history's total enqueues (plus initial
    pending) — counts can never overflow their lane by construction.
    lanes maps value -> (bit offset, unshifted mask)."""
    lanes: dict = {}
    total_bits = [0]

    def prepare(cs, intern):
        from collections import Counter
        cap: Counter = Counter()
        try:
            for v, k in model.pending:
                cap[v] += k
            for c in cs:
                if c.f == "enqueue" and c.value is not None:
                    cap[c.value] += 1
            for c in cs:
                if c.f == "dequeue":
                    v = c.value if c.crashed else c.result
                    if v is not None and v not in cap:
                        cap[v] = 0  # dequeue-only value: 1-bit zero lane
        except TypeError as err:
            raise _encode_error(f"queue element not hashable: {err}")
        lanes.clear()
        off = 0
        for v, k in cap.items():
            w = max(1, int(k).bit_length())
            lanes[v] = (off, (1 << w) - 1)
            off += w
        if off > 31:
            raise _encode_error(
                f"queue count lanes need {off} bits; the packed state "
                f"holds 31 — use the host engine")
        total_bits[0] = off
        s0 = 0
        for v, k in model.pending:
            s0 += k << lanes[v][0]
        spec.state0 = s0

    def encode_call(f, value, result, crashed):
        if f == "enqueue":
            if value is None:
                return (F_READ, -1, -1, True)
            o, m = lanes[value]
            return (F_ENQ, o, m, False)
        if f == "dequeue":
            # completion-valued: the dequeued element is learned at ok;
            # unknown results are unconstrained. A crashed dequeue's
            # result is unknown REGARDLESS of its invoke value (the
            # host oracle sets value=None for crashed dequeues,
            # wgl._StepOp) — constraining on the invoke value would
            # report false violations the host accepts
            v = None if crashed else result
            if v is None:
                return (F_READ, -1, -1, True)
            o, m = lanes[v]
            return (F_DEQ, o, m, False)
        raise ValueError(f"unordered-queue: unknown f {f!r}")

    def encode_calls(cs):
        fs, a0, a1, wild = [], [], [], []
        for c in cs:
            w = False
            x0 = x1 = -1
            if c.f == "enqueue":
                if c.value is None:
                    fc = F_READ
                    w = True
                else:
                    fc = F_ENQ
                    x0, x1 = lanes[c.value]
            elif c.f == "dequeue":
                v = None if c.crashed else c.result
                if v is None:
                    fc = F_READ
                    w = True
                else:
                    fc = F_DEQ
                    x0, x1 = lanes[v]
            else:
                raise ValueError(f"unordered-queue: unknown f {c.f!r}")
            fs.append(fc)
            a0.append(x0)
            a1.append(x1)
            wild.append(w)
        return (np.array(fs, np.int32), np.array(a0, np.int32),
                np.array(a1, np.int32), np.array(wild, bool))

    def unpack_state(code, intern):
        items = []
        for v, (o, m) in lanes.items():
            k = (code >> o) & m
            if k:
                items.append((v, k))
        return UnorderedQueue(frozenset(items))

    spec = PackedSpec(
        state0=0,  # finalized by prepare
        step_name="uqueue",
        encode_call=encode_call,
        encode_calls=encode_calls,
        f_codes={"enqueue": F_ENQ, "dequeue": F_DEQ},
        state_lo=0,
        n_states=lambda intern: 1 << total_bits[0],
        unpack_state=unpack_state,
        prepare=prepare,
    )
    return spec
