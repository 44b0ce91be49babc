"""Packed host linearizability engine — the honest CPU baseline.

Same JIT-linearization frontier as `checker.linear` (that docstring is
the spec), but configurations are plain ints — (packed model state,
linearized-open-slot bitmask) — produced by the SAME encoding the
device engines use (`parallel.encode`), and model steps are direct
integer functions mirroring `parallel.steps`. No Model objects, no
frozensets: the fastest fair CPU implementation of the search.

A copy of `jepsen_tpu.checker.linear_packed`, on the port's encoding:
the competition race's host arm for packable models, the quick host
path for histories whose windows are small, and a third differential
oracle for the device engines (same encoding, independent execution).
"""

from __future__ import annotations

import time as _time
from typing import Optional


def _py_steps(step_name: str):
    """Integer twins of parallel.steps — scalar Python, same contract:
    step(state, f, a0, a1, wild) -> (state', ok)."""
    from jepsen_tpu_torch.models import (
        F_ACQUIRE, F_ADD, F_CAS, F_DEQ, F_ENQ, F_READ, F_RELEASE, F_WRITE)

    if step_name == "register":
        def step(s, f, a0, a1, wild):
            if wild:
                return s, True
            if f == F_READ:
                return s, s == a0
            if f == F_WRITE:
                return a0, True
            if f == F_CAS:
                return (a1, True) if s == a0 else (s, False)
            return s, False
    elif step_name == "mutex":
        def step(s, f, a0, a1, wild):
            if wild:
                return s, True
            if f == F_ACQUIRE:
                return (1, True) if s == 0 else (s, False)
            if f == F_RELEASE:
                return (0, True) if s == 1 else (s, False)
            return s, False
    elif step_name == "gset":
        def step(s, f, a0, a1, wild):
            if wild:
                return s, True
            if f == F_ADD:
                return s | (1 << a0), True
            if f == F_READ:
                return s, s == a0
            return s, False
    elif step_name == "uqueue":
        def step(s, f, a0, a1, wild):
            if wild:
                return s, True
            if f == F_ENQ:
                return s + (1 << a0), True
            if f == F_DEQ:
                cnt = (s >> a0) & a1
                return (s - (1 << a0), True) if cnt > 0 else (s, False)
            return s, False
    elif step_name == "fifo":
        def step(s, f, a0, a1, wild):
            if wild:
                return s, True
            if f == F_ENQ:
                depth = (s.bit_length() + a1 - 1) // a1
                return s | (a0 << (a1 * depth)), True
            if f == F_DEQ:
                head = s & ((1 << a1) - 1)
                if head != 0 and (a0 < 0 or head == a0):
                    return s >> a1, True
                return s, False
            return s, False
    else:
        raise ValueError(f"no packed host step for {step_name!r}")
    return step


def check_encoded(e, max_configs: int = 2_000_000,
                  deadline: Optional[float] = None,
                  cancel=None) -> dict:
    """Run the frontier search over an EncodedHistory on the host with
    int configs. Same result shape as linear.check_calls (sans paths).
    `cancel` (a threading.Event) is polled wherever the deadline is: a
    competition race sets it when another arm already won."""
    def _stop():
        """Indecisive-return fields when the search must stop, else None
        ("timeout" for a blown deadline, "cancelled" for a lost race)."""
        if deadline is not None and _time.monotonic() > deadline:
            return {"valid?": "unknown", "timeout": True}
        if cancel is not None and cancel.is_set():
            return {"valid?": "unknown", "error": "cancelled"}
        return None
    from jepsen_tpu_torch.parallel.encode import fail_op_fields

    step = _py_steps(e.step_name)
    configs = {(int(e.state0), 0)}
    explored = 0
    max_frontier = 1
    R = e.n_returns
    # plain Python lists: per-element numpy scalar indexing in the hot
    # loop would slow the baseline and flatter the device comparison
    slot_f, slot_a0 = e.slot_f.tolist(), e.slot_a0.tolist()
    slot_a1, slot_wild = e.slot_a1.tolist(), e.slot_wild.tolist()
    slot_occ, ev_slot = e.slot_occ.tolist(), e.ev_slot.tolist()
    C = len(slot_f[0]) if R else 0

    for r in range(R):
        stop = _stop()
        if stop:
            return {**stop, "events-done": r,
                    "explored": explored, "max-frontier": max_frontier}
        occ = [(j, slot_f[r][j], slot_a0[r][j], slot_a1[r][j],
                slot_wild[r][j])
               for j in range(C) if slot_occ[r][j]]
        frontier = configs
        next_check = explored + 131072
        while frontier:
            new = set()
            for s, m in frontier:
                if explored >= next_check:
                    # stride deadline check: even ONE expansion round
                    # over a 2^k frontier must not overshoot unboundedly
                    next_check = explored + 131072
                    stop = _stop()
                    if stop:
                        return {**stop,
                                "events-done": r, "explored": explored,
                                "max-frontier": max(max_frontier,
                                                    len(configs))}
                for j, f, a0, a1, wild in occ:
                    bit = 1 << j
                    if m & bit:
                        continue
                    s2, ok = step(s, f, a0, a1, wild)
                    explored += 1
                    if not ok:
                        continue
                    cfg = (s2, m | bit)
                    if cfg not in configs and cfg not in new:
                        new.add(cfg)
            configs |= new
            frontier = new
            if len(configs) > max_configs:
                return {"valid?": "unknown",
                        "error": f"config budget exceeded ({max_configs})",
                        "events-done": r, "explored": explored,
                        "max-frontier": max(max_frontier, len(configs))}
            stop = _stop()
            if stop:
                # mid-window stop check: a single wide window's
                # expansion must not overshoot unboundedly
                return {**stop,
                        "events-done": r, "explored": explored,
                        "max-frontier": max(max_frontier, len(configs))}
        max_frontier = max(max_frontier, len(configs))
        bit = 1 << int(ev_slot[r])
        configs = {(s, m & ~bit) for s, m in configs if m & bit}
        if not configs:
            out = {"valid?": False, "explored": explored,
                   "max-frontier": max_frontier,
                   "final-paths": [], "configs": []}
            out.update(fail_op_fields(e, r))
            return out

    return {"valid?": True, "explored": explored,
            "max-frontier": max_frontier, "configs": [], "final-paths": []}


def analysis(model, history, max_configs: int = 2_000_000,
             deadline: Optional[float] = None, cancel=None) -> dict:
    """knossos-style (model, history) -> result, packed host engine.
    Raises EncodeError (via parallel.encode) for non-packable inputs —
    callers fall back to checker.linear / checker.wgl."""
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.parallel import encode as enc_mod
    h = history if isinstance(history, History) else History.wrap(history)
    e = enc_mod.encode(model, h)
    return check_encoded(e, max_configs=max_configs, deadline=deadline,
                         cancel=cancel)
