"""Elementwise torch model steps — the device tier of the port's models.

Each step has signature

    step(state: i32, f: i32, a0: i32, a1: i32, wild: bool) -> (state': i32, ok: bool)

on int32/bool tensors that broadcast against each other (the engine
applies them over events x slots x states at once). States and args are
interned int32s (nil = -1). `wild` marks calls whose outcome is unknown
(crashed reads): they apply as the identity and always succeed.

A port of `jepsen_tpu.parallel.steps`, branch-free like it: every
family is a chain of `torch.where` over the handful of f-codes
(models.F_*). Shifts go through `_shl`/`_sar`, which give the XLA
semantics for every shift amount (0 past the word for a left shift,
sign fill for a right shift), so the tables agree with the reference
bit for bit on any input, not only on the values an encoder produces.
"""

from __future__ import annotations

import torch

from jepsen_tpu_torch.models import (
    F_ACQUIRE, F_ADD, F_CAS, F_DEQ, F_ENQ, F_READ, F_RELEASE, F_WRITE,
)

_I32 = torch.int32


def _shl(x, n):
    """x << n with XLA's shift_left semantics: 0 when n is outside
    [0, 32)."""
    n = torch.as_tensor(n, dtype=_I32, device=x.device)
    out = x << n.clamp(0, 31)
    return torch.where((n < 0) | (n > 31), torch.zeros_like(out), out)


def _sar(x, n):
    """Arithmetic x >> n with XLA's semantics: sign fill when n is
    outside [0, 32)."""
    n = torch.as_tensor(n, dtype=_I32, device=x.device)
    return x >> torch.where((n < 0) | (n > 31), torch.full_like(n, 31), n)


def _bit_length(x):
    """32 - clz(x) for int32 x: 32 for negatives, 0 for zero."""
    pow2 = _shl(torch.ones(31, dtype=_I32, device=x.device),
                torch.arange(31, dtype=_I32, device=x.device))
    n = (x.unsqueeze(-1) >= pow2).sum(-1, dtype=_I32)
    return torch.where(x < 0, torch.full_like(n, 32), n)


def _i32(x, like):
    return torch.as_tensor(x, dtype=_I32, device=like.device)


def register_step(state, f, a0, a1, wild):
    """Register / CAS-register family (models.Register, models.CASRegister;
    knossos.model register/cas-register semantics).

    read  a0=observed value: ok iff wild or state == a0; state unchanged
    write a0=new value:      always ok; state = a0
    cas   a0=old, a1=new:    ok iff state == a0; state = a1
    """
    is_read = f == F_READ
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    ok = wild | (is_read & (state == a0)) | is_write | (is_cas & (state == a0))
    new_state = torch.where(
        wild | is_read, state,
        torch.where(is_write, a0, torch.where(is_cas, a1, state)))
    return torch.where(ok, new_state, state), ok


def mutex_step(state, f, a0, a1, wild):
    """Mutex (models.Mutex): state 0=unlocked, 1=locked."""
    is_acq = f == F_ACQUIRE
    is_rel = f == F_RELEASE
    ok = wild | (is_acq & (state == 0)) | (is_rel & (state == 1))
    new_state = torch.where(wild, state,
                            torch.where(is_acq, _i32(1, state),
                                        _i32(0, state)))
    return torch.where(ok, new_state, state), ok


def gset_step(state, f, a0, a1, wild):
    """Grow-only set (models.GSet; knossos.model/set): state is the
    element bitmask itself — bit b set iff element with lane b has been
    added.

    add  a0=element lane:        always ok; state |= 1 << a0
    read a0=observed-set mask:   ok iff wild or state == a0; unchanged
    """
    is_add = f == F_ADD
    is_read = f == F_READ
    bit = _shl(torch.ones_like(a0), a0.clamp(min=0))  # a0=-1 only on masked rows
    ok = wild | is_add | (is_read & (state == a0))
    new_state = torch.where(wild | is_read, state,
                            torch.where(is_add, state | bit, state))
    return torch.where(ok, new_state, state), ok


def uqueue_step(state, f, a0, a1, wild):
    """Unordered queue (models.UnorderedQueue; knossos.model/
    unordered-queue): state packs one count lane per distinct value —
    a0 is the lane's bit offset, a1 its unshifted mask.

    enqueue a0=offset:        always ok; count += 1
    dequeue a0=offset a1=mask: ok iff count > 0; count -= 1
    """
    is_enq = f == F_ENQ
    is_deq = f == F_DEQ
    off = a0.clamp(min=0)
    one = _shl(torch.ones_like(off), off)
    cnt = _sar(state, off) & a1
    ok = wild | is_enq | (is_deq & (cnt > 0))
    new_state = torch.where(
        wild, state,
        torch.where(is_enq, state + one,
                    torch.where(is_deq, state - one, state)))
    return torch.where(ok, new_state, state), ok


def fifo_step(state, f, a0, a1, wild):
    """Strict FIFO queue (models.FIFOQueue; knossos.model/fifo-queue):
    state is a sequence of v-bit value-code lanes, head at the LOW
    bits, code 0 = empty lane.

    enqueue a0=code a1=v:  always ok; state |= code << (v * depth)
    dequeue a0=code|-1 a1=v: ok iff head != 0 and (code < 0 or
                             head == code); state >>= v
    """
    is_enq = f == F_ENQ
    is_deq = f == F_DEQ
    v = a1.clamp(min=1)
    head = state & (_shl(torch.ones_like(v), v) - 1)
    bitlen = _bit_length(state)
    # floor division of non-negative ints; bitlen + v - 1 >= 0 always
    depth = torch.div(bitlen + v - 1, v, rounding_mode="floor")
    enq_state = state | _shl(a0.clamp(min=0), v * depth)
    deq_ok = (head != 0) & ((a0 < 0) | (head == a0))
    ok = wild | is_enq | (is_deq & deq_ok)
    new_state = torch.where(
        wild, state,
        torch.where(is_enq, enq_state,
                    torch.where(is_deq, _sar(state, v), state)))
    return torch.where(ok, new_state, state), ok


STEPS = {
    "register": register_step,
    "mutex": mutex_step,
    "gset": gset_step,
    "uqueue": uqueue_step,
    "fifo": fifo_step,
}
