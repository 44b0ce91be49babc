"""First-decisive-verdict-wins race between the device and host engines.

The reference's default analyzer races knossos `linear` and `wgl` in
parallel futures; the first decisive result wins and the loser's future
is cancelled (jepsen/src/jepsen/checker.clj:199,
knossos/src/knossos/competition.clj). A port of
`jepsen_tpu.checker.competition`, whose device arm is the port's:

    torch   the device engine (jepsen_tpu_torch.parallel.engine) on the
            card — normally the winner by orders of magnitude, but a
            device runtime can wedge mid-call, and no Python signal
            reaches a thread blocked in the driver;
    packed  the int-config host frontier — fastest host arm, the hedge
            that keeps a dead device runtime from turning a check into
            a hang;
    linear  the host JIT-linearization frontier, for models that do not
            pack;
    wgl     the host depth-first search — decisive where the frontier
            arms go "unknown" (config-budget blowups), and the only arm
            for models that don't pack.

The host arms run in forked child processes, each watched by a thread
of the race; the device arm runs in a thread of this process, where the
card's context lives. (The reference runs every arm in a thread: its
device arm is one jit dispatch that holds no GIL while the TPU works.
The port's device arm drives its scan from Python, a few torch ops an
event, and gives up the GIL at each of them; against CPU-bound host arms
in threads of the same process it waits a switch interval to get it back
each time, and a 10k-event check that takes 65 s alone had not ended
after 590 s (PERF.md, PR 9). In their own processes the host arms use
other cores.)

What makes the fork safe: every child is forked before the race starts
a thread of its own, so no thread of the race holds a lock at the fork
(CPython holds its import lock across a fork, and logging re-creates its
locks in the child); the host arms' modules are imported before it; a
child runs the host arm's plain Python and never a torch op or a CUDA
call, so the card's context, unusable across a fork, is never touched
there; and the child freezes what it inherited out of its garbage
collection, so no inherited tensor is finalized in it. A thread that the
caller itself keeps running through the race is the caller's to keep
clear of locks.

Cancellation is cooperative for every arm. The host arms poll a
multiprocessing Event at their deadline stride (a child still running
HOST_CANCEL_GRACE_SECS after the cancel is terminated); the device arm
polls the same Event once an event of its scan (`engine.analysis`'s
`cancel`), and the race waits up to DEVICE_CANCEL_GRACE_SECS for it to
stop before it returns, so that no device work outlives the race. Only
an arm wedged in the device runtime outlives that wait: no Python signal
reaches a thread blocked in the driver, so its thread is a daemon, the
race stops waiting for it, and it becomes an orphan (below).

The device arm is the card's check, not a hedged guess: when it raises
(a kernel that does not build or launch, a fault of the engine), the
race stops the other arms and raises its error; a host arm never turns
a failed kernel into a verdict. A host arm that crashes loses.

A decisive verdict is `valid?` in {True, False}; "unknown" and crashes
are indecisive, and the race returns the best indecisive result only
when every arm failed to decide.
"""

from __future__ import annotations

import gc
import multiprocessing
import queue
import threading
import time
from typing import Optional

from jepsen_tpu_torch.checker import linear, linear_packed, wgl

# the host arms' children are forked: they inherit the model, the history
# and the loaded modules without pickling them, and never touch the card
_FORK = multiprocessing.get_context("fork")

# Grace period once only device arms remain undecided: host arms have
# all reported indecisive, so the race is waiting on an arm that may be
# wedged in the device runtime — wait this long, then report rather than
# hang.
DEVICE_ARM_GRACE_SECS = 60.0

# Device arms their race has given up on: thread -> the instant the
# race returned without them. An ORPHANED arm that stays silent long
# past any sane dispatch is the mid-process wedge signature (the device
# runtime died AFTER the availability probe cached healthy);
# device_engine_suspect() lets the dispatcher stop adding device arms —
# and leaking one stuck thread — to further checks. Orphans that do
# eventually report are removed, so a merely-slow (but healthy) device
# clears the suspicion and rejoins later races: suspicion is
# RECOVERABLE, unlike the process-wide availability cache.
_device_arms: dict = {}      # running device arms: thread -> start
_orphaned: dict = {}         # given-up device arms: thread -> orphaned-at
_device_arms_lock = threading.Lock()
DEVICE_WEDGE_SUSPECT_SECS = 120.0


def device_engine_suspect() -> bool:
    """True while some device arm whose race already gave up on it has
    stayed silent for DEVICE_WEDGE_SUSPECT_SECS past the give-up — the
    mid-process device-runtime wedge signature. Self-clearing: the arm
    reporting (however late) removes it."""
    now = time.monotonic()
    with _device_arms_lock:
        return any(now - t0 > DEVICE_WEDGE_SUSPECT_SECS
                   for t0 in _orphaned.values())


HOST_ARMS = {"packed": linear_packed, "linear": linear, "wgl": wgl}
# How long a host arm's child may take to notice the race's cancel
# before it is terminated.
HOST_CANCEL_GRACE_SECS = 5.0
# How long the race waits, once it has its answer, for the device arm to
# notice the cancel (one event of its scan) before it orphans it.
DEVICE_CANCEL_GRACE_SECS = 5.0


def _host_arm(name, model, history, cancel) -> dict:
    return HOST_ARMS[name].analysis(model, history, cancel=cancel)


def _child_main(name, model, history, cancel, conn) -> None:
    """A host arm's child: run the arm, send its result (a crash as an
    "unknown" result, as the race reports a crashed arm). The objects
    inherited from the parent are frozen out of the child's garbage
    collection first: collecting one (a tensor among them) could reach
    for a lock another thread of the parent held at the fork."""
    gc.freeze()
    try:
        r = _host_arm(name, model, history, cancel)
    except Exception as err:  # noqa: BLE001 - the parent reports it
        r = {"valid?": "unknown", "error": repr(err)}
    conn.send(r)
    conn.close()


def _fork_child(name, model, history, cancel):
    """Fork host arm `name`'s child; -> (child, the end of its pipe)."""
    recv, send = _FORK.Pipe(duplex=False)
    child = _FORK.Process(target=_child_main, daemon=True,
                          name=f"competition-{name}",
                          args=(name, model, history, cancel, send))
    child.start()
    send.close()
    return child, recv


def _await_child(name, child, recv, cancel) -> dict:
    """Wait for a host arm's child to answer (the wait holds no GIL). A
    child that dies without a result is a crashed arm; one that has not
    answered HOST_CANCEL_GRACE_SECS after the race's cancel is
    terminated, as cancelled."""
    cancelled_at = None
    try:
        while not recv.poll(0.1):
            if not child.is_alive() and not recv.poll(0):
                raise RuntimeError(f"competition arm {name!r} exited with "
                                   f"code {child.exitcode} before it "
                                   f"answered")
            if cancel.is_set():
                now = time.monotonic()
                cancelled_at = cancelled_at or now
                if now - cancelled_at > HOST_CANCEL_GRACE_SECS:
                    child.terminate()
                    return {"valid?": "unknown", "error": "cancelled"}
        return recv.recv()
    finally:
        recv.close()
        child.join()


def analysis(model, history, arms=("torch", "packed", "wgl"),
             timeout: Optional[float] = None, device_kw: Optional[dict] = None
             ) -> dict:
    """Race the given arms over (model, history); first decisive verdict
    wins. Returns the winner's result with "analyzer" set to the winning
    arm and a "competition" field naming winner and arms. `timeout`
    bounds the WHOLE race (one monotonic deadline, seconds); on expiry
    the best indecisive result so far is returned with valid?
    "unknown". Even without a timeout the race cannot hang on a wedged
    device arm: once every host arm has reported, the wait for the
    remaining device arm(s) is bounded by DEVICE_ARM_GRACE_SECS. Once it
    has its answer the race cancels the other arms and returns when the
    device arm has stopped, or DEVICE_CANCEL_GRACE_SECS later. An error raised
    by the device arm is raised. `device_kw` goes to the torch arm's
    `engine.analysis` (the checker's device, capacity, max_capacity,
    dedupe, config_pack and search_stats)."""
    for name in arms:
        if name != "torch" and name not in HOST_ARMS:
            raise ValueError(f"unknown competition arm {name!r}")
    cancel = _FORK.Event()
    results: queue.Queue = queue.Queue()
    # every child before any thread of the race (the module docstring)
    children = {name: _fork_child(name, model, history, cancel)
                for name in arms if name in HOST_ARMS}

    def run_arm(name):
        if name == "torch":
            from jepsen_tpu_torch.parallel import engine
            me = threading.current_thread()
            try:
                with _device_arms_lock:
                    _device_arms[me] = time.monotonic()
                r = engine.analysis(model, history, cancel=cancel,
                                    **(device_kw or {}))
            except BaseException as err:  # noqa: BLE001 — the race raises it
                r = err
            finally:
                with _device_arms_lock:
                    _device_arms.pop(me, None)
                    _orphaned.pop(me, None)
        else:
            try:
                r = _await_child(name, *children[name], cancel)
            except Exception as err:  # noqa: BLE001 — a crashed host arm
                # loses; the race decides from the survivors (crash kept
                # for the all-indecisive report)
                r = {"valid?": "unknown", "error": repr(err)}
        results.put((name, r))

    threads = []
    for name in arms:
        # daemon: a wedged device arm must never block process exit
        t = threading.Thread(target=run_arm, args=(name,), daemon=True,
                             name=f"competition-{name}")
        t.start()
        threads.append((name, t))

    deadline = None if timeout is None else time.monotonic() + timeout
    grace_deadline = None
    indecisive = {}
    pending = set(arms)

    def handle(name, r):
        """Absorb one arm result; the winner's dict when decisive. The
        device arm's error is raised."""
        pending.discard(name)
        if isinstance(r, BaseException):
            raise r
        if r.get("valid?") in (True, False):
            out = dict(r)
            out["analyzer"] = name
            out["competition"] = {"winner": name, "arms": list(arms)}
            return out
        indecisive[name] = r
        return None

    try:
        while pending:
            now = time.monotonic()
            limits = []
            if deadline is not None:
                limits.append(deadline)
            if pending <= {"torch"}:
                # only wedge-prone device arms are left: bound the wait
                # instead of trusting the device runtime to return — even
                # when an explicit (possibly large) race timeout is set
                if grace_deadline is None:
                    grace_deadline = now + DEVICE_ARM_GRACE_SECS
                limits.append(grace_deadline)
            wait = min(limits) - now if limits else None
            if wait is not None and wait <= 0:
                # expiry: drain anything already posted — an arm may
                # have delivered a decisive verdict just before the
                # deadline, and "unknown" must not beat it
                while True:
                    try:
                        name, r = results.get_nowait()
                    except queue.Empty:
                        break
                    win = handle(name, r)
                    if win:
                        return win
                break
            try:
                name, r = results.get(timeout=wait)
            except queue.Empty:
                continue  # re-check deadlines; expiry handled above
            win = handle(name, r)
            if win:
                return win

        return {"valid?": "unknown",
                "error": "no competition arm produced a decisive verdict"
                         + ("" if not pending
                            else f" in time ({sorted(pending)} still "
                                 f"running)"),
                "analyzer": "competition",
                "competition": {"winner": None, "arms": list(arms),
                                "results": indecisive}}
    finally:
        cancel.set()
        t = dict(threads).get("torch")
        if t is not None:
            t.join(DEVICE_CANCEL_GRACE_SECS)
            # a device arm still running is an orphan — the input to
            # the mid-process wedge detection above
            if t.is_alive():
                now = time.monotonic()
                with _device_arms_lock:
                    if t in _device_arms:
                        _orphaned[t] = now
