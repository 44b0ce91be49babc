"""Linearizability checker — the `checker/linearizable` dispatcher.

A port of `jepsen_tpu.checker.linearizable` (the reference's algorithm
dispatch, jepsen/src/jepsen/checker.clj:182-213). `algorithm` selects
the engine:

    "torch"        the device engine (jepsen_tpu_torch.parallel.engine)
                   on the card: the bit-packed dense check (closure
                   kernel K1), or the sparse frontier check (hash
                   closure kernels K2, K4). The port's default.
    "wgl"          host depth-first WGL search (checker.wgl)
    "linear"       host JIT-linearization frontier (checker.linear)
    "packed"       host frontier over int configs — the device encoding
                   run on the CPU (checker.linear_packed); falls back to
                   wgl, with a `fallback` note, when the model can't pack
    "competition"  a first-decisive-wins race (checker.competition):
                   packable models race torch + packed + wgl, others
                   race linear + wgl. The host arms hedge a wedged
                   device runtime; the losers are cooperatively
                   cancelled.

The reference's default is "competition"; the port's stays "torch", so
that a check runs on the card unless the caller asks for a race.

Results mirror knossos: {"valid?", "op", "final-paths", "configs",
"analyzer"}. An invalid result from "linear" or "packed" (which keep no
breadcrumbs) gets its final-paths from a state-bounded WGL re-search,
and "oracle-disagreement" when that search says valid. Like the
reference, final-paths/configs are truncated to 10 (checker.clj:210-213
— "Writing these can take *hours*"); on failure the counterexample SVG
(`checker.linear_report`) is written into `test["store"]` when the test
has one.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.checker.core import Checker
from jepsen_tpu_torch.history import History, Intern

ALGORITHMS = ("torch", "wgl", "linear", "packed", "competition")

_log = logging.getLogger(__name__)


def _truncate(result: dict, n: int = 10) -> dict:
    for k in ("final-paths", "configs"):
        if isinstance(result.get(k), list):
            result[k] = result[k][:n]
    return result


class Linearizable(Checker):
    """`device` None means the card (RuntimeError when there is none);
    "cpu" runs the plain PyTorch path. `capacity`, `max_capacity`,
    `dedupe` and `config_pack` (packed rows; None: the
    JEPSEN_TPU_TORCH_CONFIG_PACK flag) go to the sparse engine
    (engine.analysis); `search_stats` (None: the
    JEPSEN_TPU_TORCH_SEARCH_STATS flag) adds the engine's "stats" block.
    All of them also reach the per-key batch of `independent.checker`
    and the torch arm of the race."""

    def __init__(self, model=None, algorithm: str = "torch", device=None,
                 capacity: int = 1024, max_capacity: int = 1 << 20,
                 dedupe=None, config_pack=None, search_stats=None):
        self.model = model
        self.algorithm = algorithm
        self.device = device
        self.capacity = capacity
        self.max_capacity = max_capacity
        self.dedupe = dedupe
        self.config_pack = config_pack
        self.search_stats = search_stats

    def _device_kw(self) -> dict:
        return {"device": self.device, "capacity": self.capacity,
                "max_capacity": self.max_capacity, "dedupe": self.dedupe,
                "config_pack": self.config_pack,
                "search_stats": self.search_stats}

    def check(self, test, history, opts=None):
        model = self.model or (test or {}).get("model")
        if model is None:
            raise ValueError("The linearizable checker requires a model")
        algo = self.algorithm or "torch"
        h = history if isinstance(history, History) else History.wrap(history)

        # Guard against mis-parsed histories (e.g. raw EDN keyword keys):
        # a non-empty history in which NO op has a recognizable :type
        # would otherwise sail through as trivially linearizable.
        if len(h) and not any(
                o.get("type") in ("invoke", "ok", "fail", "info")
                for o in h):
            raise ValueError(
                "history has no ops with a recognizable :type — was it "
                "parsed with History.from_edn / op_from_edn?")

        if algo == "competition":
            r = self._race(model, h, test)
            algo = r.get("analyzer", "competition")
        elif algo == "torch":
            from jepsen_tpu_torch.parallel import engine
            r = engine.analysis(model, h, **self._device_kw())
        elif algo == "wgl":
            from jepsen_tpu_torch.checker import wgl
            r = wgl.analysis(model, h)
        elif algo == "linear":
            from jepsen_tpu_torch.checker import linear
            r = linear.analysis(model, h)
        elif algo == "packed":
            from jepsen_tpu_torch.checker import linear_packed, wgl
            from jepsen_tpu_torch.parallel.encode import EncodeError
            try:
                r = linear_packed.analysis(model, h)
            except EncodeError as err:
                r = wgl.analysis(model, h)
                r["fallback"] = str(err)
                algo = "wgl"
        else:
            raise ValueError(f"unknown linearizability algorithm {algo!r}; "
                             f"jepsen_tpu_torch has {ALGORITHMS}")
        r["analyzer"] = algo
        if (r.get("valid?") is False and not r.get("final-paths")
                and algo in ("linear", "packed") and len(h) <= 1000):
            _research_final_paths(r, model, h, algo)
        r = _truncate(r)

        # On failure, render the counterexample SVG into the store, as
        # the reference does via knossos.linear.report
        # (checker.clj:203-207), from the truncated analysis.
        if r.get("valid?") is False and (test or {}).get("store"):
            try:
                from jepsen_tpu_torch.checker import linear_report
                linear_report.render_analysis_file(h, r, test, opts)
            except Exception:  # noqa: BLE001 - plots must never fail a check
                _log.warning("linear.svg could not be written",
                             exc_info=True)
        return r

    def _race(self, model, h, test) -> dict:
        """The competition race with the arms the reference picks: a
        packable model races the device arm, `packed` and `wgl`; any
        other `linear` and `wgl`. On the card the device arm races while
        the bounded probe has not answered and no earlier race's device
        arm is suspected of a wedge (the hedge for a wedged runtime); a
        probe that answers that there is no card raises RuntimeError, as
        every other entry point of the port does."""
        from jepsen_tpu_torch.checker import competition
        global _wedge_warned
        packable = model_ns.pack_spec(model, Intern()) is not None
        if packable:
            suspect = competition.device_engine_suspect()
            if suspect and not _wedge_warned:
                _log.warning(
                    "a device competition arm from an earlier check has "
                    "been silent for >%.0fs — racing host arms only until "
                    "it reports", competition.DEVICE_WEDGE_SUSPECT_SECS)
            _wedge_warned = suspect
            on_card = self.device is None \
                or str(self.device).startswith("cuda")
            answer = _engine_available() if on_card else True
            if answer is False:
                raise RuntimeError(
                    "jepsen_tpu_torch: no CUDA device is available; pass "
                    "device=\"cpu\" to run the plain PyTorch path on the "
                    "CPU")
            arms = (("torch", "packed", "wgl")
                    if answer and not suspect else ("packed", "wgl"))
        else:
            arms = ("linear", "wgl")   # the reference's exact race
        return competition.analysis(
            model, h, arms=arms,
            timeout=(test or {}).get("competition-timeout"),
            device_kw=self._device_kw())


def _research_final_paths(r: dict, model, h, algo: str) -> None:
    """The frontier engines localize a failure but keep no breadcrumbs;
    knossos's linear analysis always produces final-paths (they feed
    linear.svg, checker.clj:203-207). Attach them from a state-bounded
    WGL re-search, in place: wgl's whole failure report, so that op,
    final-paths and configs describe the same stuck point; a re-search
    that says valid flags "oracle-disagreement"."""
    from jepsen_tpu_torch.checker import wgl
    rw = wgl.analysis(model, h, max_states=1_000_000)
    if rw.get("valid?") is False:
        r["final-paths"] = rw.get("final-paths", [])
        r["configs"] = rw.get("configs", [])
        if rw.get("op"):
            r["op"] = rw["op"]
    elif rw.get("valid?") is True:
        # a silent wrong verdict would hide an engine bug
        _log.warning("%s said invalid but the WGL oracle says valid — "
                     "engine disagreement", algo)
        r["oracle-disagreement"] = True


_engine_probe_result: Optional[bool] = None
_engine_probe: dict = {}   # in-flight probe: {"thread": t, "out": {...}}
_wedge_warned = False   # one warning per suspicion episode, not per check


def _engine_available(timeout: float = 15.0) -> Optional[bool]:
    """Whether the card can run the device engine — probed with a
    BOUNDED wait. The probe (`torch.cuda.is_available()` and a device
    count) runs in a daemon thread: a wedged driver must not hang the
    check before the race could hedge anything. True or False once it
    has answered; None while it has not (races then run host arms
    only). Only an actual ANSWER is cached: a merely slow first init
    that finishes after the timeout flips later checks back to the card.
    One probe thread in all — later calls re-join the same thread
    briefly rather than starting another."""
    global _engine_probe_result
    if _engine_probe_result is not None:
        return _engine_probe_result
    if not _engine_probe:
        out: dict = {}

        def probe():
            try:
                import torch
                out["ok"] = (torch.cuda.is_available()
                             and torch.cuda.device_count() > 0)
            except Exception:  # noqa: BLE001
                out["ok"] = False

        t = threading.Thread(target=probe, daemon=True,
                             name="engine-availability-probe")
        t.start()
        _engine_probe.update(thread=t, out=out)
        _engine_probe["thread"].join(timeout)
    else:
        # an earlier call already paid the full wait; just peek
        _engine_probe["thread"].join(0.1)
    out = _engine_probe["out"]
    if "ok" in out:
        _engine_probe_result = bool(out["ok"])
        return _engine_probe_result
    return None


def linearizable(model=None, algorithm: str = "torch", device=None,
                 **kw) -> Linearizable:
    return Linearizable(model, algorithm, device, **kw)
