"""``python -m jepsen_tpu_torch.probe`` — bounded device-runtime health
check.

A wedged CUDA runtime can block a process forever in its first CUDA
call, with no Python-level signal delivery. So the probe asks a
throwaway child process under a timeout — ``torch.cuda.device_count()``,
then a one-element allocation and a synchronise on each card — and the
child takes any hang, never the caller. One verdict
line per attempt, in the reference's runbook format:

    2026-07-31T03:46:32Z probe: HEALTHY — torch.cuda -> ['cuda'] in 2.5s (cuda platform, 1 device(s))
    2026-07-31T02:18:07Z probe: hung past 100s (attempt 1/3)
    2026-07-31T02:28:00Z probe: WEDGED — all 3 attempts hung past 100s

Exit contract:

    0  healthy     the child answered within the timeout
    1  wedged      every attempt hung past the timeout
    2  no-backend  the child ran but failed (no CUDA device, import
                   error, CUDA error) — retries won't help, so none
                   are made
  254  usage error

A port of `jepsen_tpu.probe` (``jepsen probe``), whose child asks
``jax.devices()``. The child probes the card unless asked for the CPU
(``--device cpu``); on a machine with no card the CUDA probe is "no
backend", never a healthy CPU. The parent imports no torch.

Usage: ``python -m jepsen_tpu_torch.probe [--timeout 100] [--retries 3]
[--interval 0] [--device cuda|cpu] [--json]``.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import io
import json
import logging
import subprocess
import sys
import threading
import time
from typing import Callable, Optional, Sequence

_log = logging.getLogger(__name__)

EXIT_HEALTHY = 0
EXIT_WEDGED = 1
EXIT_NO_BACKEND = 2
EXIT_USAGE = 254

DEVICES = ("cuda", "cpu")

# the child: argv[1] is the device type; on "cuda" every card answers a
# one-element allocation and a synchronise, and no card is a failure
_CHILD_CODE = (
    "import json, sys\n"
    "import torch\n"
    "dev = sys.argv[1]\n"
    "if dev == 'cuda':\n"
    "    n = torch.cuda.device_count()\n"
    "    if n == 0:\n"
    "        raise RuntimeError('torch.cuda: no CUDA device is available')\n"
    "    for i in range(n):\n"
    "        torch.ones(1, device=f'cuda:{i}')\n"
    "        torch.cuda.synchronize(i)\n"
    "else:\n"
    "    n = 1\n"
    "    torch.ones(1, device='cpu')\n"
    "print('JEPSEN_PROBE ' + json.dumps([dev, n]))\n"
)


def _now() -> str:
    return _dt.datetime.now(_dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def _emit(msg: str, out=None):
    print(f"{_now()} probe: {msg}", file=out or sys.stdout, flush=True)


def probe_once(timeout: float, device: str = "cuda") -> dict:
    """One bounded child. Returns {"status": "healthy"|"hung"|"failed",
    ...}: healthy carries platforms/n_devices/secs, failed carries rc +
    a stderr tail."""
    t0 = time.monotonic()
    try:
        proc = subprocess.run([sys.executable, "-c", _CHILD_CODE, device],
                              capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        # subprocess.run kills the child on timeout: the hang dies with it
        return {"status": "hung", "secs": time.monotonic() - t0}
    secs = time.monotonic() - t0
    if proc.returncode == 0:
        for ln in proc.stdout.splitlines():
            if ln.startswith("JEPSEN_PROBE "):
                payload = json.loads(ln[len("JEPSEN_PROBE "):])
                return {"status": "healthy", "secs": secs,
                        "platforms": payload[:-1],
                        "n_devices": payload[-1]}
    return {"status": "failed", "secs": secs, "rc": proc.returncode,
            "err": (proc.stderr or proc.stdout).strip()[-300:]}


def run_probe(timeout: float = 100.0, retries: int = 3,
              interval: float = 0.0, out=None,
              record: Optional[list] = None, device: str = "cuda") -> int:
    """The retry loop: probe until healthy or attempts run out,
    emitting one verdict line per attempt and a final summary line.
    Returns the exit code. `record`, when a list, receives each
    attempt's raw result dict (probe_json builds on it)."""
    what = f"torch.{device}"
    retries = max(1, retries)
    for attempt in range(1, retries + 1):
        r = probe_once(timeout, device)
        if record is not None:
            record.append(r)
        if r["status"] == "healthy":
            plats = r["platforms"]
            _emit(f"HEALTHY — {what} -> {plats} in "
                  f"{r['secs']:.1f}s ({'/'.join(plats)} platform, "
                  f"{r['n_devices']} device(s))", out)
            return EXIT_HEALTHY
        if r["status"] == "hung":
            _emit(f"hung past {timeout:.0f}s "
                  f"(attempt {attempt}/{retries})", out)
        else:
            # a child that RAN and failed is not a wedge — retrying
            # cannot help (no card, no CUDA library, import error)
            _emit(f"NO BACKEND — {what} failed rc={r['rc']} "
                  f"in {r['secs']:.1f}s ({r['err'].splitlines()[-1] if r['err'] else '?'})",
                  out)
            return EXIT_NO_BACKEND
        if attempt < retries and interval > 0:
            time.sleep(interval)
    _emit(f"WEDGED — all {retries} attempt(s) hung past "
          f"{timeout:.0f}s (the child never returned from its first "
          f"CUDA call: a wedged CUDA runtime)", out)
    return EXIT_WEDGED


_VERDICTS = {EXIT_HEALTHY: "healthy", EXIT_WEDGED: "wedged",
             EXIT_NO_BACKEND: "no-backend"}


def probe_json(timeout: float = 100.0, retries: int = 3,
               interval: float = 0.0, out=None,
               device: str = "cuda") -> dict:
    """The probe loop as one machine-readable document — what both
    ``--json`` and the circuit breaker's default recovery probe consume.
    `out` receives the human verdict lines (default: discarded).

    Schema: verdict (healthy|wedged|no-backend), exit (0/1/2), attempts
    (each raw probe_once result), elapsed_secs, timeout, retries;
    healthy additionally carries platforms and n_devices from the
    answering attempt."""
    t0 = time.monotonic()
    record: list = []
    code = run_probe(timeout=timeout, retries=retries,
                     interval=interval, out=out or io.StringIO(),
                     record=record, device=device)
    doc = {
        "verdict": _VERDICTS.get(code, "unknown"),
        "exit": code,
        "attempts": record,
        "elapsed_secs": round(time.monotonic() - t0, 3),
        "timeout": timeout,
        "retries": retries,
    }
    if code == EXIT_HEALTHY and record:
        doc["platforms"] = record[-1].get("platforms")
        doc["n_devices"] = record[-1].get("n_devices")
    return doc


# ------------------------------------------------ continuous chip watch


class ProbeWatch:
    """The probe loop as a background service: re-run :func:`probe_json`
    every ``interval`` seconds on a daemon thread and publish the
    verdict as live gauges on the port's ``obs`` registry —

        probe.chip_healthy       1 healthy / 0 wedged or no-backend
        probe.last_ok_age_secs   seconds since the last healthy verdict

    Off by default: armed via ``JEPSEN_TPU_TORCH_PROBE_INTERVAL``
    (seconds; 0/unset = no watch, no thread, no gauges) through
    :func:`start_watch_from_env`.

    Staleness contract for readiness: before the first tick completes
    the watch reports ok (a service must not fail readiness while the
    first probe is still in flight); after that, ok means the last
    verdict was healthy AND its age is within ``max_stale`` (default
    ``2*interval + timeout`` — a stuck watch loop is itself a health
    failure).
    """

    def __init__(self, interval: float, timeout: float = 100.0,
                 retries: int = 1, max_stale: Optional[float] = None,
                 probe: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: str = "cuda"):
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.max_stale = (float(max_stale) if max_stale is not None
                          else 2.0 * self.interval + self.timeout)
        self._probe = probe if probe is not None else (
            lambda: probe_json(timeout=self.timeout,
                               retries=self.retries, device=device))
        self._clock = clock
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.last: Optional[dict] = None
        self._last_ok: Optional[float] = None
        self._started = self._clock()

    @staticmethod
    def _gauges():
        from jepsen_tpu_torch import obs
        return obs.gauge("probe.chip_healthy"), \
            obs.gauge("probe.last_ok_age_secs")

    def _age(self, now: float) -> float:
        with self._lock:
            t0 = self._last_ok if self._last_ok is not None \
                else self._started
        return max(0.0, now - t0)

    def tick(self) -> dict:
        """One probe cycle: run the probe, record, publish gauges. A
        probe that RAISES still counts as a completed tick with verdict
        ``probe-error``, so the first-tick grace cannot report ok
        forever."""
        try:
            doc = self._probe()
        except Exception as err:  # noqa: BLE001 — a crashed probe is
            # not health; it must degrade readiness, not kill the loop
            _log.exception("probe watch tick failed")
            doc = {"verdict": "probe-error",
                   "error": f"{type(err).__name__}: {err}"}
        now = self._clock()
        healthy = doc.get("verdict") == "healthy"
        with self._lock:
            self.ticks += 1
            self.last = doc
            if healthy:
                self._last_ok = now
        g_h, g_age = self._gauges()
        g_h.set(1 if healthy else 0)
        g_age.set(round(self._age(now), 3))
        return doc

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — tick() absorbs probe
                # failures; this guards the bookkeeping itself
                _log.exception("probe watch bookkeeping failed")
            if self._stop.wait(self.interval):
                return

    def start(self) -> "ProbeWatch":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="jepsen-probe-watch")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # an in-flight probe child may hold the loop for up to
            # `timeout` seconds; the thread is a daemon and the child
            # dies with the process, so a bounded join suffices
            self._thread.join(timeout=1.0)

    def status(self) -> dict:
        """The watch as a /healthz check entry (and the live refresh
        of the age gauge)."""
        now = self._clock()
        age = self._age(now)
        with self._lock:
            ticks, last = self.ticks, self.last
        verdict = last.get("verdict") if last else None
        if ticks == 0:
            ok = True        # first probe still in flight: not a failure
        else:
            ok = verdict == "healthy" and age <= self.max_stale
        if ticks:
            _g_h, g_age = self._gauges()
            g_age.set(round(age, 3))
        return {"ok": ok, "verdict": verdict, "ticks": ticks,
                "last_ok_age_secs": round(age, 3),
                "interval": self.interval,
                "max_stale": self.max_stale}


def start_watch_from_env(device: str = "cuda") -> Optional[ProbeWatch]:
    """Arm the continuous watch when ``JEPSEN_TPU_TORCH_PROBE_INTERVAL``
    names an interval (seconds; 0/unset = off, the default)."""
    from jepsen_tpu_torch import envflags
    interval = envflags.env_float("JEPSEN_TPU_TORCH_PROBE_INTERVAL",
                                  default=0.0, min_value=0.0,
                                  what="probe watch interval seconds")
    if not interval:
        return None
    return ProbeWatch(interval, device=device).start()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.probe",
        description="bounded device-runtime health check: a torch.cuda "
                    "child with timeout + retry; exit 0 healthy / 1 "
                    "wedged / 2 no-backend")
    p.add_argument("--timeout", type=float, default=100.0,
                   help="seconds before one attempt counts as hung "
                        "(default: 100)")
    p.add_argument("--retries", type=int, default=3,
                   help="attempts before the WEDGED verdict")
    p.add_argument("--interval", type=float, default=0.0,
                   help="seconds between attempts")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="what the child probes (default: cuda, the card; "
                        "cpu checks the torch install alone)")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON document on "
                        "stdout (verdict lines go to stderr); exit "
                        "code unchanged")
    try:
        args = p.parse_args(list(argv) if argv is not None else None)
    except SystemExit as e:
        # argparse exits 2 on usage errors, which collides with the
        # no-backend code — keep --help at 0 and map misuse to 254
        return 0 if e.code in (0, None) else EXIT_USAGE
    if args.json:
        doc = probe_json(timeout=args.timeout, retries=args.retries,
                         interval=args.interval, out=sys.stderr,
                         device=args.device)
        print(json.dumps(doc))
        return doc["exit"]
    return run_probe(timeout=args.timeout, retries=args.retries,
                     interval=args.interval, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
