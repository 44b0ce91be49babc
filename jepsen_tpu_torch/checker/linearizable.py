"""Linearizability checker — the `checker/linearizable` dispatcher.

A port of `jepsen_tpu.checker.linearizable` with two arms (the
reference's algorithm dispatch, jepsen/src/jepsen/checker.clj:182-213):

    "torch"  the device engine (jepsen_tpu_torch.parallel.engine) on the
             card: the bit-packed dense check (closure kernel K1), or
             the sparse frontier check (hash closure kernels K2, K4)
    "wgl"    host depth-first WGL search (jepsen_tpu_torch.checker.wgl)

Results mirror knossos: {"valid?", "op", "final-paths", "configs",
"analyzer"}. Like the reference, final-paths/configs are truncated to 10
(checker.clj:210-213 — "Writing these can take *hours*").
"""

from __future__ import annotations

from jepsen_tpu_torch.checker.core import Checker
from jepsen_tpu_torch.history import History

ALGORITHMS = ("torch", "wgl")


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
    (engine.analysis); `config_pack` also reaches the per-key batch of
    `independent.checker`."""

    def __init__(self, model=None, algorithm: str = "torch", device=None,
                 capacity: int = 1024, max_capacity: int = 1 << 20,
                 dedupe=None, config_pack=None):
        self.model = model
        self.algorithm = algorithm
        self.device = device
        self.capacity = capacity
        self.max_capacity = max_capacity
        self.dedupe = dedupe
        self.config_pack = config_pack

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

        if algo == "torch":
            from jepsen_tpu_torch.parallel import engine
            r = engine.analysis(model, h, device=self.device,
                                capacity=self.capacity,
                                max_capacity=self.max_capacity,
                                dedupe=self.dedupe,
                                config_pack=self.config_pack)
        elif algo == "wgl":
            from jepsen_tpu_torch.checker import wgl
            r = wgl.analysis(model, h)
        else:
            raise ValueError(f"unknown linearizability algorithm {algo!r}; "
                             f"jepsen_tpu_torch has {ALGORITHMS}")
        r["analyzer"] = algo
        return _truncate(r)


def linearizable(model=None, algorithm: str = "torch", device=None,
                 **kw) -> Linearizable:
    return Linearizable(model, algorithm, device, **kw)
