"""K1 under the profiler bridge, on the card (`cuda`).

With JEPSEN_TPU_TORCH_PROFILE set, a dense check and a dense batch run
inside one ``torch.profiler`` capture each (``engine.check_batch``'s
``maybe_torch_profile``; the single check under an explicit one), and
every K1 launch in the capture correlates, by its correlation id, to the
``bitdense single S{S} C{C}`` or ``bitdense K{K} S{S} C{C}`` annotation
around it; the results equal the untraced run's.

This file imports no JAX, so the card's run needs none.
"""

import pytest
import torch

from jepsen_tpu_torch import histories, models, obs
from jepsen_tpu_torch.obs import capture
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import engine


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for f in ("JEPSEN_TPU_TORCH_TRACE", "JEPSEN_TPU_TORCH_PROFILE"):
        monkeypatch.delenv(f, raising=False)
    obs.reset()
    yield
    obs.reset()


@pytest.mark.cuda
def test_k1_launches_correlate_to_their_annotations(tmp_path, monkeypatch):
    dev = _cuda()
    model = models.CASRegister()
    h = histories.adversarial_register_history(n_ops=300, k_crashed=6,
                                               seed=3)
    hs = [histories.rand_register_history(n_ops=40, n_processes=4,
                                          crash_p=0.05, seed=s)
          for s in range(6)]
    want_one = engine.analysis(model, h, device=dev)
    want_batch = engine.check_batch(model, hs, device=dev)

    single = tmp_path / "single"
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROFILE", str(single))
    obs.configure(True)
    ck.reset_launches()
    with obs.maybe_torch_profile():
        got_one = engine.analysis(model, h, device=dev)
    n_single = ck.launches
    batch = tmp_path / "batch"
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROFILE", str(batch))
    ck.reset_launches()
    got_batch = engine.check_batch(model, hs, device=dev)
    n_batch = ck.batch_launches
    obs.reset()
    assert got_one == want_one and got_batch == want_batch
    assert n_single > 0 and n_batch > 0

    recs = capture.kernel_annotations(
        capture.load_captures(str(single))[-1])
    k1 = [r for r in recs if r["kernel"] == "K1"]
    assert len(k1) == n_single
    S, C = want_one["states"], want_one["slots"]
    assert {r["annotation"] for r in k1} == {f"bitdense single S{S} C{C}"}

    recs = [r for doc in capture.load_captures(str(batch))
            for r in capture.kernel_annotations(doc)]
    k1 = [r for r in recs if r["kernel"] == "K1"]
    assert len(k1) == n_batch
    # one annotation a bucket's scan: K its keys, S and C its padded dims
    assert all(r["annotation"] is not None
               and r["annotation"].startswith("bitdense K")
               for r in k1), k1
