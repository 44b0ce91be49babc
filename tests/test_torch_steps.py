"""The port's model steps (jepsen_tpu_torch.parallel.steps) against the
reference's jnp steps (jepsen_tpu.parallel.steps.STEPS): exhaustive
truth tables over small domains, wild rows and a0 = -1 rows included,
plus a domain of extreme int32 values for the shift and overflow
edges. Integer outputs, so the comparison is exact."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.parallel.steps import STEPS as REF_STEPS
from jepsen_tpu_torch.parallel.steps import STEPS
from torch_jax_cache import release_compiled_programs  # noqa: F401

I32_EDGES = [-(1 << 31), -(1 << 30) - 7, -5, (1 << 30) + 3, (1 << 31) - 1]

DOMAINS = {
    # states, f codes (every F_* and two invalid ones), a0, a1
    "small": (list(range(-2, 40)), list(range(-1, 10)),
              list(range(-2, 9)), list(range(-2, 9))),
    "shift-edges": ([0, 1, 3, 7, 255, 1 << 20, 1 << 29] + I32_EDGES,
                    [0, 1, 2, 5, 6, 7], [-1, 0, 1, 5, 30, 31, 32, 40],
                    [-1, 0, 1, 3, 8, 16, 31, 32, 33]),
}


def _grid(domain):
    states, fs, a0s, a1s = domain
    rows = np.array(list(itertools.product(states, fs, a0s, a1s, (0, 1))),
                    dtype=np.int64)
    cols = [rows[:, i].astype(np.int32) for i in range(4)]
    return cols + [rows[:, 4].astype(bool)]


@pytest.mark.parametrize("domain", sorted(DOMAINS))
@pytest.mark.parametrize("family", sorted(STEPS))
def test_step_truth_table_matches_reference(family, domain):
    state, f, a0, a1, wild = _grid(DOMAINS[domain])
    want_s, want_ok = REF_STEPS[family](
        jnp.asarray(state), jnp.asarray(f), jnp.asarray(a0),
        jnp.asarray(a1), jnp.asarray(wild))
    got_s, got_ok = STEPS[family](
        torch.from_numpy(state), torch.from_numpy(f), torch.from_numpy(a0),
        torch.from_numpy(a1), torch.from_numpy(wild))
    assert got_s.dtype == torch.int32 and got_ok.dtype == torch.bool
    want_s, want_ok = np.asarray(want_s), np.asarray(want_ok)
    bad = np.nonzero((got_s.numpy() != want_s) | (got_ok.numpy() != want_ok))[0]
    assert bad.size == 0, (
        f"{family}: {bad.size} rows differ, first (state, f, a0, a1, wild)"
        f" = {state[bad[0]], f[bad[0]], a0[bad[0]], a1[bad[0]], wild[bad[0]]}"
        f": got {got_s[bad[0]].item(), got_ok[bad[0]].item()}, want "
        f"{want_s[bad[0]], want_ok[bad[0]]}")


@pytest.mark.parametrize("family", sorted(STEPS))
def test_step_broadcasts_over_events_slots_states(family):
    """The engine calls a step with states [1, 1, S] against slot
    tables [E, C, 1]; the result is the elementwise table."""
    rng = np.random.default_rng(7)
    E, C, S = 3, 4, 6
    st = np.arange(S, dtype=np.int32) - 1
    f = rng.integers(-1, 8, (E, C, 1)).astype(np.int32)
    a0 = rng.integers(-1, 6, (E, C, 1)).astype(np.int32)
    a1 = rng.integers(-1, 6, (E, C, 1)).astype(np.int32)
    wild = rng.random((E, C, 1)) < 0.3
    got_s, got_ok = STEPS[family](
        torch.from_numpy(st)[None, None, :], torch.from_numpy(f),
        torch.from_numpy(a0), torch.from_numpy(a1), torch.from_numpy(wild))
    assert tuple(got_s.shape) == (E, C, S)
    b = np.broadcast_arrays(st[None, None, :], f, a0, a1, wild)
    want_s, want_ok = REF_STEPS[family](*(jnp.asarray(x) for x in b))
    assert (got_s.numpy() == np.asarray(want_s)).all()
    assert (got_ok.numpy() == np.asarray(want_ok)).all()
