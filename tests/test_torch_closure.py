"""The closure fixpoint (K1's contract): the port's plain version
`closure_fixpoint_reference` against the reference's Pallas kernel run
in interpret mode (`jepsen_tpu.parallel.pallas_kernels.closure_fixpoint`,
at the TPU gate's shapes, as tests/test_pallas.py runs it) and against
a semantic oracle over (state, mask) pairs, written from the closure's
definition. Words are bit patterns, so every comparison is exact.

The CUDA kernel itself runs only on the card: its test is marked
`cuda` and skips here; chip_smoke.py holds it against the plain
version on every run."""

import numpy as np
import pytest
import torch

from jepsen_tpu.parallel import pallas_kernels as pk
from jepsen_tpu_torch.parallel import closure_kernels as ck

FULL = np.uint32(0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _semantic_fixpoint(sel, B, C):
    """From every reachable (state s, mask m), for every slot j not in m
    with a legal transition s->t, (t, m | 1<<j) is reachable. Iterate to
    fixpoint. sel [C,S,S], B [S,W] uint32 words."""
    S, W = B.shape
    reach = set()
    for s in range(S):
        for w in range(W):
            word = int(B[s, w])
            for b in range(32):
                if (word >> b) & 1:
                    reach.add((s, w * 32 + b))
    frontier = list(reach)
    while frontier:
        nxt = []
        for (s, m) in frontier:
            for j in range(C):
                if (m >> j) & 1:
                    continue
                for t in range(S):
                    if sel[j, s, t] and (t, m | (1 << j)) not in reach:
                        reach.add((t, m | (1 << j)))
                        nxt.append((t, m | (1 << j)))
        frontier = nxt
    out = np.zeros((S, W), np.uint32)
    for (s, m) in reach:
        out[s, m // 32] |= np.uint32(1) << np.uint32(m % 32)
    return out


def _rand_case(seed, S, C, n_seeds=3, p_legal=0.08):
    rng = np.random.default_rng(seed)
    W = max(1, (1 << C) // 32)
    sel = np.where(rng.random((C, S, S)) < p_legal, FULL,
                   np.uint32(0)).astype(np.uint32)
    B = np.zeros((S, W), np.uint32)
    for _ in range(n_seeds):
        s, m = rng.integers(S), rng.integers(1 << C)
        B[s, m // 32] |= np.uint32(1) << np.uint32(m % 32)
    return sel, B


def _t(a):
    """uint32 numpy -> int32 torch bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _plain(sel, B, C):
    return ck.closure_fixpoint_reference(_t(sel), _t(B), C).numpy() \
        .view(np.uint32)


@pytest.mark.parametrize("S", [2, 5, 8])
@pytest.mark.parametrize("seed", range(2))
def test_plain_closure_matches_interpret_pallas(seed, S):
    C = 12
    assert pk.supported(S, C)
    sel, B = _rand_case(seed, S, C)
    want = np.asarray(pk.closure_fixpoint(sel, B, C, interpret=True))
    assert (_plain(sel, B, C) == want).all()


@pytest.mark.parametrize("C", [5, 6, 7, 8])
@pytest.mark.parametrize("seed", range(2))
def test_plain_closure_matches_semantic_oracle(seed, C):
    sel, B = _rand_case(seed, 4, C, n_seeds=4, p_legal=0.15)
    assert (_plain(sel, B, C) == _semantic_fixpoint(sel, B, C)).all()


@pytest.mark.parametrize("C", [1, 3, 4])
def test_plain_closure_below_one_word(C):
    """C < 5 leaves mask bits >= 2^C of the one word unused; the closure
    still agrees with the oracle (and never sets them from below)."""
    sel, B = _rand_case(11, 3, C, n_seeds=2, p_legal=0.3)
    B &= np.uint32((1 << (1 << C)) - 1)
    assert (_plain(sel, B, C) == _semantic_fixpoint(sel, B, C)).all()


def test_reference_counts_expansions():
    sel, B = _rand_case(3, 4, 6, n_seeds=2, p_legal=0.2)
    out, n = ck.closure_reference_expansions(_t(sel), _t(B), 6)
    assert (out.numpy().view(np.uint32) == _semantic_fixpoint(sel, B, 6)).all()
    assert 1 <= n <= 6 + 1  # a chain adds at most C bits, then one check


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    sel, B = _rand_case(4, 5, 12)
    ck.reset_launches()
    got = ck.closure_fixpoint(_t(sel), _t(B), 12)
    out = torch.empty_like(_t(B))
    same = ck.closure_fixpoint(_t(sel), _t(B), 12, out=out)
    assert same is out
    assert torch.equal(got, ck.closure_fixpoint_reference(_t(sel), _t(B), 12))
    assert torch.equal(out, got)
    assert ck.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape_B", "shape_sel", "C", "S"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    sel, B = _t(_rand_case(0, 3, 6)[0]), _t(_rand_case(0, 3, 6)[1])
    C = 6
    if bad == "dtype":
        B = B.to(torch.int64)
    elif bad == "shape_B":
        B = B[:, :1]
    elif bad == "shape_sel":
        sel = sel[:, :2]
    elif bad == "C":
        C = 25
    else:
        sel = torch.zeros((6, 129, 129), dtype=torch.int32)
        B = torch.zeros((129, 2), dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        ck.closure_fixpoint(sel, B, C)


def test_wrapper_has_no_fallback_for_other_devices():
    sel, B = _rand_case(0, 3, 6)
    with pytest.raises(RuntimeError, match="no kernel"):
        ck.closure_fixpoint(_t(sel).to("meta"), _t(B).to("meta"), 6)


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(18, 13), (22, 17), (3, 5)])
def test_cuda_kernel_matches_plain(S, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed in range(3):
        sel, B = _rand_case(seed, S, C, p_legal=0.1)
        sel_d, B_d = _t(sel).cuda(), _t(B).cuda()
        before = ck.launches
        got = ck.closure_fixpoint(sel_d, B_d, C)
        torch.cuda.synchronize()
        assert ck.launches == before + 1
        assert torch.equal(got.cpu(), ck.closure_fixpoint_reference(
            _t(sel), _t(B), C))
