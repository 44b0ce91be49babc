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


# (S, C) -> (layout, cluster blocks, words of each state a block holds)
# that closure_plan chooses with Hopper's opt-in and clusters of 16
PLANS = {
    (18, 13): ("cluster", 8, 32),     # the 10k-op main path: 18 KB of B
    (22, 17): ("cluster", 16, 256),   # 360 KB of B, past one block
    (40, 12): ("cluster", 8, 16),     # S > 32: two source words
    (3, 5): ("shared", 1, 1),         # C <= 9 never splits
    (128, 9): ("shared", 1, 16),
    (2, 12): ("shared", 1, 128),      # 1,024 words or fewer: one block
    (128, 20): ("global", 1, 32768),  # 16 MB: past any cluster
    (128, 24): ("global", 1, 524288),
}


@pytest.mark.parametrize("S,C", sorted(PLANS))
def test_closure_plan(S, C):
    """The layout gate, held to the byte sums it is built on: the split
    kernel's block bytes (B's share, the repacked sel, the pair list,
    flags and scan words) against the opt-in, a thread a word up to
    1,024 words a block, never fewer than 16 words a state a block."""
    plan = ck.closure_plan(S, C)
    assert (plan["layout"], plan["cluster"], plan["block_words"]) == \
        PLANS[(S, C)]
    W = ck.n_words(C)
    SW = (S + 31) // 32
    if plan["layout"] == "global":
        assert plan["smem"] == C * S * SW * 4
        # even 16 blocks of at least 16 words leave a block too much
        k = min(16, W // 16)
        assert ck.k1_block_bytes(S, C, W // k) > ck.HOPPER_SMEM_OPTIN
        return
    Wb = plan["block_words"]
    assert Wb * plan["cluster"] == W
    want = 4 * (S * Wb + C * S * SW + C * S + 1)
    want = (want + 2 * C * S + 15) // 16 * 16 + 4 * (2 * 16 + 40)
    assert plan["smem"] == ck.k1_block_bytes(S, C, Wb) == want
    assert plan["smem"] <= ck.HOPPER_SMEM_OPTIN
    assert plan["threads"] == min(1024, max(64, 1 << (S * Wb - 1)
                                            .bit_length()))
    if plan["cluster"] > 1:
        assert Wb >= 16 and S * Wb <= 1024 or plan["cluster"] == 16
        assert S * (2 * Wb) > 1024    # half the cluster would not do
    else:
        assert C <= 9 or S * W <= 1024


def test_closure_plan_follows_the_cards_limits():
    """Clusters of 8 only (no non-portable size): S22/C17 takes 8 blocks
    of 512 words; a card that runs no cluster gets one block where B
    fits it, else device memory; a small opt-in pushes S18/C13 apart."""
    assert ck.closure_plan(22, 17, max_cluster=8)["block_words"] == 512
    assert ck.closure_plan(18, 13, max_cluster=1)["layout"] == "shared"
    assert ck.closure_plan(22, 17, max_cluster=1)["layout"] == "global"
    assert ck.closure_plan(128, 17, max_cluster=8)["layout"] == "global"
    assert ck.closure_plan(128, 17)["cluster"] == 16
    tight = ck.k1_block_bytes(18, 13, 256) - 1
    assert ck.closure_plan(18, 13, optin=tight, max_cluster=1)["layout"] \
        == "global"


@pytest.mark.parametrize("S,C", [(18, 13), (22, 17), (3, 5)])
def test_closure_plans_lists_each_layout_a_shape_takes(S, C):
    plans = ck.closure_plans(S, C)
    assert plans[ck.closure_plan(S, C)["layout"]] == ck.closure_plan(S, C)
    assert "global" in plans
    assert ("shared" in plans) == (
        ck.k1_block_bytes(S, C, ck.n_words(C)) <= ck.HOPPER_SMEM_OPTIN)


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(18, 13), (22, 17), (3, 5), (40, 12)])
def test_cuda_kernel_matches_plain(S, C):
    """Every layout the kernel can run the shape in (the gate's choice
    through the wrapper, the others forced), in place and skipped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    plans = ck.closure_plans(S, C, *ck.card_limits(dev))
    assert ck.kernel_layout(S, C, dev) in plans
    for seed in range(3):
        sel, B = _rand_case(seed, S, C, p_legal=0.1)
        sel_d, B_d = _t(sel).to(dev), _t(B).to(dev)
        want = ck.closure_fixpoint_reference(_t(sel), _t(B), C)
        before = ck.launches
        got = ck.closure_fixpoint(sel_d, B_d, C)
        torch.cuda.synchronize()
        assert ck.launches == before + 1
        assert torch.equal(got.cpu(), want)
        for layout, plan in plans.items():
            out = torch.empty_like(B_d)
            ck._launch(sel_d, B_d, out, C, plan=plan)
            inplace = B_d.clone()
            ck._launch(sel_d, inplace, inplace, C, plan=plan,
                       run=torch.ones((), dtype=torch.bool, device=dev))
            skipped = B_d.clone()
            ck._launch(sel_d, skipped, skipped, C, plan=plan,
                       run=torch.zeros((), dtype=torch.bool, device=dev))
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want), layout
            assert torch.equal(inplace.cpu(), want), layout
            assert torch.equal(skipped, B_d), layout
