"""The sparse kernels K2, K3 and K4 on packed rows (config_pack: one or two
int32 lanes a row, `sparse._PackedRep`).

On the CPU: the shared-memory gates priced by the lanes, the wrappers'
checks of a row's lanes against its layout, their plain versions run on
CPU tensors with no launch counted, and K2's plain version on packed rows
against the same closure on the triple: the same configurations, counts
and passes, whatever the layout.

The `cuda` tests hold each kernel against its plain version, bit for bit,
on the seeded packed cases of `tests/torch_parity_cases.py` at one lane
and two: K2 and batched K2, K3 in both of its table layouts, K4 and
batched K4. They skip without a card. This file imports no JAX, so the
card's run needs none; `test_torch_config_pack_pallas.py` holds the
plain versions against the reference's Pallas kernels.
"""

import numpy as np
import pytest
import torch

import torch_parity_cases as pc
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K2 = {c[0]: c for c in pc.packed_k2_cases()}
K3 = {c[0]: c for c in pc.packed_k3_cases()}
K4 = {c[0]: c for c in pc.packed_k4_cases()}
K4B = {c[0]: c for c in pc.packed_k4_batch_cases()}


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _equal(got, want) -> bool:
    if isinstance(want, torch.Tensor):
        return torch.equal(got.cpu(), want.cpu())
    return len(got) == len(want) and all(_equal(g, w)
                                         for g, w in zip(got, want))


# ------------------------------------------------------------ the gates

def test_the_gates_price_the_lanes():
    for L in (1, 2, 3):
        assert sk.slot_bytes(L) == 4 * L + 5
        assert sk.k2_smem_bytes(1024, 8, L) == \
            4 * L * 1024 + (4 * L + 5) * 2048 + 2 * 1024 * 8 + 1056
    assert sk.k2_smem_bytes(1024, 8) == sk.k2_smem_bytes(1024, 8, 3)
    # one lane (C <= 31): N = 2,048 for every C, N = 4,096 up to C = 17
    assert all(sk.supported(2048, C, lanes=1) for C in range(1, 32))
    assert sk.supported(4096, 17, lanes=1)
    assert not sk.supported(4096, 18, lanes=1)
    # two lanes: N = 2,048 up to C = 39; the triple stops at 33
    assert sk.supported(2048, 39, lanes=2)
    assert not sk.supported(2048, 40, lanes=2)
    assert sk.supported(2048, 33) and not sk.supported(2048, 34)
    assert not sk.supported(1024, 8, lanes=4)
    # K3's table in one block: 8,192 rows of one or two lanes, 4,096 of
    # three
    assert sk.k3_smem_bytes(8192, 1) == 9 * 16384 + 160
    for L in (1, 2):
        assert sk.k3_layout(8192, lanes=L) == "shared"
        assert sk.k3_layout(8193, lanes=L) == "device"
    assert sk.k3_layout(4096) == "shared"
    assert sk.k3_layout(8192) == "device"


def test_every_packed_case_reaches_its_shape():
    for name, (_, step, ev, rows, live, run, pl, pack) in K2.items():
        C, N = ev["slot_f"].shape[0], live.shape[0]
        L = sparse.pack_lanes(pack, C)
        assert len(rows) == L and name.split()[1] == f"L{L}"
        assert sk.supported(N, C, lanes=L)
    assert {len(c[1]) for c in K3.values()} == {1, 2}
    assert {len(c[1]) for c in K4.values()} == {1, 2}
    assert {len(c[1]) for c in K4B.values()} == {1, 2}
    # the seeded K2 cases take N = 4,096 at one lane, past the triple's
    # gate, and cross bit 32 at two
    assert any(c[4].shape[0] == 4096 and len(c[3]) == 1 for c in K2.values())


# ------------------------------------------------------- the wrappers

def test_k2_checks_the_rows_against_the_layout():
    _, step, ev, rows, live, run, pl, pack = K2["register L1 s4 C3 "
                                                "equal masks"]
    with pytest.raises(ValueError, match="1 int32"):
        sk.frontier_closure(step, ev, rows + rows, live, run, pl, pack)
    with pytest.raises(ValueError, match="3 int32"):
        sk.frontier_closure(step, ev, rows, live, run, pl)
    with pytest.raises(ValueError, match="64 bits"):
        sk.frontier_closure(step, ev, rows, live, run, pl, (62, 0))
    xs = {k: v[None, None] for k, v in ev.items()}
    with pytest.raises(ValueError, match="3 int32"):
        sk.frontier_closure_batch(step, xs, 0, tuple(r[None] for r in rows),
                                  live[None], run.reshape(1), pl)


def test_k3_and_k4_check_the_lane_counts():
    _, c_rows, c_live, f_rows, count, table, pl, N = \
        K3["L2 T1024 M2000 pl32"]
    with pytest.raises(ValueError, match="two int32 lanes"):
        sk.hash_insert(c_rows, c_live, f_rows[:1], count, table, pl, N)
    with pytest.raises(ValueError, match="two int32 lanes"):
        sk.hash_insert(c_rows, c_live, f_rows, count,
                       (table[0][:1], table[1]), pl, N)
    four = c_rows + c_rows
    with pytest.raises(ValueError, match="int32 lanes"):
        sk.hash_insert(four, c_live, f_rows + f_rows, count,
                       (table[0] + table[0], table[1]), pl, N)
    _, c_rows, c_live, table, pl = K4["L1 probe_limit 2"]
    with pytest.raises(ValueError, match="one int32 lanes"):
        sk.tiled_insert(c_rows, c_live, (table[0] * 2, table[1]), pl)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    sk.reset_launches()
    for _, step, ev, rows, live, run, pl, pack in K2.values():
        assert _equal(sk.frontier_closure(step, ev, rows, live, run, pl,
                                          pack),
                      sk.frontier_closure_reference(step, ev, rows, live,
                                                    run, pl, pack))
    for _, *args in K3.values():
        assert _equal(sk.hash_insert(*args), sk.hash_insert_reference(*args))
    for _, *args in K4.values():
        assert _equal(sk.tiled_insert(*args),
                      sk.tiled_insert_reference(*args))
    for _, *args in K4B.values():
        assert _equal(sk.tiled_insert_batch(*args),
                      sk.tiled_insert_batch_reference(*args))
    assert all(v == 0 for v in sk.launches.values())


def _triple(rows, pack, C):
    """Packed rows -> the (state, mask_lo, mask_hi) triple."""
    s_bits, s_lo = pack
    word = rows[0].numpy().view(np.uint32).astype(np.uint64)
    if len(rows) == 2:
        word |= rows[1].numpy().view(np.uint32).astype(np.uint64) << \
            np.uint64(32)
    st = ((word & np.uint64((1 << s_bits) - 1)).astype(np.int64) + s_lo)
    mask = word >> np.uint64(s_bits)
    ml = (mask & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    mh = (mask >> np.uint64(32)).astype(np.uint32).view(np.int32)
    st = ((st + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    return tuple(torch.from_numpy(x.copy()) for x in (st, ml, mh))


@pytest.mark.parametrize("name", [n for n in K2 if "pl32" in n or
                                  "equal" in n or "extremes" in n])
def test_packed_k2_closes_what_the_triple_closes(name):
    """The same configurations, counts, passes and stepped rows on the
    packed word and on the triple (the table, its hash, and so the row
    order differ)."""
    _, step, ev, rows, live, run, pl, pack = K2[name]
    C = ev["slot_f"].shape[0]
    p_rows, p_meta = sk.frontier_closure(step, ev, rows, live, run, pl, pack)
    assert int(p_meta[1]) == 0   # past N, the rows kept follow the order
    t_rows, t_meta = sk.frontier_closure(step, ev, _triple(rows, pack, C),
                                         live, run, pl)
    assert p_meta.tolist() == t_meta.tolist()
    n = int(p_meta[0])
    got = set(zip(*(r[:n].tolist() for r in _triple(p_rows, pack, C))))
    want = set(zip(*(r[:n].tolist() for r in t_rows)))
    assert got == want and len(got) == n


# ---------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K2))
def test_cuda_packed_k2_matches_plain(name):
    dev = _cuda()
    _, step, ev, rows, live, run, pl, pack = K2[name]
    want = sk.frontier_closure_reference(step, ev, rows, live, run, pl, pack)
    sk.reset_launches()
    got = sk.frontier_closure(step, _to(ev, dev), _to(rows, dev),
                              live.to(dev), run.to(dev), pl, pack)
    torch.cuda.synchronize()
    assert sk.launches["frontier_closure"] == 1
    assert _equal(got, want)


def _k2_batch(name):
    """Three keys on event rows [ev, ev with its slots reversed]: the case,
    the same with run False, and the case's frontier with its first live
    row dropped."""
    _, step, ev, rows, live, run, pl, pack = K2[name]
    rev = {k: v.flip(0) for k, v in ev.items()}
    xs = {k: torch.stack([ev[k], rev[k]])[None].expand(3, 2, -1)
          .contiguous() for k in ev}
    live2 = live.clone()
    live2[int(live.nonzero()[0])] = False
    return (step, xs, tuple(torch.stack([r, r, r]) for r in rows),
            torch.stack([live, live, live2]),
            torch.tensor([True, False, True]), pl, pack)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["register L1 s4 C16 N4096 top field pl32",
                                  "gset L2 s20 C14 lane boundary pl32",
                                  "register L2 s32 C30 extremes"])
@pytest.mark.parametrize("r", [0, 1])
def test_cuda_packed_k2_batch_matches_plain(name, r):
    dev = _cuda()
    step, xs, rows, live, run, pl, pack = _k2_batch(name)
    want = sk.frontier_closure_batch_reference(step, xs, r, rows, live, run,
                                               pl, pack)
    sk.reset_launches()
    got = sk.frontier_closure_batch(step, _to(xs, dev), r, _to(rows, dev),
                                    live.to(dev), run.to(dev), pl, pack)
    torch.cuda.synchronize()
    assert sk.launches["frontier_closure_batch"] == 1
    assert _equal(got, want)


# every case through the wrapper and with the grid forced; one block
# forced where the table fits its shared memory (on Hopper)
K3_RUNS = [(n, lay) for n, c in K3.items() for lay in
           ("wrapper", "device") + (("shared",) if sk.k3_layout(
               c[5][1].shape[0] // 2, lanes=len(c[1])) == "shared" else ())]


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout", K3_RUNS)
def test_cuda_packed_k3_matches_plain(name, layout):
    dev = _cuda()
    _, c_rows, c_live, f_rows, count, table, pl, N = K3[name]
    T = table[1].shape[0]
    L = len(c_rows)
    want = sk.hash_insert_reference(c_rows, c_live, f_rows, count, table,
                                    pl, N)
    args = _to((c_rows, c_live, f_rows, count, table), dev)
    sk.reset_launches()
    if layout == "wrapper":
        got = sk.hash_insert(*args, pl, N)
        layout = sk.k3_layout(T // 2, dev, L)
    else:
        got = sk._hash_insert_launch(*args, pl, N, layout)
    torch.cuda.synchronize()
    assert sk.hash_insert_launches[layout] == 1
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K4))
def test_cuda_packed_k4_matches_plain(name):
    dev = _cuda()
    _, c_rows, c_live, table, pl = K4[name]
    want = sk.tiled_insert_reference(c_rows, c_live, table, pl)
    sk.reset_launches()
    got = sk.tiled_insert(_to(c_rows, dev), c_live.to(dev),
                          _to(table, dev), pl)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == 1
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K4B))
def test_cuda_packed_k4_batch_matches_plain(name):
    dev = _cuda()
    _, c_rows, c_live, table, pl = K4B[name]
    want = sk.tiled_insert_batch_reference(c_rows, c_live, table, pl)
    sk.reset_launches()
    got = sk.tiled_insert_batch(_to(c_rows, dev), c_live.to(dev),
                                _to(table, dev), pl)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert_batch"] == 1
    assert _equal(got, want)
