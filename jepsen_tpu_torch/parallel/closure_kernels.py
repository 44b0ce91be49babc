"""The bitdense closure fixpoint: K1's wrapper and its plain version.

`closure_fixpoint(sel, B, C)` keeps the contract of the TPU kernel it
replaces (`jepsen_tpu.parallel.pallas_kernels.closure_fixpoint`):

    sel [C, S, S] int32   FULL (-1) where slot j may step state s -> t
    B   [S, W]    int32   reachable set, bit b of word w = mask w*32 + b
    ->  B' [S, W]         the least superset of B closed under
                          (s, m) -> (t, m | 1 << j) for j not in m

Words are int32 bit patterns (PyTorch's CPU build has no shifts on
uint32). On a CUDA tensor the wrapper launches the hand-written kernel
in `jepsen_tpu_torch/kernels/closure.cu` — over a thread-block cluster,
one block or one block on device memory, as `closure_plan` says — or
raises; on a CPU tensor it runs `closure_fixpoint_reference`, the plain
PyTorch version, which the tests and `chip_smoke.py` hold the kernel
against.

`closure_scan_batch(sel [E, K, C, S, S], B [K, S, W], ok [K], fail_r
[K], slot [E, K], real [E, K], r0, C, traj=None)` is the batched dense
scan of K keys of one padded shape over a chunk of E event rows — the
per-key scan that the reference vmaps
(`jepsen_tpu.parallel.bitdense._check_bitdense_batch`): for each row a
running key (ok, and the row is one of its events) closes B under the
row's selects, keeps the masks in which its returning slot has
linearized (`filter_keys`), and fails at the row where nothing is left.
On a CUDA tensor it is one launch of the kernel's persistent scan, each
key in `closure_plan_batch`'s layout walking every row with its B in
shared memory; its plain version, on a CPU tensor, runs the rows one by
one with `closure_fixpoint_batch_reference`, the plain closure of K keys
at once.
"""

from __future__ import annotations

import ctypes

import torch

_I32 = torch.int32

# Kernel launches since the last reset: incremented once per launch of
# the CUDA kernel, never by the plain version; `launches` counts the
# single-key closures and `batch_launches` the batched scans (one a
# chunk of event rows).
launches = 0
batch_launches = 0


def reset_launches() -> None:
    global launches, batch_launches
    launches = 0
    batch_launches = 0


def n_words(C: int) -> int:
    return max(1, (1 << C) // 32)


def _check_args(sel, B, C: int) -> None:
    if not 1 <= C <= 24:
        raise ValueError(f"closure: C={C} outside 1..24")
    if sel.dtype != _I32 or B.dtype != _I32:
        raise TypeError(f"closure: sel and B must be int32, got "
                        f"{sel.dtype} and {B.dtype}")
    if B.dim() != 2 or B.shape[1] != n_words(C):
        raise ValueError(f"closure: B must be [S, {n_words(C)}] for C={C}, "
                         f"got {tuple(B.shape)}")
    S = B.shape[0]
    if tuple(sel.shape) != (C, S, S):
        raise ValueError(f"closure: sel must be [{C}, {S}, {S}], got "
                         f"{tuple(sel.shape)}")
    if not 1 <= S <= 128:
        raise ValueError(f"closure: S={S} outside 1..128")
    if sel.device != B.device:
        raise ValueError(f"closure: sel on {sel.device}, B on {B.device}")


def _check_batch_args(sel, B, C: int, run) -> None:
    if B.dim() != 3 or sel.dim() != 4 or sel.shape[0] != B.shape[0] \
            or B.shape[0] < 1:
        raise ValueError(f"closure batch: sel must be [K, C, S, S] and B "
                         f"[K, S, W], got {tuple(sel.shape)} and "
                         f"{tuple(B.shape)}")
    _check_args(sel[0], B[0], C)
    if run is not None and (run.dtype != torch.bool
                            or tuple(run.shape) != (B.shape[0],)
                            or run.device != B.device):
        raise ValueError(f"closure batch: run must be bool [{B.shape[0]}] "
                         f"on B's device")


def _check_scan_args(sel, B, ok, fail_r, slot, real, r0: int, C: int,
                     traj) -> None:
    if sel.dim() != 5 or sel.shape[0] < 1:
        raise ValueError(f"closure scan: sel must be [E, K, C, S, S], got "
                         f"{tuple(sel.shape)}")
    E = sel.shape[0]
    _check_batch_args(sel[0], B, C, None)
    K = B.shape[0]
    for name, t, dtype, shape in (("ok", ok, torch.bool, (K,)),
                                  ("fail_r", fail_r, _I32, (K,)),
                                  ("slot", slot, _I32, (E, K)),
                                  ("real", real, torch.bool, (E, K))):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != B.device:
            raise ValueError(f"closure scan: {name} must be {dtype} "
                             f"{list(shape)} on B's device")
    if traj is not None and (traj.dtype != _I32 or traj.dim() != 3
                             or traj.shape[0] != K or traj.shape[2] != 2
                             or traj.shape[1] < r0 + E
                             or traj.device != B.device):
        raise ValueError(f"closure scan: traj must be int32 [{K}, >= "
                         f"{r0 + E}, 2] on B's device")
    if r0 < 0:
        raise ValueError(f"closure scan: r0={r0} < 0")


# ------------------------------------------------------------ plain version

def _unpack(B):
    """[..., S, W] int32 words -> [..., S, 32*W] bool, mask m = w*32 + b."""
    shifts = torch.arange(32, dtype=_I32, device=B.device)
    return ((B.unsqueeze(-1) >> shifts) & 1).bool().flatten(-2)


def _pack(bits, W: int):
    """Inverse of _unpack."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.unflatten(-1, (W, 32)).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(_I32)


def _expand(X, step, C: int):
    """One expansion of unpacked masks X [..., S, M]: for each slot j the
    configurations with mask bit j clear step through step[..., j] (a 0/1
    matrix product over the states, exact in float32 since S <= 128)
    into their twins with bit j set."""
    lead = X.shape[:-1]
    out = X.clone()
    for j in range(C):
        lo = 1 << j
        ext = X.view(*lead, -1, 2, lo)[..., 0, :].reshape(*lead, -1)
        moved = (step[..., j, :, :].transpose(-1, -2)
                 @ ext.to(torch.float32)) > 0               # [..., S(t), M/2]
        out.view(*lead, -1, 2, lo)[..., 1, :] |= moved.view(*lead, -1, lo)
    return out


def closure_reference_expansions(sel, B, C: int):
    """The plain closure as (B', expansions): the number of expansions
    run, the last of which found nothing new."""
    _check_args(sel, B, C)
    S, W = B.shape
    X = _unpack(B)                                     # [S, M]
    step = (sel != 0).to(torch.float32)                # [C, S(s), S(t)]
    n = 0
    while True:
        X2 = _expand(X, step, C)
        n += 1
        if torch.equal(X2, X):
            return _pack(X, W), n
        X = X2


def closure_fixpoint_reference(sel, B, C: int):
    """The plain PyTorch closure: expand unpacked masks until nothing
    changes."""
    return closure_reference_expansions(sel, B, C)[0]


def double_expansion_iters(n: int) -> int:
    """The search-stats `closure-iters` of a closure that ran `n`
    expansions (`closure_reference_expansions`), under the reference's
    rule for its counted loop (bitdense.py `iters = 2 * n`): that loop
    runs double expansions until one changes nothing, so n - 1 changing
    expansions take n // 2 + 1 of them."""
    return 2 * (n // 2 + 1)


def _batch_reference_counted(sel, B, C: int, run=None):
    """The plain batched closure and each key's `closure-iters` (0 for a
    key whose `run` flag is False, which is returned as it is). The
    running keys expand together; each key's expansions are counted
    until its own finds nothing new, as `closure_reference_expansions`
    counts them for the key alone (a closed key's expansions change
    nothing)."""
    _check_batch_args(sel, B, C, run)
    K, S, W = B.shape
    out = B.clone()
    n = [0] * K
    idx = torch.arange(K, device=B.device) if run is None \
        else torch.nonzero(run).flatten()
    if idx.numel():
        X = _unpack(B[idx])                                 # [k, S, M]
        step = (sel[idx] != 0).to(torch.float32)            # [k, C, S, S]
        active = torch.ones(idx.numel(), dtype=torch.bool, device=B.device)
        count = torch.zeros(idx.numel(), dtype=torch.int64, device=B.device)
        while True:
            X2 = _expand(X, step, C)
            count += active
            active &= (X2 != X).flatten(1).any(1)
            X = X2
            if not bool(active.any()):
                break
        out[idx] = _pack(X, W)
        for k, c in zip(idx.tolist(), count.tolist()):
            n[k] = c
    return out, [double_expansion_iters(c) if c else 0 for c in n]


def closure_fixpoint_batch_reference(sel, B, C: int, run=None):
    """The plain batched closure: `closure_fixpoint_reference` key by
    key; a key whose `run` flag is False is returned as it is."""
    return _batch_reference_counted(sel, B, C, run)[0]


def intra_clear(j: int) -> int:
    """32-bit constant with 1s at bit-positions whose mask-bit j is 0."""
    out = 0
    for p in range(32):
        if (p >> j) & 1 == 0:
            out |= 1 << p
    return out


def filter_tables(C: int, device):
    """The filter's word tables, [C, W] each, for every slot j: the word
    each word of the filtered set is gathered from (w | 2^(j-5) for j >=
    5, w itself for j < 5) and the int32 mask it is then ANDed with (for
    j >= 5 all ones where w's bit j-5 is clear, else 0; all ones for j <
    5, whose filter shifts within the word). The single scan's `_Tables`
    and `filter_keys` both read these."""
    w = torch.arange(n_words(C), device=device)
    jb = torch.tensor([1 << (j - 5) if j >= 5 else 0 for j in range(C)],
                      device=device)[:, None]
    return w ^ jb, torch.where((w & jb) == 0, -1, 0).to(_I32)


def filter_keys(B, slot, C: int):
    """Each key's filter on its own returning slot j = slot[k] (int [K],
    in [0, C)), B [K, S, W]: keep the configurations in which slot j has
    linearized, with its bit cleared — for j < 5 each word shifted right
    by 2^j and masked to the positions whose bit j is clear, for j >= 5
    word w taken from w | 2^(j-5) where w's bit j-5 is clear, else 0
    (`filter_tables`)."""
    K, S, W = B.shape
    j = slot.long()
    widx, mask = filter_tables(C, B.device)
    g = torch.gather(B, 2, widx[j][:, None].expand(K, S, W)) & mask[j][:, None]
    shift = torch.where(j < 5, 1 << j.clamp(max=4), 0).to(_I32)
    intra = torch.tensor([intra_clear(i) for i in range(5)] + [-1],
                         dtype=_I32, device=B.device)[j.clamp(max=5)]
    return (g >> shift.view(K, 1, 1)) & intra.view(K, 1, 1)


def popcount(B, dims):
    """The set bits of int32 words B, summed over `dims`."""
    shifts = torch.arange(32, dtype=_I32, device=B.device)
    return ((B.unsqueeze(-1) >> shifts) & 1).sum([*dims, -1])


def closure_scan_batch_reference(sel, B, ok, fail_r, slot, real, r0: int,
                                 C: int, traj=None) -> None:
    """The plain batched scan (contract in the module docstring): row by
    row, the running keys' closures (`closure_fixpoint_batch_reference`,
    a key not running left as it is), each key's filter on its slot, and
    the failure at the first row that empties a running key's set (its
    B the empty filtered set, fail_r that row, ok False). Updates B, ok
    and fail_r in place; with `traj` each row's (width: the popcount of
    the filtered set, -1 where the key did not run; closure-iters: the
    plain closure's counted double expansions, 0 where it did not run)
    into traj[:, r0 + i]."""
    K = B.shape[0]
    b, o, f = B.clone(), ok.clone(), fail_r.clone()
    for i in range(sel.shape[0]):
        run = o & real[i]
        B2, n = _batch_reference_counted(sel[i], b, C, run)
        B3 = filter_keys(B2, slot[i], C)
        if traj is not None:
            traj[:, r0 + i] = torch.stack([
                torch.where(run, popcount(B3, (1, 2)), -1).to(_I32),
                torch.tensor(n, dtype=_I32, device=B.device)], 1)
        failed = run & ~B3.flatten(1).any(1)
        # a running key has not failed before: this is its first failure
        f = torch.where(failed, r0 + i, f)
        b = torch.where(run.view(K, 1, 1), B3, B2)
        o = o & ~failed
    B.copy_(b)
    ok.copy_(o)
    fail_r.copy_(f)


# ----------------------------------------------------------------- kernel

# The kernel's layouts (kernels/closure.cu): "cluster" splits B's words
# over a thread-block cluster, each block holding its share in shared
# memory; "shared" is that kernel as one block; "global" is one block
# updating B in device memory. The batched scan runs each key in one of
# them.
HOPPER_SMEM_OPTIN = 232_448   # dynamic shared memory a Hopper block can use
HOPPER_SMS = 132
MAX_THREADS = 1024
MAX_CLUSTER = 16              # with the non-portable cluster size allowed
MIN_BLOCK_WORDS = 16          # no split leaves a block fewer words a state
SCAN_WORDS = 40
SPLIT_FIXED_WORDS = 2 * MAX_CLUSTER + SCAN_WORDS   # sweep flags and scan
_LAYOUT_CODES = {"global": 0, "shared": 1, "cluster": 2}


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def k1_block_bytes(S: int, C: int, block_words: int,
                   buffers: int = 1) -> int:
    """Shared memory of one block of the split kernel ("shared" or
    "cluster") owning `block_words` words of each of the S states:
    `buffers` copies of its words of B (the batched scan's filter writes
    into a second), the repacked sel (a mask over the sources per (j,
    t)), the pair list (an item offset and a 2-byte entry per (j, t),
    padded to 16 bytes), the sweep flags and the scan words. closure.cu's
    split_smem lays out the same bytes."""
    SW = (S + 31) // 32
    pairs = C * S
    head = 4 * (buffers * S * block_words + C * S * SW + pairs + 1)
    head = (head + 2 * pairs + 15) // 16 * 16
    return head + 4 * SPLIT_FIXED_WORDS


def _split_plan(S: int, C: int, k: int) -> dict:
    Wb = n_words(C) // k
    return {"layout": "shared" if k == 1 else "cluster", "cluster": k,
            "block_words": Wb,
            "threads": min(MAX_THREADS, max(64, _pow2_ceil(S * Wb))),
            "smem": k1_block_bytes(S, C, Wb)}


def _global_plan(S: int, C: int) -> dict:
    W = n_words(C)
    return {"layout": "global", "cluster": 1, "block_words": W,
            "threads": min(MAX_THREADS, max(32, -(-S * W // 32) * 32)),
            "smem": C * S * ((S + 31) // 32) * 4}


def closure_plan(S: int, C: int, optin: int = HOPPER_SMEM_OPTIN,
                 max_cluster: int = MAX_CLUSTER) -> dict:
    """K1's launch for an [S, W] B on a card whose block may opt in to
    `optin` bytes of shared memory and which runs clusters of up to
    `max_cluster` blocks: {"layout", "cluster" (blocks), "block_words"
    (words of each state a block holds), "threads" (per block), "smem"
    (bytes per block)}.

    The cluster size is the least power of two that leaves each block at
    most 1,024 words of B (a thread a word), raised until a block's share
    fits `optin`; it never leaves a block fewer than 16 words a state
    (C <= 9 never splits) nor passes `max_cluster`. One block is the
    "shared" layout; a shape that no cluster holds is "global"."""
    W = n_words(C)
    k_max = max(1, min(max_cluster, W // MIN_BLOCK_WORDS))
    k = min(k_max, _pow2_ceil(-(-S * W // MAX_THREADS)))
    while k <= k_max and k1_block_bytes(S, C, W // k) > optin:
        k *= 2
    return _global_plan(S, C) if k > k_max else _split_plan(S, C, k)


def closure_plans(S: int, C: int, optin: int = HOPPER_SMEM_OPTIN,
                  max_cluster: int = MAX_CLUSTER) -> dict:
    """Every layout the kernel can run this shape in -> its plan:
    "global" always, "shared" when one block holds B, "cluster" when
    `closure_plan` chooses it. The parity checks run each."""
    out = {"global": _global_plan(S, C)}
    if k1_block_bytes(S, C, n_words(C)) <= optin:
        out["shared"] = _split_plan(S, C, 1)
    chosen = closure_plan(S, C, optin, max_cluster)
    out[chosen["layout"]] = chosen
    return out


def _scan_split_plan(S: int, C: int, k: int) -> dict:
    plan = _split_plan(S, C, k)
    plan["smem"] = k1_block_bytes(S, C, plan["block_words"], 2)
    return plan


def _scan_global_plan(S: int, C: int) -> dict:
    plan = _global_plan(S, C)
    plan["smem"] += 4 * SCAN_WORDS
    return plan


def closure_plan_batch(K: int, S: int, C: int,
                       optin: int = HOPPER_SMEM_OPTIN,
                       max_cluster: int = MAX_CLUSTER,
                       n_sm: int = HOPPER_SMS) -> dict:
    """The batched scan's launch for K keys of an [S, W] B on a card of
    `n_sm` SMs whose block may opt in to `optin` bytes of shared memory
    and which runs clusters of up to `max_cluster` blocks: a plan as
    `closure_plan`'s, for each key.

    A key takes one block ("shared") wherever its B fits one block twice
    over (the filter's double buffer), else the least cluster whose
    blocks hold their shares; past every cluster, one block on device
    memory ("global"). The cluster then grows while the batch leaves SMs
    idle (K times its size at most `n_sm`) and each block keeps at least
    1,024 words (a word a thread)."""
    W = n_words(C)
    k_max = max(1, min(max_cluster, W // MIN_BLOCK_WORDS))
    k = 1
    while k <= k_max and k1_block_bytes(S, C, W // k, 2) > optin:
        k *= 2
    if k > k_max:
        return _scan_global_plan(S, C)
    while 2 * k <= k_max and K * 2 * k <= n_sm \
            and S * (W // (2 * k)) >= MAX_THREADS:
        k *= 2
    return _scan_split_plan(S, C, k)


def closure_plans_batch(K: int, S: int, C: int,
                        optin: int = HOPPER_SMEM_OPTIN,
                        max_cluster: int = MAX_CLUSTER,
                        n_sm: int = HOPPER_SMS) -> dict:
    """Every layout the batched scan can run this shape in -> its plan,
    for the parity checks: "global" always; "shared" where one block
    holds B twice over; "cluster" — `closure_plan_batch`'s, or the least
    cluster the shape splits into."""
    W = n_words(C)
    k_max = max(1, min(max_cluster, W // MIN_BLOCK_WORDS))
    fits = [k for k in (1 << i for i in range(k_max.bit_length()))
            if k1_block_bytes(S, C, W // k, 2) <= optin]
    out = {"global": _scan_global_plan(S, C)}
    if 1 in fits:
        out["shared"] = _scan_split_plan(S, C, 1)
    chosen = closure_plan_batch(K, S, C, optin, max_cluster, n_sm)
    if chosen["layout"] == "cluster":
        out["cluster"] = chosen
    elif any(k > 1 for k in fits):
        out["cluster"] = _scan_split_plan(S, C, min(k for k in fits if k > 1))
    return out


_lib = None
# device index -> (the block's shared-memory opt-in there, the largest
# cluster the card runs there), read by jt_closure_init once
_card: dict = {}
# (device index, S, C) -> the plan, checked against the card once; and
# (device index, K, S, C) -> the batched scan's
_plans: dict = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        from jepsen_tpu_torch import kernels
        lib = kernels.load("closure")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.jt_closure_launch.argtypes = [P] * 4 + [I] * 6 + [P]
        lib.jt_closure_launch.restype = I
        lib.jt_closure_scan_launch.argtypes = [P] * 7 + [I] * 10 + [P]
        lib.jt_closure_scan_launch.restype = I
        for name, n_args in (("jt_closure_init", 0),
                             ("jt_closure_max_cluster", 0),
                             ("jt_closure_active_clusters", 5),
                             ("jt_closure_split_smem", 3),
                             ("jt_closure_scan_active_clusters", 5),
                             ("jt_closure_scan_smem", 3)):
            fn = getattr(lib, name)
            fn.argtypes = [I] * n_args
            fn.restype = ctypes.c_longlong if name.endswith("smem") else I
        _lib = lib
    return _lib


def _index(device) -> int:
    index = torch.device("cuda" if device is None else device).index
    return torch.cuda.current_device() if index is None else index


def card_limits(device=None) -> tuple:
    """(shared-memory opt-in in bytes, largest cluster) of the card, read
    once per device by jt_closure_init."""
    index = _index(device)
    v = _card.get(index)
    if v is None:
        lib = _kernel_lib()
        with torch.cuda.device(index):
            optin = lib.jt_closure_init()
            max_cluster = lib.jt_closure_max_cluster()
        if optin <= 0:
            raise RuntimeError(f"closure kernel: cannot set up device "
                               f"{index}: CUDA error {-optin}")
        v = _card[index] = (optin, max_cluster)
    return v


def sm_count(device=None) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(_index(device)) \
        .multi_processor_count


def _check_plan(plan: dict, S: int, C: int, index: int, smem_fn,
                clusters_fn, what: str) -> None:
    """Raise unless the card's layout of `plan` agrees with its bytes and,
    for a cluster, the card can keep one resident."""
    if plan["layout"] == "global":
        return
    log_wb = plan["block_words"].bit_length() - 1
    smem = smem_fn(log_wb)
    if smem != plan["smem"]:
        raise RuntimeError(f"closure kernel: {what} layout disagrees at "
                           f"S={S} C={C}: {smem} != {plan}")
    if plan["layout"] == "cluster":
        with torch.cuda.device(index):
            n = clusters_fn(log_wb)
        if n <= 0:
            raise RuntimeError(
                f"closure kernel: the card cannot run a {what} cluster of "
                f"{plan['cluster']} blocks of {plan['threads']} threads "
                f"and {plan['smem']} bytes at S={S} C={C} (CUDA "
                f"{'error ' + str(-n) if n < 0 else 'occupancy 0'})")


def device_plan(S: int, C: int, device=None) -> dict:
    """`closure_plan` with the card's limits. A cluster the card cannot
    keep resident at the plan's shared memory raises."""
    index = _index(device)
    plan = _plans.get((index, S, C))
    if plan is None:
        plan = closure_plan(S, C, *card_limits(index))
        lib = _kernel_lib()
        _check_plan(plan, S, C, index,
                    lambda lw: lib.jt_closure_split_smem(S, C, lw),
                    lambda lw: lib.jt_closure_active_clusters(
                        S, C, lw, plan["cluster"], plan["threads"]), "K1")
        _plans[(index, S, C)] = plan
    return plan


def device_plan_batch(K: int, S: int, C: int, device=None) -> dict:
    """`closure_plan_batch` with the card's limits, checked as
    `device_plan`'s."""
    index = _index(device)
    plan = _plans.get((index, K, S, C))
    if plan is None:
        plan = closure_plan_batch(K, S, C, *card_limits(index),
                                  sm_count(index))
        _check_batch_plan(plan, S, C, index)
        _plans[(index, K, S, C)] = plan
    return plan


def _check_batch_plan(plan: dict, S: int, C: int, index: int) -> None:
    lib = _kernel_lib()
    _check_plan(plan, S, C, index,
                lambda lw: lib.jt_closure_scan_smem(S, C, lw),
                lambda lw: lib.jt_closure_scan_active_clusters(
                    S, C, lw, plan["cluster"], plan["threads"]),
                "batched scan")


def kernel_layout(S: int, C: int, device=None) -> str:
    """K1's layout for this shape on `device` (default: the current
    card): "cluster", "shared" or "global" (`closure_plan`)."""
    return device_plan(S, C, device)["layout"]


def _launch(sel, B, out, C: int, run=None, plan=None) -> None:
    """One launch of K1 on CUDA tensors (sel [C, S, S], B and out [S, W]),
    in `plan` (default: the card's `device_plan`; chip_smoke.py also runs
    the other layouts a shape can take). Raises on a launch the card
    refuses."""
    global launches
    if run is not None and (run.dtype != torch.bool or run.numel() != 1
                            or run.device != B.device):
        raise ValueError("closure kernel: run must be one bool on B's device")
    if not (sel.is_contiguous() and B.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("closure kernel: tensors must be contiguous")
    if out.shape != B.shape or out.dtype != B.dtype \
            or out.device != B.device:
        raise ValueError("closure kernel: out must match B")
    S = B.shape[0]
    if plan is None:
        plan = device_plan(S, C, B.device)
    with torch.cuda.device(B.device):
        err = _kernel_lib().jt_closure_launch(
            sel.data_ptr(), B.data_ptr(), out.data_ptr(),
            None if run is None else run.data_ptr(), S, C,
            _LAYOUT_CODES[plan["layout"]], plan["cluster"],
            plan["block_words"].bit_length() - 1, plan["threads"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closure kernel launch failed ({plan['layout']} "
                           f"layout): CUDA error {err}")
    launches += 1


def closure_fixpoint(sel, B, C: int, *, run=None, out=None, iters=None):
    """K1: the closure fixpoint of one return event (contract in the
    module docstring). A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel, on the current stream.

    For the scan only: `out` receives B' (it may be B itself, for an
    in-place update), and `run`, a one-element bool tensor on B's
    device, makes the kernel leave B unchanged when it is False, without
    the host reading it. The plain version ignores `run`: the scan
    discards a non-running event's closure anyway. `iters`, a
    one-element int32 tensor on B's device, receives the search-stats
    `closure-iters` under the reference's rule for the path that ran:
    the plain version's counted double expansions
    (`double_expansion_iters`), or -1 where the kernel ran, as the
    reference's Pallas path reports (its count never leaves the
    kernel)."""
    _check_args(sel, B, C)
    if B.device.type == "cpu":
        res, n = closure_reference_expansions(sel, B, C)
        if iters is not None:
            iters.fill_(double_expansion_iters(n))
        if out is None:
            return res
        out.copy_(res)
        return out
    if B.device.type != "cuda":
        raise RuntimeError(f"closure: no kernel for device {B.device}")
    if out is None:
        out = torch.empty_like(B)
    _launch(sel, B, out, C, run)
    if iters is not None:
        iters.fill_(-1)
    return out


def _launch_scan(sel, B, ok, fail_r, slot, real, r0: int, C: int,
                 traj=None, plan=None) -> None:
    """One launch of the batched scan over the chunk's E rows for the K
    keys of CUDA tensors (contract of `closure_scan_batch`), each key in
    `plan` (default: the card's `device_plan_batch`; the tests and
    chip_smoke.py run every layout of `closure_plans_batch`). Raises on a
    launch the card refuses."""
    global batch_launches
    ts = (sel, B, ok, fail_r, slot, real) + (() if traj is None else (traj,))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("closure scan: tensors must be contiguous")
    E, K, _, S, _ = sel.shape
    if plan is None:
        plan = device_plan_batch(K, S, C, B.device)
    else:
        _check_batch_plan(plan, S, C, _index(B.device))
    with torch.cuda.device(B.device):
        err = _kernel_lib().jt_closure_scan_launch(
            sel.data_ptr(), B.data_ptr(), ok.data_ptr(), fail_r.data_ptr(),
            slot.data_ptr(), real.data_ptr(),
            None if traj is None else traj.data_ptr(), E, K, r0,
            0 if traj is None else traj.shape[1], S, C,
            _LAYOUT_CODES[plan["layout"]], plan["cluster"],
            plan["block_words"].bit_length() - 1, plan["threads"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closure scan launch failed ({plan['layout']} "
                           f"layout, {K} keys, {E} rows): CUDA error {err}")
    batch_launches += 1


def closure_scan_batch(sel, B, ok, fail_r, slot, real, r0: int, C: int, *,
                       traj=None) -> None:
    """The batched dense scan over a chunk of E event rows r0 .. r0+E-1
    (contract in the module docstring): sel [E, K, C, S, S] int32, the
    carry B [K, S, W] int32, ok [K] bool and fail_r [K] int32, updated in
    place, slot [E, K] int32 (each row's returning slot, in [0, C)), real
    [E, K] bool (the row is one of the key's events; a pad row is not);
    `traj`, int32 [K, R, 2] with R >= r0 + E, receives each row's width
    and closure-iters at r0 + i (-1 iterations where the kernel ran: its
    count never leaves it). A CPU tensor runs the plain version
    (`closure_scan_batch_reference`); a CUDA tensor makes one launch of
    the kernel, on the current stream, in the layout
    `device_plan_batch(K, S, C)` gives, or raises."""
    _check_scan_args(sel, B, ok, fail_r, slot, real, r0, C, traj)
    if B.device.type == "cpu":
        closure_scan_batch_reference(sel, B, ok, fail_r, slot, real, r0, C,
                                     traj)
        return
    if B.device.type != "cuda":
        raise RuntimeError(f"closure: no kernel for device {B.device}")
    _launch_scan(sel, B, ok, fail_r, slot, real, r0, C, traj)
