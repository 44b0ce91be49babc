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
"""

from __future__ import annotations

import ctypes

import torch

_I32 = torch.int32

# Kernel launches since the last reset: incremented once per launch of
# the CUDA kernel, never by the plain version.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


# ------------------------------------------------------------ plain version

def _unpack(B):
    """[S, W] int32 words -> [S, 32*W] bool, mask m = w*32 + b."""
    shifts = torch.arange(32, dtype=_I32, device=B.device)
    return ((B.unsqueeze(-1) >> shifts) & 1).bool().reshape(B.shape[0], -1)


def _pack(bits, W: int):
    """Inverse of _unpack."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.reshape(bits.shape[0], W, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(_I32)


def _expand(X, step, C: int):
    """One expansion of unpacked masks X [S, M]: for each slot j the
    configurations with mask bit j clear step through step[j] (a 0/1
    matrix product over the states, exact in float32 since S <= 128)
    into their twins with bit j set."""
    S = X.shape[0]
    out = X.clone()
    for j in range(C):
        lo = 1 << j
        ext = X.view(S, -1, 2, lo)[:, :, 0, :].reshape(S, -1)  # bit j clear
        moved = (step[j].T @ ext.to(torch.float32)) > 0         # [S(t), M/2]
        out.view(S, -1, 2, lo)[:, :, 1, :] |= moved.view(S, -1, lo)
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


# ----------------------------------------------------------------- kernel

# The kernel's layouts (kernels/closure.cu): "cluster" splits B's words
# over a thread-block cluster, each block holding its share in shared
# memory; "shared" is that kernel as one block; "global" is one block
# updating B in device memory.
HOPPER_SMEM_OPTIN = 232_448   # dynamic shared memory a Hopper block can use
MAX_THREADS = 1024
MAX_CLUSTER = 16              # with the non-portable cluster size allowed
MIN_BLOCK_WORDS = 16          # no split leaves a block fewer words a state
SPLIT_FIXED_WORDS = 2 * MAX_CLUSTER + 40   # sweep flags and scan words
_LAYOUT_CODES = {"global": 0, "shared": 1, "cluster": 2}


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def k1_block_bytes(S: int, C: int, block_words: int) -> int:
    """Shared memory of one block of the split kernel ("shared" or
    "cluster") owning `block_words` words of each of the S states: its
    words of B, the repacked sel (a mask over the sources per (j, t)),
    the pair list (an item offset and a 2-byte entry per (j, t), padded
    to 16 bytes), the sweep flags and the scan words. closure.cu's
    split_smem lays out the same bytes."""
    SW = (S + 31) // 32
    pairs = C * S
    head = 4 * (S * block_words + C * S * SW + pairs + 1)
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


_lib = None
# device index -> (the block's shared-memory opt-in there, the largest
# cluster the card runs there), read by jt_closure_init once
_card: dict = {}
# (device index, S, C) -> the plan, checked against the card once
_plans: dict = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        from jepsen_tpu_torch import kernels
        lib = kernels.load("closure")
        lib.jt_closure_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.jt_closure_launch.restype = ctypes.c_int
        for name, n_args in (("jt_closure_init", 0),
                             ("jt_closure_max_cluster", 0),
                             ("jt_closure_active_clusters", 5),
                             ("jt_closure_split_smem", 3)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int] * n_args
            fn.restype = ctypes.c_longlong \
                if name == "jt_closure_split_smem" else ctypes.c_int
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


def device_plan(S: int, C: int, device=None) -> dict:
    """`closure_plan` with the card's limits. A cluster the card cannot
    keep resident at the plan's shared memory raises."""
    index = _index(device)
    plan = _plans.get((index, S, C))
    if plan is None:
        plan = closure_plan(S, C, *card_limits(index))
        if plan["layout"] != "global":
            lib = _kernel_lib()
            log_wb = plan["block_words"].bit_length() - 1
            smem = lib.jt_closure_split_smem(S, C, log_wb)
            if smem != plan["smem"]:
                raise RuntimeError(f"closure kernel: layout disagrees at "
                                   f"S={S} C={C}: {smem} != {plan}")
        if plan["layout"] == "cluster":
            with torch.cuda.device(index):
                n = lib.jt_closure_active_clusters(
                    S, C, log_wb, plan["cluster"], plan["threads"])
            if n <= 0:
                raise RuntimeError(
                    f"closure kernel: the card cannot run a cluster of "
                    f"{plan['cluster']} blocks of {plan['threads']} threads "
                    f"and {plan['smem']} bytes at S={S} C={C} (CUDA "
                    f"{'error ' + str(-n) if n < 0 else 'occupancy 0'})")
        _plans[(index, S, C)] = plan
    return plan


def kernel_layout(S: int, C: int, device=None) -> str:
    """K1's layout for this shape on `device` (default: the current
    card): "cluster", "shared" or "global" (`closure_plan`)."""
    return device_plan(S, C, device)["layout"]


def _launch(sel, B, out, C: int, run=None, plan=None) -> None:
    """One launch of K1 on CUDA tensors, in `plan` (default: the card's
    `device_plan`; chip_smoke.py also runs the other layouts a shape can
    take). Raises on a launch the card refuses."""
    global launches
    if not (sel.is_contiguous() and B.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("closure kernel: tensors must be contiguous")
    if out.shape != B.shape or out.dtype != B.dtype \
            or out.device != B.device:
        raise ValueError("closure kernel: out must match B")
    if run is not None and (run.dtype != torch.bool or run.numel() != 1
                            or run.device != B.device):
        raise ValueError("closure kernel: run must be one bool on B's device")
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


def closure_fixpoint(sel, B, C: int, *, run=None, out=None):
    """K1: the closure fixpoint of one return event (contract in the
    module docstring). A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel, on the current stream.

    For the scan only: `out` receives B' (it may be B itself, for an
    in-place update), and `run`, a one-element bool tensor on B's
    device, makes the kernel leave B unchanged when it is False, without
    the host reading it. The plain version ignores `run`: the scan
    discards a non-running event's closure anyway."""
    _check_args(sel, B, C)
    if B.device.type == "cpu":
        res = closure_fixpoint_reference(sel, B, C)
        if out is None:
            return res
        out.copy_(res)
        return out
    if B.device.type != "cuda":
        raise RuntimeError(f"closure: no kernel for device {B.device}")
    if out is None:
        out = torch.empty_like(B)
    _launch(sel, B, out, C, run)
    return out
