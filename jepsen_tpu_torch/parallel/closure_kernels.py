"""The bitdense closure fixpoint: K1's wrapper and its plain version.

`closure_fixpoint(sel, B, C)` keeps the contract of the TPU kernel it
replaces (`jepsen_tpu.parallel.pallas_kernels.closure_fixpoint`):

    sel [C, S, S] int32   FULL (-1) where slot j may step state s -> t
    B   [S, W]    int32   reachable set, bit b of word w = mask w*32 + b
    ->  B' [S, W]         the least superset of B closed under
                          (s, m) -> (t, m | 1 << j) for j not in m

Words are int32 bit patterns (PyTorch's CPU build has no shifts on
uint32). On a CUDA tensor the wrapper launches the hand-written kernel
in `jepsen_tpu_torch/kernels/closure.cu` or raises; on a CPU tensor it
runs `closure_fixpoint_reference`, the plain PyTorch version, which the
tests and `chip_smoke.py` hold the kernel against.
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

_lib = None
# device index -> the block's shared-memory opt-in there, in bytes, read
# by jt_closure_init (which also grants it to the kernel on that device)
_optin: dict = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        from jepsen_tpu_torch import kernels
        lib = kernels.load("closure")
        lib.jt_closure_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.jt_closure_launch.restype = ctypes.c_int
        lib.jt_closure_init.argtypes = []
        lib.jt_closure_init.restype = ctypes.c_int
        _lib = lib
    return _lib


def _optin_bytes(index: int) -> int:
    v = _optin.get(index)
    if v is None:
        with torch.cuda.device(index):
            v = _kernel_lib().jt_closure_init()
        if v <= 0:
            raise RuntimeError(f"closure kernel: cannot set up device "
                               f"{index}: CUDA error {-v}")
        _optin[index] = v
    return v


def kernel_layout(S: int, C: int, device=None) -> str:
    """Where the kernel keeps B for this shape on `device` (default: the
    current card): "shared" (dynamic shared memory) when B and the
    repacked sel fit the block's opt-in, else "global" (device memory)."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    sel_bytes = C * S * ((S + 31) // 32) * 4
    fits = sel_bytes + S * n_words(C) * 4 <= _optin_bytes(index)
    return "shared" if fits else "global"


def _launch(sel, B, out, C: int, run=None) -> None:
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
    shared = kernel_layout(B.shape[0], C, B.device) == "shared"
    with torch.cuda.device(B.device):
        err = _kernel_lib().jt_closure_launch(
            sel.data_ptr(), B.data_ptr(), out.data_ptr(),
            None if run is None else run.data_ptr(),
            B.shape[0], C, int(shared),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closure kernel launch failed: CUDA error {err}")
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
