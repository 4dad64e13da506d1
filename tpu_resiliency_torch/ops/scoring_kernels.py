"""Fused masked median + totals over telemetry windows: the Hopper kernel and its
plain PyTorch version.

Port of ``tpu_resiliency/ops/scoring_pallas.py``. The hot part of a scoring round
reduces raw timing windows ``[R, S, W]`` to per-(rank, signal) medians and weights.
On a CUDA tensor :func:`fused_median_weights` launches the hand-written kernel in
``csrc/median_weights.cu`` (the counterpart of the TPU ``loop`` kernel and its
shared tail). On a CPU tensor it runs :func:`median_weights_reference`, the same
rank-counting formulation in plain PyTorch. There is no other fallback: a CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_resiliency_torch.ops import _build

KERNEL_NAME = "median_weights"

#: Threads per block the kernel is compiled for at most (``__launch_bounds__``).
MAX_THREADS = 128
#: Shared memory one block may use on Hopper (227 KB opt-in, dynamic only).
MAX_SHARED_BYTES = 232_448
#: Largest window the kernel takes: one warp's masked windows must fit in shared memory.
MAX_WINDOW = MAX_SHARED_BYTES // (4 * 32)

_ROADMAP_ITEM = "ROADMAP.md Queue 2 (radix and pairwise window reduction)"


def block_threads(window: int) -> int:
    """Threads per block at ``window``: the widest of 128/64/32 whose staged windows
    (``threads * window`` f32 values) fit in one block's shared memory."""
    threads = MAX_THREADS
    while threads > 32 and threads * window * 4 > MAX_SHARED_BYTES:
        threads //= 2
    return threads


def kernel_supported(window: int, signals: int) -> bool:
    """Shape gate of the port's kernel: any signal count, and a window whose
    one-warp block still fits in shared memory (W <= :data:`MAX_WINDOW`)."""
    return signals >= 1 and 1 <= window <= MAX_WINDOW


def median_weights_reference(data: torch.Tensor, counts: torch.Tensor):
    """Plain PyTorch version of the kernel: ``(medians [R,S], weights [R,S])``.

    The loop formulation of the TPU kernel: invalid slots (position >= count) are
    masked to +inf, each element's stable rank
    ``#{x_j < x_i} + #{j < i : x_j == x_i}`` is accumulated over W passes, and the
    median is the mean of the elements ranked ``(n-1)//2`` and ``n//2`` with
    ``n = max(count, 1)``; +inf where the count is 0. The weight is the masked sum.
    """
    w = data.shape[-1]
    pos = torch.arange(w, dtype=torch.int32, device=data.device)
    valid = pos < counts[..., None]
    inf = torch.tensor(float("inf"), dtype=data.dtype, device=data.device)
    x = torch.where(valid, data, inf)
    rank = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
    for j in range(w):
        xj = x[..., j : j + 1]
        rank += (xj < x).to(torch.int32)
        rank += ((xj == x) & (j < pos)).to(torch.int32)
    n = counts.clamp(min=1)
    lo_idx = ((n - 1) // 2)[..., None]
    hi_idx = (n // 2)[..., None]
    x_finite = torch.where(valid, data, torch.zeros((), dtype=data.dtype, device=data.device))
    lo = torch.where(rank == lo_idx, x_finite, 0.0).sum(dim=-1)
    hi = torch.where(rank == hi_idx, x_finite, 0.0).sum(dim=-1)
    med = 0.5 * (lo + hi)
    return torch.where(counts > 0, med, inf), x_finite.sum(dim=-1)


def _kernel_fn():
    lib = _build.load(KERNEL_NAME).lib
    fn = lib.tr_median_weights_loop
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_longlong] * 5
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.tr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tr_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch_loop(data: torch.Tensor, counts: torch.Tensor):
    r, s, w = data.shape
    if not kernel_supported(w, s):
        raise ValueError(
            f"the kernel takes 1 <= W <= {MAX_WINDOW} (its shared-memory limit) and "
            f"S >= 1, got W={w}, S={s}"
        )
    medians = torch.empty((r, s), dtype=torch.float32, device=data.device)
    weights = torch.empty((r, s), dtype=torch.float32, device=data.device)
    if r == 0 or s == 0:
        return medians, weights
    lib, fn = _kernel_fn()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        code = fn(
            data.data_ptr(), counts.data_ptr(), medians.data_ptr(), weights.data_ptr(),
            r * s, s, w, *data.stride(), *counts.stride(), block_threads(w), stream,
        )
    if code != 0:
        msg = lib.tr_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"median_weights kernel launch failed: {msg} (cudaError {code})")
    fused_median_weights.launches += 1
    return medians, weights


def fused_median_weights(data: torch.Tensor, counts: torch.Tensor, *, mode: str = "loop"):
    """``(medians [R,S], weights [R,S])`` from windows ``data [R,S,W]`` (f32, any
    strides) and ``counts [R,S]`` (i32).

    On a CUDA tensor this launches the Hopper kernel on the current stream and adds
    one to ``fused_median_weights.launches``; on a CPU tensor it runs
    :func:`median_weights_reference`. Only ``mode="loop"`` is ported.
    """
    if mode in ("radix", "pairwise"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet; see {_ROADMAP_ITEM}")
    if mode != "loop":
        raise ValueError(f"unknown mode {mode!r}; the port has 'loop'")
    if data.dim() != 3 or counts.shape != data.shape[:2]:
        raise ValueError(
            f"expected data [R,S,W] and counts [R,S], got {tuple(data.shape)} and "
            f"{tuple(counts.shape)}"
        )
    if data.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError(f"expected f32 data and i32 counts, got {data.dtype} and {counts.dtype}")
    if data.device != counts.device:
        raise ValueError(f"data on {data.device} but counts on {counts.device}")
    if data.device.type == "cpu":
        return median_weights_reference(data, counts)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    return _launch_loop(data, counts)


#: Kernel launches made through :func:`fused_median_weights` (CUDA tensors only).
fused_median_weights.launches = 0
