"""Fused masked median + totals over telemetry windows: the Hopper kernels and their
plain PyTorch versions.

Port of ``tpu_resiliency/ops/scoring_pallas.py``. The hot part of a scoring round
reduces raw timing windows ``[R, S, W]`` to per-(rank, signal) medians and weights.
Three formulations, one hand-written CUDA kernel each, all launched through
:func:`fused_median_weights`:

- ``loop`` (``csrc/median_weights.cu``): the counterpart of the TPU ``loop`` kernel
  and its shared tail. Up to ``NETWORK_MAX_WINDOW`` (64) a thread holds its window in
  registers and sorts it with a bitonic network, so order statistic k is the sorted
  value at k, exactly what the stable rank picks; past it, each element's stable rank
  by W compare passes, O(W²). Its plain version keeps the JAX kernel's rank passes.
- ``pairwise`` (``csrc/median_weights_pairwise.cu``): the same ranks from all-pairs
  compares. Up to ``PAIRWISE_REGISTER_MAX_WINDOW`` (64) a thread holds its window in
  registers and ranks it with one compare per pair of slots; past it, every element
  of a staged tile of windows is ranked in parallel against all others. Explicit
  ``mode="pairwise"`` only, as in the JAX package.
- ``radix`` (``csrc/median_weights_radix.cu``): the lower median by 5-bit digit
  rounds over a candidate list that shrinks (the first round reads all W keys, later
  ones only the survivors), the upper one from it in one pass; the long-window mode.
  Its plain version keeps the JAX kernel's 32 one-bit passes per order statistic:
  any exact selection gives the same bits.

``mode=None`` means :func:`auto_mode`: ``loop`` up to the window cap, ``radix`` past
it. On a CUDA tensor the wrapper launches the mode's kernel; on a CPU tensor it runs
the mode's plain version, which mirrors the JAX kernel step for step. There is no
other fallback: a CUDA tensor the kernel cannot take raises.

Medians of each mode equal the JAX kernel's of the same mode bit for bit. Across
modes they agree by value only: ``radix`` extracts the selected value itself and
keeps -0.0, while ``loop`` and ``pairwise`` add the picked value into +0.0.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_resiliency_torch.ops import _build

MODES = ("loop", "pairwise", "radix")
#: Kernel source (``csrc/<name>.cu``) of each mode.
KERNEL_NAMES = {
    "loop": "median_weights",
    "pairwise": "median_weights_pairwise",
    "radix": "median_weights_radix",
}
KERNEL_NAME = KERNEL_NAMES["loop"]

#: Threads per block the loop kernel is compiled for at most (``__launch_bounds__``).
MAX_THREADS = 128
#: Shared memory one block may use on Hopper (227 KB opt-in, dynamic only).
MAX_SHARED_BYTES = 232_448
#: Largest window the loop kernel takes: one warp's masked windows must fit in
#: shared memory.
MAX_WINDOW = MAX_SHARED_BYTES // (4 * 32)
#: Largest window the loop kernel sorts in one thread's registers; longer windows
#: take its O(W²) shared-memory path. Its source is compiled with this value
#: (``_build.DEFINES``, ``kNetworkMaxWindow`` in ``csrc/median_weights.cu``).
NETWORK_MAX_WINDOW = _build.DEFINES[KERNEL_NAME]["TR_NETWORK_MAX_WINDOW"]
#: Largest window the pairwise kernel ranks in one thread's registers; longer windows
#: take its tiled path. Its source is compiled with this value (``_build.DEFINES``,
#: ``kRegisterMaxWindow`` in ``csrc/median_weights_pairwise.cu``).
PAIRWISE_REGISTER_MAX_WINDOW = _build.DEFINES[KERNEL_NAMES["pairwise"]][
    "TR_PAIRWISE_REGISTER_MAX_WINDOW"
]
#: The pairwise and radix kernels stage 32 windows per block (``csrc/window_tile.cuh``)
#: in rows padded to 33 words, beside at most 384 B of static shared memory.
TILE_WINDOWS = 32
TILE_STATIC_BYTES = 3 * 4 * TILE_WINDOWS
TILE_MAX_WINDOW = (MAX_SHARED_BYTES - TILE_STATIC_BYTES) // (4 * (TILE_WINDOWS + 1))

#: The largest window each mode's kernel takes (its shared-memory limit). It is the
#: whole gate of the explicit ``pairwise`` mode, which never auto-selects.
MODE_MAX_WINDOW = {"loop": MAX_WINDOW, "pairwise": TILE_MAX_WINDOW, "radix": TILE_MAX_WINDOW}

#: Largest window ``loop`` is auto-selected for; past it ``radix`` runs. Set from the
#: H100 sweep (``ops/kernel_sweep.py`` as run by ``chip_smoke.py`` phase ``sweep``, on
#: an NVIDIA H100 80GB HBM3 at 700 W; its table is in PERF.md section 6 and in
#: ``tests/test_torch_kernel_sweep.py``): its ``loop_max_window``, by device time.
#: With the register network ``loop`` beats ``radix`` at every R up to W = 64 (at
#: R = 4096: 0.021 to 0.105 ms at W = 32, 0.048 to 0.157 ms at W = 64), and its
#: O(W²) path loses W = 128 (1.12 to 0.24 ms).
DEFAULT_MAX_WINDOW = 64
#: The port's own override of the cap; a TPU sweep's export never sets it.
MAX_WINDOW_ENV = "TPU_RESILIENCY_CUDA_MAX_WINDOW"
#: Auto-selection of ``radix`` past the cap (explicit ``mode="radix"`` always works).
#: On, from the same sweep: ``radix`` beat the sort path at every swept window past
#: the cap and every rank count (0.91 to 10.11 ms at 4096 x 64 x 512).
DEFAULT_RADIX_AUTO = True
RADIX_ENV = "TPU_RESILIENCY_CUDA_RADIX"


def max_auto_window() -> int:
    """The loop cap: ``$TPU_RESILIENCY_CUDA_MAX_WINDOW`` if it is an integer, else
    :data:`DEFAULT_MAX_WINDOW`."""
    try:
        return int(os.environ.get(MAX_WINDOW_ENV, DEFAULT_MAX_WINDOW))
    except ValueError:
        return DEFAULT_MAX_WINDOW


def radix_auto_enabled() -> bool:
    """Whether auto-selection may pick ``radix``: ``$TPU_RESILIENCY_CUDA_RADIX``
    (1/on/true/yes) if set, else :data:`DEFAULT_RADIX_AUTO`."""
    v = os.environ.get(RADIX_ENV)
    if v is None:
        return DEFAULT_RADIX_AUTO
    return v.strip().lower() in ("1", "on", "true", "yes")


def auto_mode(window: int) -> str:
    """``loop`` up to the measured window cap, ``radix`` beyond it."""
    return "loop" if window <= max_auto_window() else "radix"


def kernel_supported(window: int, signals: int, mode: str | None = None) -> bool:
    """Shape gate for selecting a kernel (counterpart of ``pallas_supported``).

    ``mode=None`` means :func:`auto_mode`; past the cap the window goes to ``radix``
    only while :func:`radix_auto_enabled`. An explicit ``loop`` is rejected past the
    cap, so no caller is handed a silent O(W²) reduction of a long window. Every mode
    is bounded by its kernel's shared-memory limit (:data:`MODE_MAX_WINDOW`).
    """
    if mode is None:
        mode = auto_mode(window)
        if mode == "radix" and not radix_auto_enabled():
            return False
    elif mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    cap = MODE_MAX_WINDOW[mode]
    if mode == "loop":
        cap = min(cap, max_auto_window())
    return signals >= 1 and 1 <= window <= cap


def network_size(window: int) -> int:
    """The loop kernel's register network at ``window`` (up to
    :data:`NETWORK_MAX_WINDOW`) sorts the smallest power of two of slots ≥ W; the
    pairwise kernel's register path (up to :data:`PAIRWISE_REGISTER_MAX_WINDOW`)
    holds as many."""
    return 1 << max(window - 1, 0).bit_length()


def block_threads(window: int) -> int:
    """Threads per block of the loop kernel at ``window``: the widest of 128/64/32
    whose staged windows (``threads * window`` f32 values) fit in shared memory (the
    register network, W ≤ 64, stages none and takes 128)."""
    threads = MAX_THREADS
    while threads > 32 and threads * window * 4 > MAX_SHARED_BYTES:
        threads //= 2
    return threads


# -- plain versions -------------------------------------------------------------


def _masked(data: torch.Tensor, counts: torch.Tensor):
    """``(valid, x)``: the slots below each count, and the window with the others
    set to +inf, as every TPU kernel masks them."""
    pos = torch.arange(data.shape[-1], dtype=torch.int32, device=data.device)
    valid = pos < counts[..., None]
    return valid, torch.where(valid, data, float("inf"))


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as the JAX kernels take it: XLA folds a sum over an
    axis of length 1 into the element itself (a -0.0 stays -0.0), and starts a
    longer sum from +0.0, as ``torch.sum`` always does."""
    return x[..., 0] if x.shape[-1] == 1 else x.sum(dim=-1)


def _median_and_weight(data, counts, valid, rank):
    """The shared tail (``_write_median_and_weight``): the median is the mean of the
    values ranked ``(n-1)//2`` and ``n//2``, ``n = max(count, 1)``, each picked by a
    masked sum; +inf where the count is 0. The weight is the masked sum."""
    n = counts.clamp(min=1)
    lo_idx = ((n - 1) // 2)[..., None]
    hi_idx = (n // 2)[..., None]
    x_finite = torch.where(valid, data, 0.0)
    lo = _lane_sum(torch.where(rank == lo_idx, x_finite, 0.0))
    hi = _lane_sum(torch.where(rank == hi_idx, x_finite, 0.0))
    med = 0.5 * (lo + hi)
    return torch.where(counts > 0, med, float("inf")), _lane_sum(x_finite)


def median_weights_reference(data: torch.Tensor, counts: torch.Tensor):
    """Plain PyTorch version of the ``loop`` kernel: ``(medians [R,S], weights [R,S])``.

    Invalid slots (position >= count) are masked to +inf, each element's stable rank
    ``#{x_j < x_i} + #{j < i : x_j == x_i}`` is accumulated over W passes, and the
    shared tail picks the median and sums the weight.
    """
    w = data.shape[-1]
    pos = torch.arange(w, dtype=torch.int32, device=data.device)
    valid, x = _masked(data, counts)
    rank = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
    for j in range(w):
        xj = x[..., j : j + 1]
        rank += (xj < x).to(torch.int32)
        rank += ((xj == x) & (j < pos)).to(torch.int32)
    return _median_and_weight(data, counts, valid, rank)


#: Elements of one ``[windows, W, W]`` comparison block in the plain pairwise version.
_PAIRWISE_BLOCK_ELEMS = 1 << 26


def median_weights_pairwise_reference(data: torch.Tensor, counts: torch.Tensor):
    """Plain PyTorch version of the ``pairwise`` kernel.

    The same stable ranks as :func:`median_weights_reference`, from all-pairs
    comparisons ``[.., W, W]`` (taken in blocks of windows to bound memory), then
    the shared tail.
    """
    w = data.shape[-1]
    valid, x = _masked(data, counts)
    pos = torch.arange(w, device=data.device)
    before = pos[None, :] < pos[:, None]  # [i, j]: j < i
    flat = x.reshape(-1, w)
    rank = torch.empty(flat.shape, dtype=torch.int32, device=data.device)
    step = max(1, _PAIRWISE_BLOCK_ELEMS // (w * w))
    for a in range(0, flat.shape[0], step):
        xi = flat[a : a + step, :, None]
        xj = flat[a : a + step, None, :]
        rank[a : a + step] = ((xj < xi) | ((xj == xi) & before)).sum(-1, dtype=torch.int32)
    return _median_and_weight(data, counts, valid, rank.reshape(x.shape))


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The unsigned order key of each float, held in int64: ``b < 0 ? ~b : b | 2^31``
    on the float's bits. Keys order as the floats do, with -0.0 below +0.0 (the JAX
    kernel's signed key XOR ``INT_MIN``)."""
    b = x.view(torch.int32).to(torch.int64)
    return torch.where(b < 0, ~b, b | 0x80000000)


def _radix_select(x, key, cand, k):
    """The ``k``-th smallest candidate per window (``_radix_select``): 32 passes, MSB
    first; each counts the candidates with a 0 at the bit, keeps the 0 branch if ``k``
    is below that count and else the 1 branch, and narrows the candidates to it. The
    survivors share one key; extraction is their masked min (+inf for none)."""
    for bit in range(31, -1, -1):
        zero = ((key >> bit) & 1) == 0
        c0 = (cand & zero).sum(dim=-1)
        go_zero = k < c0
        cand = cand & (zero == go_zero[..., None])
        k = torch.where(go_zero, k, k - c0)
    return torch.where(cand, x, float("inf")).amin(dim=-1)


def median_weights_radix_reference(data: torch.Tensor, counts: torch.Tensor):
    """Plain PyTorch version of the ``radix`` kernel, pass for pass as
    ``_median_weights_radix_kernel``: the candidates are the valid slots, both order
    statistics ``(n-1)//2`` and ``n//2`` are radix-selected, and the median is their
    mean (+inf where the count is 0). The weight is the masked sum."""
    valid, x = _masked(data, counts)
    key = _order_key(x)
    n = counts.clamp(min=1).to(torch.int64)
    lo = _radix_select(x, key, valid, (n - 1) // 2)
    hi = _radix_select(x, key, valid, n // 2)
    med = 0.5 * (lo + hi)
    weights = _lane_sum(torch.where(valid, data, 0.0))
    return torch.where(counts > 0, med, float("inf")), weights


PLAIN_VERSIONS = {
    "loop": median_weights_reference,
    "pairwise": median_weights_pairwise_reference,
    "radix": median_weights_radix_reference,
}


# -- kernels ----------------------------------------------------------------------

_COMMON_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_longlong] * 5
)


def _kernel_fn(mode: str):
    lib = _build.load(KERNEL_NAMES[mode]).lib
    fn = getattr(lib, f"tr_median_weights_{mode}")
    if fn.argtypes is None:
        threads = [ctypes.c_int] if mode == "loop" else []
        fn.argtypes = _COMMON_ARGTYPES + threads + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tr_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(mode: str, data: torch.Tensor, counts: torch.Tensor):
    r, s, w = data.shape
    if not 1 <= w <= MODE_MAX_WINDOW[mode] or s < 1:
        raise ValueError(
            f"the {mode} kernel takes 1 <= W <= {MODE_MAX_WINDOW[mode]} (its "
            f"shared-memory limit) and S >= 1, got W={w}, S={s}"
        )
    medians = torch.empty((r, s), dtype=torch.float32, device=data.device)
    weights = torch.empty((r, s), dtype=torch.float32, device=data.device)
    if r == 0:
        return medians, weights
    lib, fn = _kernel_fn(mode)
    extra = (block_threads(w),) if mode == "loop" else ()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        code = fn(
            data.data_ptr(), counts.data_ptr(), medians.data_ptr(), weights.data_ptr(),
            r * s, s, w, *data.stride(), *counts.stride(), *extra, stream,
        )
    if code != 0:
        msg = lib.tr_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"median_weights {mode} kernel launch failed: {msg} (cudaError {code})")
    fused_median_weights.launches += 1
    fused_median_weights.launches_by_mode[mode] += 1
    return medians, weights


def fused_median_weights(data: torch.Tensor, counts: torch.Tensor, *, mode: str | None = None):
    """``(medians [R,S], weights [R,S])`` from windows ``data [R,S,W]`` (f32, any
    strides) and ``counts [R,S]`` (i32).

    ``mode`` is ``"loop"``, ``"pairwise"``, ``"radix"`` or ``None`` for
    :func:`auto_mode` of the window. On a CUDA tensor this launches the mode's Hopper
    kernel on the current stream and adds one to ``fused_median_weights.launches``
    and to ``fused_median_weights.launches_by_mode[mode]``; on a CPU tensor it runs
    the mode's plain version (:data:`PLAIN_VERSIONS`).
    """
    if mode is not None and mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if data.dim() != 3 or counts.shape != data.shape[:2]:
        raise ValueError(
            f"expected data [R,S,W] and counts [R,S], got {tuple(data.shape)} and "
            f"{tuple(counts.shape)}"
        )
    if data.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError(f"expected f32 data and i32 counts, got {data.dtype} and {counts.dtype}")
    if data.device != counts.device:
        raise ValueError(f"data on {data.device} but counts on {counts.device}")
    if mode is None:
        mode = auto_mode(data.shape[-1])
    if data.device.type == "cpu":
        return PLAIN_VERSIONS[mode](data, counts)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    return _launch(mode, data, counts)


def reset_launches() -> None:
    """Set the total and every per-mode launch count to 0."""
    fused_median_weights.launches = 0
    fused_median_weights.launches_by_mode = dict.fromkeys(MODES, 0)


#: Kernel launches made through :func:`fused_median_weights` (CUDA tensors only), in
#: total (``launches``) and per mode (``launches_by_mode``).
reset_launches()
