"""Causal scale–mask–softmax over attention scores on the card: a hand-written CUDA
kernel pair, forward and backward (``csrc/causal_softmax.cu``).

The dense attention of ``models/transformer.py`` lays its bf16 scores out as
``[B, Hkv, G * Tq, Tk]`` (query group and position folded into the rows, row ``r``
at query position ``r % Tq``) and hands them to :func:`causal_softmax`, which returns
the probabilities in the scores' type: each row's ``f32(s) * inv_scale``, ``-1e30``
above the causal diagonal (columns past ``q + causal_offset``), a softmax in f32,
rounded. The forward reads each row's unmasked prefix once and writes the row once;
the backward recomputes the f32 probabilities from the saved scores and each row's
max and sum (a :class:`torch.autograd.Function`). It takes CUDA tensors only: the
plain chain it replaces, ``transformer._causal_softmax_plain``, is what the CPU runs
and what the tests hold the kernels against.

``inv_scale`` is the f32 reciprocal of ``sqrt(dh)`` (:func:`inverse_scale`): the
card divides a tensor by a Python scalar as a product with that reciprocal, so the
kernel's scaled scores are the plain chain's bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tpu_resiliency_torch.ops import _build

KERNEL_NAME = "causal_softmax"
#: Score types the kernel takes, by the code its C interface expects.
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


def inverse_scale(head_dim: int) -> float:
    """``1 / sqrt(head_dim)`` as the card computes ``x / math.sqrt(head_dim)`` on an f32
    tensor: the reciprocal of the f32 divisor, in f32."""
    return float(np.float32(1.0) / np.float32(math.sqrt(head_dim)))


def traffic_bytes(rows: int, tq: int, tk: int, causal_offset: int, itemsize: int) -> dict:
    """The device memory each kernel reads and writes, in bytes, for scores ``[rows,
    tk]`` of ``itemsize`` bytes an element: the forward reads the unmasked prefixes of
    the scores and writes the probabilities and each row's f32 max and sum; the
    backward reads the unmasked prefixes of the probabilities' gradient and of the
    scores and each row's max and sum, and writes the scores' gradient."""
    q = np.arange(tq, dtype=np.int64)
    prefix = int(np.clip(q + causal_offset + 1, 0, tk).sum()) * (rows // tq)
    whole, stats = rows * tk * itemsize, rows * 8
    return {"forward": prefix * itemsize + whole + stats,
            "backward": 2 * prefix * itemsize + stats + whole}


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _vector_width(tk: int, *tensors: torch.Tensor) -> int:
    """8 elements a load where every row starts 16-byte aligned, else 1."""
    aligned = tk % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return 8 if aligned else 1


def _kernel_lib():
    lib = _build.load(KERNEL_NAME).lib
    if lib.tr_causal_softmax_forward.argtypes is None:
        shape = [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
        lib.tr_causal_softmax_forward.argtypes = [ctypes.c_void_p] * 4 + shape
        lib.tr_causal_softmax_forward.restype = ctypes.c_int
        lib.tr_causal_softmax_backward.argtypes = [ctypes.c_void_p] * 5 + shape
        lib.tr_causal_softmax_backward.restype = ctypes.c_int
        lib.tr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(which: str, pointers, rows, tq, tk, causal_offset, inv_scale, dtype, vec,
            device) -> None:
    lib = _kernel_lib()
    fn = getattr(lib, f"tr_causal_softmax_{which}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*pointers, rows, tq, tk, causal_offset, inv_scale, DTYPE_CODES[dtype], vec,
                  stream)
    if code != 0:
        msg = lib.tr_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"causal_softmax {which} kernel launch failed: {msg} "
                           f"(cudaError {code})")
    causal_softmax.launches += 1
    causal_softmax.launches_by_pass[which] += 1


def _rows(scores: torch.Tensor) -> tuple[int, int]:
    return scores.numel() // scores.shape[-1], scores.shape[-1]


def forward(scores: torch.Tensor, tq: int, causal_offset: int, inv_scale: float):
    """One launch of the forward kernel on contiguous bf16 or fp16 CUDA scores: the
    probabilities in the scores' type and each row's f32 max and sum."""
    rows, tk = _rows(scores)
    probs = torch.empty_like(scores)
    row_max = torch.empty(scores.shape[:-1], dtype=torch.float32, device=scores.device)
    row_sum = torch.empty_like(row_max)
    if rows:
        _launch("forward", (scores.data_ptr(), probs.data_ptr(), row_max.data_ptr(),
                            row_sum.data_ptr()),
                rows, tq, tk, causal_offset, inv_scale, scores.dtype,
                _vector_width(tk, scores, probs), scores.device)
    return probs, row_max, row_sum


def backward(grad_probs: torch.Tensor, scores: torch.Tensor, row_max: torch.Tensor,
             row_sum: torch.Tensor, tq: int, causal_offset: int,
             inv_scale: float) -> torch.Tensor:
    """One launch of the backward kernel: the scores' gradient from the probabilities'
    gradient (contiguous, of the scores' type and shape) and :func:`forward`'s row
    max and sum."""
    _check(grad_probs, "the probabilities' gradient", scores.dtype, scores.shape)
    rows, tk = _rows(scores)
    grad_scores = torch.empty_like(scores)
    if rows:
        _launch("backward", (grad_probs.data_ptr(), scores.data_ptr(), row_max.data_ptr(),
                             row_sum.data_ptr(), grad_scores.data_ptr()),
                rows, tq, tk, causal_offset, inv_scale, scores.dtype,
                _vector_width(tk, grad_probs, scores, grad_scores), scores.device)
    return grad_scores


class CausalSoftmax(torch.autograd.Function):
    """The kernel pair as an autograd function of the scores. The forward saves the
    scores and each row's f32 max and sum; the backward recomputes the probabilities
    from them and returns the scores' gradient."""

    @staticmethod
    def forward(ctx, scores, tq, causal_offset, inv_scale):
        probs, row_max, row_sum = forward(scores, tq, causal_offset, inv_scale)
        ctx.save_for_backward(scores, row_max, row_sum)
        ctx.geometry = (tq, causal_offset, inv_scale)
        return probs

    @staticmethod
    def backward(ctx, grad_probs):
        scores, row_max, row_sum = ctx.saved_tensors
        return (backward(grad_probs.contiguous(), scores, row_max, row_sum, *ctx.geometry),
                None, None, None)


def causal_softmax(scores: torch.Tensor, tq: int, causal_offset: int,
                   inv_scale: float) -> torch.Tensor:
    """The causal softmax of ``scores`` ``[..., rows, tk]``, rows ``rows`` a multiple of
    ``tq`` (row ``r`` at query position ``r % tq``), in the scores' type.

    Launches the kernel pair on the current stream; the scores must be a contiguous
    bf16 or fp16 CUDA tensor (anything else raises). Each launch adds one to
    ``causal_softmax.launches`` and to ``causal_softmax.launches_by_pass["forward"]``
    (``"backward"`` for the gradient's launch)."""
    if scores.dim() < 2 or tq < 1 or scores.shape[-2] % tq:
        raise ValueError(f"expected scores [..., rows, tk] with rows a multiple of tq={tq}, "
                         f"got {tuple(scores.shape)}")
    if scores.dtype not in DTYPE_CODES:
        raise TypeError(f"the causal_softmax kernel takes bf16 or fp16 scores, got "
                        f"{scores.dtype}")
    _check(scores, "scores", scores.dtype, scores.shape)
    return CausalSoftmax.apply(scores, int(tq), int(causal_offset), float(inv_scale))


def reset_launches() -> None:
    """Set the total and the per-pass launch counts to 0."""
    causal_softmax.launches = 0
    causal_softmax.launches_by_pass = {"forward": 0, "backward": 0}


#: Kernel launches made by :func:`forward` and :func:`backward` (so by
#: :func:`causal_softmax` and its gradient), kept on :func:`causal_softmax`: in total
#: (``launches``) and per pass (``launches_by_pass``).
reset_launches()
