"""The benchmark's frozen arithmetic: the card's peaks, and the bytes and operations
that each measured piece of work needs, computed from its shapes.

Nothing here reads the program. A roofline share is the least time the card could
take, from these counts at the published peaks, over the measured time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

F32 = 4
I32 = 4


def window_reduction_bytes(ranks: int, signals: int, window: int) -> int:
    """Bytes one window reduction needs: the ``[R, S, W]`` f32 windows and the
    ``[R, S]`` i32 counts read once, the ``[R, S]`` f32 medians and weights written
    once."""
    cells = ranks * signals
    return cells * window * F32 + cells * I32 + 2 * cells * F32


def window_reduction_bound_s(ranks: int, signals: int, window: int) -> float:
    """The least time of one window reduction: it is bound by bytes (its compares
    and integer work at 64 per clock per SM stay under the byte time)."""
    return window_reduction_bytes(ranks, signals, window) / HBM_BYTES_PER_S


def decoder_parameters(vocab: int, d_model: int, n_layers: int, n_heads: int,
                       n_kv_heads: int, d_ff: int) -> dict[str, int]:
    """Parameter counts of a GQA SwiGLU decoder with RMSNorm and an untied head."""
    head_dim = d_model // n_heads
    attn = d_model * n_heads * head_dim * 2 + d_model * n_kv_heads * head_dim * 2
    mlp = 3 * d_model * d_ff
    per_layer = attn + mlp + 2 * d_model
    embedding = vocab * d_model
    head = d_model * vocab
    non_embedding = n_layers * per_layer + head + d_model
    return {
        "per_layer": per_layer,
        "embedding": embedding,
        "head": head,
        "non_embedding": non_embedding,
        "total": non_embedding + embedding,
    }


def train_flop_per_token(vocab: int, d_model: int, n_layers: int, n_heads: int,
                         n_kv_heads: int, d_ff: int, seq: int) -> float:
    """Operations per trained token: 6 per non-embedding parameter (forward and
    backward of every matmul, the head's included; the embedding is a lookup) and
    causal attention's two products, 6 x layers x seq x d_model. This is what the
    inputs need: the causal half of the score matrix, not the full one the port
    computes."""
    p = decoder_parameters(vocab, d_model, n_layers, n_heads, n_kv_heads, d_ff)
    return 6.0 * p["non_embedding"] + 6.0 * n_layers * seq * d_model


def share_percent(least_s: float, measured_s: float) -> float | None:
    """``least_s / measured_s`` in percent; ``None`` when nothing was measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
