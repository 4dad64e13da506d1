"""The frozen counts of a hybrid mixture-of-experts train step (``lfm2_moe``: gated short
convs and GQA attention, dense then routed SwiGLU FFNs, the head tied to the
embedding), from a configuration file's keys alone. Nothing here reads the program."""

from __future__ import annotations

from benchmark import roofline


def layers(cfg: dict) -> dict[str, int]:
    """The configuration's layers by kind: operators and FFNs."""
    types = cfg["layer_types"][: cfg["num_hidden_layers"]]
    dense = min(cfg["num_dense_layers"], cfg["num_hidden_layers"])
    return {"conv": types.count("conv"), "attention": types.count("full_attention"),
            "dense": dense, "routed": cfg["num_hidden_layers"] - dense}


def parameters(cfg: dict) -> dict[str, int]:
    """Parameter counts by part; ``active_matmul`` is a token's share of the products
    with a weight (the router's, ``num_experts_per_tok`` experts of each routed layer,
    the tied head's), the embedding's lookup left out."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // heads
    e, k, fe, f = cfg["num_experts"], cfg["num_experts_per_tok"], \
        cfg["moe_intermediate_size"], cfg["intermediate_size"]
    n = layers(cfg)
    conv_mm = 3 * d * d + d * d
    attn_mm = 2 * d * heads * dh + 2 * d * kv * dh
    expert = 3 * d * fe
    norms = 2 * d * cfg["num_hidden_layers"] + d
    out = {
        "embedding": v * d,
        "conv": n["conv"] * (conv_mm + d * cfg["conv_L_cache"]),
        "attention": n["attention"] * (attn_mm + 2 * dh),
        "dense": n["dense"] * 3 * d * f,
        "routed": n["routed"] * (d * e + e * expert),
        "norms": norms,
    }
    out["total"] = sum(out.values())
    out["active_matmul"] = (n["conv"] * conv_mm + n["attention"] * attn_mm
                            + n["dense"] * 3 * d * f + n["routed"] * (d * e + k * expert)
                            + d * v)
    return out


def train_flop_per_token(cfg: dict) -> float:
    """Operations per trained token: 6 per active matmul parameter (forward and backward
    of each product a token takes part in, the tied head's included) and the causal
    attention's two products, 6 x attention layers x seq x hidden size (the causal half
    of the scores, as ``roofline.train_flop_per_token`` counts them)."""
    seq = cfg["assumed"]["seq_len"]
    return 6.0 * parameters(cfg)["active_matmul"] + \
        6.0 * layers(cfg)["attention"] * seq * cfg["hidden_size"]


def routed_flop(cfg: dict, tokens: int) -> float:
    """The routed experts' products over ``tokens`` tokens, forward and backward, every
    routed layer: 6 x tokens x experts per token x 3 x hidden x expert width, from the
    shapes alone (no padding, whatever the implementation)."""
    return 6.0 * tokens * cfg["num_experts_per_tok"] * 3 * cfg["hidden_size"] \
        * cfg["moe_intermediate_size"] * layers(cfg)["routed"]


def share_of_peak(flop: float, seconds: float) -> float | None:
    """``flop`` at the card's bf16 peak over ``seconds``, in percent."""
    return roofline.share_percent(flop / roofline.BF16_FLOP_PER_S, seconds)
