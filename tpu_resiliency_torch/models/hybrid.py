"""Hybrid model family: LFM2-style layers of gated short convolutions and GQA attention,
each followed by a dense or a routed SwiGLU, in PyTorch.

The layer stack is LiquidAI's ``lfm2_moe`` (the LFM2-MoE models as Hugging Face
transformers publishes them); the JAX package has no counterpart. Layer ``i`` runs the
operator ``layer_types[i]`` and then its FFN, each pre-normed with a residual:
``h = x + op(RMSNorm(x))``, ``out = h + ffn(RMSNorm(h))``.

- **Gated short conv** (``"conv"``): ``B, C, x̃ = split₃(h · W_in)`` (``W_in``
  ``[d, 3d]``), ``y = C ⊙ conv(B ⊙ x̃)`` where ``conv`` is a causal depthwise
  convolution along time with ``conv_kernel`` taps per channel (zero padding of
  ``conv_kernel - 1`` on the left), then ``y · W_out``. No biases.
- **Attention** (``"full_attention"``): the dense family's ``_attn_block``, with an
  RMSNorm over each head's channels on q and k before RoPE where ``qk_norm``.
- **FFN**: the dense family's SwiGLU in the first ``num_dense_layers`` layers, routed
  experts after them: ``moe.dropless_experts`` with LFM2's router
  (``moe.sigmoid_choices``: experts chosen by ``sigmoid(h · W_r) + b``, weighted by the
  sigmoid scores, renormalised, times ``routed_scale``). ``b`` is the expert bias, a
  buffer that no optimizer sees: the trainer owns its update rule. No aux loss: the
  family balances by the bias.
- A final RMSNorm and the head, tied to the embedding where ``tie_embeddings``.

Compute follows the dense family: float32 master weights cast to ``cfg.dtype`` at each
product, the norms' float32 chains as ``transformer.rms_norm`` has them.

Parameters: ``embed``, ``final_norm`` (and ``lm_head`` untied) and ``layers.<key>``,
each stacked on a leading axis over the layers that have it: ``op_norm``/``ffn_norm``
over every layer; ``conv_in``/``conv_kernel``/``conv_out`` over the conv layers;
``wq``/``wk``/``wv``/``wo`` (and ``q_norm``/``k_norm``) over the attention layers;
``w_gate``/``w_up``/``w_down`` over the dense FFNs; ``w_router`` ``[*, D, E]`` and
``we_gate``/``we_up`` ``[*, E, D, F]``, ``we_down`` ``[*, E, F, D]`` over the routed
FFNs (``parallel/mesh.py``'s ``moe_param_specs`` names). The buffer ``expert_bias`` is
``[*, E]`` over the routed FFNs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpu_resiliency_torch.models import moe
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.platform.device import resolve_device

CONV, ATTENTION = "conv", "full_attention"
OP_LEAVES = {CONV: ("conv_in", "conv_kernel", "conv_out"),
             ATTENTION: ("wq", "wk", "wv", "wo", "q_norm", "k_norm")}
DENSE_LEAVES = ("w_gate", "w_up", "w_down")
MOE_LEAVES = ("w_router", "we_gate", "we_up", "we_down")


@dataclasses.dataclass(frozen=True)
class HybridConfig(moe.MoEConfig):
    """``d_ff`` is the dense FFNs' width, ``moe_d_ff`` the experts'; ``n_layers`` must
    equal ``len(layer_types)``."""

    layer_types: tuple = (CONV, CONV, ATTENTION, CONV, CONV, CONV)
    num_dense_layers: int = 2
    moe_d_ff: int = 128
    conv_kernel: int = 3
    qk_norm: bool = True
    tie_embeddings: bool = True
    score_func: str = "sigmoid"
    norm_topk_prob: bool = True
    routed_scale: float = 1.0
    expert_bias: bool = True
    capacity_factor: Optional[float] = None
    router_aux_weight: float = 0.0

    def __post_init__(self):
        if len(self.layer_types) != self.n_layers:
            raise ValueError(f"{self.n_layers} layers but {len(self.layer_types)} layer types")
        if set(self.layer_types) - set(OP_LEAVES):
            raise ValueError(f"layer types are {sorted(OP_LEAVES)}: {self.layer_types}")
        if self.score_func != "sigmoid" or self.capacity_factor is not None \
                or self.router_aux_weight:
            raise ValueError("the hybrid routes dropless by sigmoid scores, with no aux loss")

    @staticmethod
    def tiny(**kw) -> "HybridConfig":
        base = dict(vocab_size=256, d_model=64, n_layers=6, n_heads=4, n_kv_heads=2,
                    d_ff=128, moe_d_ff=32, max_seq_len=128, n_experts=8, top_k=2)
        base.update(kw)
        return HybridConfig(**base)

    def plan(self) -> list[tuple[str, int, bool, int]]:
        """Per layer: ``(operator, its index in that operator's stacks, routed FFN?,
        the FFN's index in its stacks)``."""
        seen = {CONV: 0, ATTENTION: 0}
        out = []
        for i, op in enumerate(self.layer_types):
            routed = i >= self.num_dense_layers
            out.append((op, seen[op], routed,
                        i - self.num_dense_layers if routed else i))
            seen[op] += 1
        return out


def param_shapes(cfg: HybridConfig) -> dict:
    """The leaves' shapes as the nested tree holds them (``expert_bias`` included)."""
    d, f, fe, e, dh = cfg.d_model, cfg.d_ff, cfg.moe_d_ff, cfg.n_experts, cfg.head_dim
    n_conv, n_attn = cfg.layer_types.count(CONV), cfg.layer_types.count(ATTENTION)
    n_dense = min(cfg.num_dense_layers, cfg.n_layers)
    n_moe = cfg.n_layers - n_dense
    layers = {"op_norm": (cfg.n_layers, d), "ffn_norm": (cfg.n_layers, d),
              "conv_in": (n_conv, d, 3 * d), "conv_kernel": (n_conv, d, cfg.conv_kernel),
              "conv_out": (n_conv, d, d),
              "wq": (n_attn, d, cfg.n_heads * dh), "wk": (n_attn, d, cfg.n_kv_heads * dh),
              "wv": (n_attn, d, cfg.n_kv_heads * dh), "wo": (n_attn, cfg.n_heads * dh, d)}
    if cfg.qk_norm:
        layers.update(q_norm=(n_attn, dh), k_norm=(n_attn, dh))
    layers.update(w_gate=(n_dense, d, f), w_up=(n_dense, d, f), w_down=(n_dense, f, d),
                  w_router=(n_moe, d, e), we_gate=(n_moe, e, d, fe),
                  we_up=(n_moe, e, d, fe), we_down=(n_moe, e, fe, d))
    tree = {"embed": (cfg.vocab_size, d), "layers": layers, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, cfg.vocab_size)
    if cfg.expert_bias:
        tree["expert_bias"] = (n_moe, e)
    return tree


def init_params(seed: int, cfg: HybridConfig, *, device=None) -> dict:
    """The nested tree, float32, on ``device`` (the card by default): every matrix
    standard normal over ``sqrt(fan_in)`` as the dense family draws it (a conv kernel's
    fan-in is its taps), norms 1, the expert bias 0."""
    dev = resolve_device(device)
    gen = tfm._generator(seed, dev)

    def leaf(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        if name == "expert_bias":
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        return tfm.dense_init(gen, shape, shape[-2] if name != "conv_kernel" else shape[-1],
                              dev)

    tree = {}
    for name, shape in param_shapes(cfg).items():
        tree[name] = ({k: leaf(k, s) for k, s in shape.items()} if isinstance(shape, dict)
                      else leaf(name, shape))
    return tree


class Hybrid(tfm.Transformer):
    """The hybrid's parameters as an ``nn.Module`` (``layers.conv_in``, ...), the expert
    bias a buffer; its forward returns the logits."""

    init_fn: Callable = staticmethod(init_params)

    def __init__(self, cfg: HybridConfig, params: Optional[dict] = None, *, seed: int = 0,
                 device=None):
        if params is None:
            params = init_params(seed, cfg, device=device)
        params = dict(tfm.nest(params))
        bias = params.pop("expert_bias", None)
        super().__init__(cfg, params)
        self.register_buffer("expert_bias", bias)

    def tree(self) -> dict:
        tree = super().tree()
        if self.expert_bias is not None:
            tree["expert_bias"] = self.expert_bias
        return tree

    def forward(self, tokens: torch.Tensor, **kw):
        return forward(self, tokens, self.cfg, **kw)


def _conv_block(cfg: HybridConfig, x: torch.Tensor, lp: dict) -> torch.Tensor:
    """Pre-norm gated short conv with residual."""
    t, d = x.shape[1], x.shape[2]
    y = tfm.rms_norm(x, lp["op_norm"])
    gate_b, gate_c, z = (y @ lp["conv_in"].to(y.dtype)).chunk(3, dim=-1)
    kernel = lp["conv_kernel"].to(y.dtype)[:, None, :]  # [d, 1, taps]
    conv = F.conv1d((gate_b * z).transpose(1, 2), kernel, padding=cfg.conv_kernel - 1,
                    groups=d)[..., :t]
    return x + (gate_c * conv.transpose(1, 2)) @ lp["conv_out"].to(y.dtype)


def _routed_block(cfg: HybridConfig, x: torch.Tensor, lp: dict, bias) -> torch.Tensor:
    y = tfm.rms_norm(x, lp["mlp_norm"])
    choose = functools.partial(_choose, cfg, bias)
    out, _ = moe.dropless_experts(y, lp, choose)
    return x + out


def _choose(cfg: HybridConfig, bias, logits):
    idx, weights = moe.sigmoid_choices(logits, bias, cfg.top_k, cfg.norm_topk_prob,
                                       cfg.routed_scale)
    return idx, weights, None


def forward(params, tokens: torch.Tensor, cfg: HybridConfig, *, position_offset: int = 0):
    """tokens [B, T] → logits [B, T, V] (float32). ``params`` is a :class:`Hybrid`, its
    tree or its flat names."""
    tree = tfm.as_tree(params)
    # Each stack split once into its layers: the gradient is one stack of the layers'
    # gradients, where indexing a layer at a time would add a zero-filled copy of the
    # whole stack per layer (the expert stacks are 3.2 GB each).
    layers = {key: leaf.unbind(0) for key, leaf in tree["layers"].items()}
    biases = tree["expert_bias"].unbind(0) if "expert_bias" in tree else None
    attn_fn = tfm.adapt_attn_fn(None, position_offset)
    x = tfm.embed_tokens(tree, tokens, cfg)
    cos, sin = tfm.rope_tables(cfg, tokens.shape[1], position_offset, device=tokens.device)
    for i, (op, j, routed, k) in enumerate(cfg.plan()):
        lp = {key: layers[key][j] for key in OP_LEAVES[op] if key in layers}
        if op == CONV:
            x = _conv_block(cfg, x, dict(lp, op_norm=layers["op_norm"][i]))
        else:
            x = tfm._attn_block(cfg, x, dict(lp, attn_norm=layers["op_norm"][i]), cos, sin,
                                attn_fn)
        ffn = {key: layers[key][k] for key in (MOE_LEAVES if routed else DENSE_LEAVES)}
        ffn["mlp_norm"] = layers["ffn_norm"][i]
        if routed:
            x = _routed_block(cfg, x, ffn, biases[k] if biases else None)
        else:
            x = tfm._mlp_block(x, ffn)
    return tfm.head(tree, x)


def loss_fn(params, tokens: torch.Tensor, cfg: HybridConfig, **kw) -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, T], as the dense family's."""
    logits = forward(params, tokens, cfg, **kw)[:, :-1]
    return tfm.token_nll(logits, tokens[:, 1:]).mean()


def make_train_step(cfg: HybridConfig, optimizer: Optional[Callable] = None):
    """(train_step, init_opt_state), the same contract as the dense model's."""
    return tfm.make_train_step_from_loss(
        lambda model, tokens: loss_fn(model, tokens, cfg), optimizer)
