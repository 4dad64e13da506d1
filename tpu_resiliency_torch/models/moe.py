"""Mixture-of-experts model family: top-k routed experts, expert-parallel over ``ep``.

Port of ``tpu_resiliency/models/moe.py``, the second model family exercising the
resiliency framework. The math is the reference's:

- **Dense dispatch.** Top-k gates → capacity-bounded one-hot dispatch/combine
  tensors (first come, first served, token-major over ``(T, K)``) → batched einsums
  over the expert dimension, with the Switch load-balance aux loss.
- **Expert parallelism is a placement.** Expert weights carry a leading ``[E]`` axis
  that ``parallel/mesh.py``'s ``moe_param_specs`` shards over ``ep``; the einsums
  over the expert dimension then run on DTensors, and DTensor inserts the
  collectives. The model code names none.
- **Stacked layers** like the dense model, looped in Python, with the router aux
  loss summed across layers.

Every layer is an MoE layer (Mixtral-style); attention is the dense model's
(``transformer._attn_block``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.platform.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig(tfm.TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.5
    router_aux_weight: float = 1e-2

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        base = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, n_experts=4, top_k=2,
        )
        base.update(kw)
        return MoEConfig(**base)

    def capacity(self, seq_len: int) -> int:
        """Per-expert token capacity for one batch row (static)."""
        cap = int(math.ceil(self.top_k * seq_len * self.capacity_factor / self.n_experts))
        return max(cap, 1)


def init_params(seed: int, cfg: MoEConfig, *, device=None) -> dict:
    """The dense model's tree with the per-layer MLP replaced by a router and
    [E]-stacked experts, float32, seeded on ``device`` (the card by default). The
    dense MLP weights are never materialized."""
    dev = resolve_device(device)
    base = tfm.init_params(seed, cfg, with_mlp=False, device=dev)
    d, f, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
    gen = tfm._generator(seed + 7, dev)
    layers = dict(base["layers"])
    layers["w_router"] = tfm.dense_init(gen, (L, d, E), d, dev)
    layers["we_gate"] = tfm.dense_init(gen, (L, E, d, f), d, dev)
    layers["we_up"] = tfm.dense_init(gen, (L, E, d, f), d, dev)
    layers["we_down"] = tfm.dense_init(gen, (L, E, f, d), f, dev)
    base["layers"] = layers
    return base


class MoE(tfm.Transformer):
    """The MoE model's parameters as an ``nn.Module`` (``layers.w_router``,
    ``layers.we_gate``, ...); its forward returns ``(logits, aux)``."""

    init_fn: Callable = staticmethod(init_params)

    def forward(self, tokens: torch.Tensor, **kw):
        return forward(self, tokens, self.cfg, **kw)


def _route(cfg: MoEConfig, y: torch.Tensor, w_router: torch.Tensor):
    """Top-k routing with per-batch-row capacity.

    y: [B, T, D] → dispatch [B, T, E, C] (0/1), combine [B, T, E, C] (gates),
    aux (scalar load-balance loss, Switch-style fraction·probability product).
    """
    B, T, _ = y.shape
    E, K, C = cfg.n_experts, cfg.top_k, cfg.capacity(T)

    logits = y.float() @ w_router.float()  # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    _, idx = torch.topk(probs.detach(), K, dim=-1)  # [B, T, K]
    mask = F.one_hot(idx, E).float()  # [B, T, K, E]
    # The top-k probabilities picked by the one-hot mask: the same values and gradient
    # as topk's, whose backward scatter has no DTensor rule for batch-sharded inputs
    # under torch 2.11 (it would gather the batch).
    gates = (mask * probs[..., None, :]).sum(-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # First-come-first-served capacity: flatten (T, K) token-major so earlier
    # tokens (and higher-ranked choices) win slots, as in the GShard formulation.
    flat = mask.reshape(B, T * K, E)
    pos = torch.cumsum(flat, dim=1) - flat  # slot index if admitted
    flat = flat * (pos < C)
    pos_in_expert = (pos * flat).sum(-1).long()  # [B, T*K]
    admitted_gates = gates.reshape(B, T * K) * flat.sum(-1)

    dispatch = flat[..., None] * F.one_hot(pos_in_expert, C).float()[:, :, None, :]
    combine = admitted_gates[..., None, None] * dispatch  # [B, T*K, E, C]
    dispatch = dispatch.reshape(B, T, K, E, C).sum(2)
    combine = combine.reshape(B, T, K, E, C).sum(2)

    # Load-balance aux: E * mean_e(fraction of tokens routed to e * mean router prob of e).
    frac = mask.reshape(B, T * K, E).mean(dim=(0, 1)) * K  # fraction per expert
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def _moe_block(cfg: MoEConfig, x: torch.Tensor, lp: dict):
    """Routed SwiGLU experts with residual. Expert weights [E, D, F] are placed over
    ``ep``; the einsums over ``e`` are where the collectives run."""
    y = tfm.rms_norm(x, lp["mlp_norm"])
    dispatch, combine, aux = _route(cfg, y, lp["w_router"])
    d, c = dispatch.to(y.dtype), combine.to(y.dtype)
    expert_in = torch.einsum("btec,btd->ebcd", d, y)  # [E, B, C, D]
    gate = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, lp["we_gate"].to(y.dtype)))
    up = torch.einsum("ebcd,edf->ebcf", expert_in, lp["we_up"].to(y.dtype))
    out = torch.einsum("ebcf,efd->ebcd", gate * up, lp["we_down"].to(y.dtype))
    y_out = torch.einsum("btec,ebcd->btd", c, out)
    return x + y_out, aux


def _moe_layer(cfg: MoEConfig, x: torch.Tensor, lp: dict, cos, sin, attn_fn):
    x = tfm._attn_block(cfg, x, lp, cos, sin, attn_fn)
    return _moe_block(cfg, x, lp)


def forward(params, tokens: torch.Tensor, cfg: MoEConfig, *, attn_fn=None,
            position_offset: int = 0):
    """tokens [B, T] → (logits [B, T, V] float32, aux loss scalar)."""
    params = tfm.as_tree(params)
    attn_fn = tfm.adapt_attn_fn(attn_fn, position_offset)
    with tfm.sharding_context(params):
        x = tfm.embed_tokens(params, tokens, cfg)
        cos, sin = tfm.rope_tables(cfg, tokens.shape[1], position_offset, device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for lp in tfm.layer_slices(params["layers"], cfg.n_layers):
            x, layer_aux = _moe_layer(cfg, x, lp, cos, sin, attn_fn)
            aux = aux + layer_aux
        return tfm.head(params, x), aux / cfg.n_layers


def loss_fn(params, tokens: torch.Tensor, cfg: MoEConfig, **kw) -> torch.Tensor:
    logits, aux = forward(params, tokens, cfg, **kw)
    logits = logits[:, :-1]
    targets = tokens[:, 1:]
    return tfm.token_nll(logits, targets).mean() + cfg.router_aux_weight * aux


def make_train_step(cfg: MoEConfig, optimizer: Optional[Callable] = None, attn_fn=None):
    """(train_step, init_opt_state), the same contract as the dense model's."""
    return tfm.make_train_step_from_loss(
        lambda model, tokens: loss_fn(model, tokens, cfg, attn_fn=attn_fn), optimizer
    )
