"""Mixture-of-experts model family: top-k routed experts, expert-parallel over ``ep``.

Port of ``tpu_resiliency/models/moe.py``, the second model family exercising the
resiliency framework. The math is the reference's:

- **Dense dispatch** (``capacity_factor`` set, the default). Top-k gates →
  capacity-bounded one-hot dispatch/combine tensors (first come, first served,
  token-major over ``(T, K)``) → batched einsums over the expert dimension, with the
  Switch load-balance aux loss.
- **Expert parallelism is a placement.** Expert weights carry a leading ``[E]`` axis
  that ``parallel/mesh.py``'s ``moe_param_specs`` shards over ``ep``; the einsums
  over the expert dimension then run on DTensors, and DTensor inserts the
  collectives. The model code names none.
- **Stacked layers** like the dense model, looped in Python, with the router aux
  loss summed across layers.

Beyond the reference, ``capacity_factor=None`` takes the **dropless** path
(:func:`dropless_experts`), which the hybrid family (``models/hybrid.py``) uses too:
the ``T·K`` choices sorted by expert, each expert's rows gathered into one group, the
gate, up and down products run as grouped products over the experts held
(``torch._grouped_mm`` on the card, a loop over the experts on the CPU), and the rows
weighted and added back to their tokens. No token is dropped and nothing waits for the
host: the group offsets stay on the device. It runs on plain tensors (no ``ep``
placement). Its spans in the span ring (``utils/tracing.py``): ``moe.dispatch`` (router,
top-k, sort and gather, then the combine's scatter-add; counts ``routed``, ``dropped``
and the largest group's rows ``max_load``, a device scalar) and ``moe.experts`` (the
grouped products), each with a device interval on the card, and the same names with
``backward=1`` around their backward work.

In this family every layer is an MoE layer (Mixtral-style); attention is the dense
model's (``transformer._attn_block``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class MoEConfig(tfm.TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    #: ``None`` routes dropless (:func:`dropless_experts`).
    capacity_factor: Optional[float] = 1.5
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
    ``ep``; the einsums over ``e`` are where the collectives run. Without a capacity
    factor the experts run dropless (:func:`dropless_experts`)."""
    y = tfm.rms_norm(x, lp["mlp_norm"])
    if cfg.capacity_factor is None:
        out, aux = dropless_experts(y, lp, functools.partial(softmax_choices, cfg))
        return x + out, aux
    dispatch, combine, aux = _route(cfg, y, lp["w_router"])
    d, c = dispatch.to(y.dtype), combine.to(y.dtype)
    expert_in = torch.einsum("btec,btd->ebcd", d, y)  # [E, B, C, D]
    gate = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, lp["we_gate"].to(y.dtype)))
    up = torch.einsum("ebcd,edf->ebcf", expert_in, lp["we_up"].to(y.dtype))
    out = torch.einsum("ebcf,efd->ebcd", gate * up, lp["we_down"].to(y.dtype))
    y_out = torch.einsum("btec,ebcd->btd", c, out)
    return x + y_out, aux


# -- the dropless path ----------------------------------------------------------------


def softmax_choices(cfg: MoEConfig, logits: torch.Tensor):
    """:func:`_route`'s router without the capacity: f32 logits ``[N, E]`` →
    ``(choices [N, K], gates [N, K], aux)``, the top-k softmax probabilities
    renormalised and the Switch aux loss over the choices."""
    n, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    idx = torch.topk(probs.detach(), cfg.top_k, dim=-1).indices
    gates = probs.gather(-1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    chosen = torch.zeros(e, dtype=probs.dtype, device=probs.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=probs.dtype, device=probs.device))
    aux = e * torch.sum(chosen / n * probs.mean(dim=0))
    return idx, gates, aux


def sigmoid_choices(logits: torch.Tensor, bias: Optional[torch.Tensor], top_k: int,
                    norm_topk_prob: bool, routed_scale: float):
    """LFM2's router: f32 logits ``[N, E]`` → ``(choices [N, K], weights [N, K])``. The
    experts are chosen by ``sigmoid(logits) + bias`` (the bias, when given, steers the
    choice only), weighted by their sigmoid scores, renormalised over the choices
    (``+ 1e-6``) where ``norm_topk_prob``, times ``routed_scale``."""
    scores = torch.sigmoid(logits)
    pick = scores.detach() if bias is None else scores.detach() + bias
    idx = torch.topk(pick, top_k, dim=-1).indices
    weights = scores.gather(-1, idx)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    return idx, weights * routed_scale


def expert_groups(choices: torch.Tensor, n_experts: int):
    """The assignments ``choices`` (expert ids, ``[A]``) grouped by expert:
    ``(order, counts, ends)``, where ``order`` lists the assignments expert by expert
    (stably, so each group keeps token order), ``counts[e]`` is expert ``e``'s rows and
    ``ends`` the int32 end of each group in ``order``. On the device, with no host
    synchronisation (``torch.bincount`` reads its input's largest value on the host)."""
    order = torch.argsort(choices, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long, device=choices.device).scatter_add_(
        0, choices, torch.ones_like(choices))
    return order, counts, torch.cumsum(counts, 0).to(torch.int32)


def grouped_product(rows: torch.Tensor, weights: torch.Tensor, ends: torch.Tensor):
    """``rows[group e] @ weights[e]`` for each expert's group of ``rows`` (``[M, I]``,
    groups ending at ``ends``) against ``weights`` ``[E, I, O]``: one grouped product on
    the card, a loop over the experts elsewhere (groups of any size, empty ones
    included: the card's product needs no padding of the groups)."""
    if rows.is_cuda:
        return torch._grouped_mm(rows, weights, offs=ends)
    out, start = [], 0
    for e, end in enumerate(ends.tolist()):
        out.append(rows[start:end] @ weights[e])
        start = end
    return torch.cat(out)


class _BackwardEdge(torch.autograd.Function):
    """The identity. Its backward closes the span that ``box["span"]`` holds, if any,
    and opens a ring span named ``name``, if given, counting ``backward=1``: one edge on
    a region's output and one on its input bound the region's backward, which autograd
    runs between the two (the region's nodes were made after its input and before its
    output)."""

    @staticmethod
    def forward(ctx, x, box: dict, name: Optional[str]):
        ctx.box, ctx.name = box, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        span = ctx.box.pop("span", None)
        if span is not None:
            span.__exit__(None, None, None)
        if ctx.name is not None:
            span = tracing.ring_span(ctx.name, device=ctx.box["device"])
            span.__enter__().count(backward=1)
            ctx.box["span"] = span
        return grad, None, None


def dropless_experts(y: torch.Tensor, lp: dict, choose: Callable):
    """Routed SwiGLU experts over ``y`` ``[B, T, D]`` (normed, compute dtype) with no
    token dropped: ``(out [B, T, D], aux)``. ``choose`` maps the router's f32 logits
    ``[N, E]`` to ``(choices [N, K], weights [N, K], aux)``, ``aux`` ``None`` for a
    router without an aux loss. The experts are ``lp``'s ``we_gate``/``we_up``
    ``[E, D, F]`` and ``we_down`` ``[E, F, D]``, the router ``w_router`` ``[D, E]``."""
    b, t, d = y.shape
    n_experts = lp["w_router"].shape[-1]
    device = y.device if y.is_cuda else None
    box = {"device": device}
    x = _BackwardEdge.apply(y.reshape(b * t, d), box, None)
    with tracing.ring_span("moe.dispatch", device=device) as span:
        logits = x.float() @ lp["w_router"].float()
        idx, weights, aux = choose(logits)
        choices = idx.reshape(-1)
        order, counts, ends = expert_groups(choices, n_experts)
        token = order // idx.shape[1]
        rows = x.index_select(0, token)
        span.count(routed=choices.numel(), dropped=choices.numel() - counts.sum(),
                   max_load=counts.max())
    rows = _BackwardEdge.apply(rows, box, "moe.dispatch")
    with tracing.ring_span("moe.experts", device=device):
        gate = F.silu(grouped_product(rows, lp["we_gate"].to(y.dtype), ends))
        up = grouped_product(rows, lp["we_up"].to(y.dtype), ends)
        out = grouped_product(gate * up, lp["we_down"].to(y.dtype), ends)
    out = _BackwardEdge.apply(out, box, "moe.experts")
    with tracing.ring_span("moe.dispatch", device=device):
        weighted = out.float() * weights.reshape(-1).index_select(0, order)[:, None]
        combined = torch.zeros(b * t, d, dtype=torch.float32, device=y.device).index_add_(
            0, token, weighted)
    out = _BackwardEdge.apply(combined.to(y.dtype), box, "moe.dispatch")
    return out.reshape(b, t, d), aux


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
