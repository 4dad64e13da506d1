"""Flagship model: a Llama-style decoder-only transformer in PyTorch, mesh-shardable.

Port of ``tpu_resiliency/models/transformer.py``, the resiliency framework's exercise
workload. The math is the reference's, op for op:

- parameters stacked on a leading ``[L]`` axis, as the reference's pytree holds them;
  the layer stack is a Python loop over ``L`` where the reference runs ``lax.scan``,
- float32 master weights cast to ``cfg.dtype`` (bfloat16 by default) at each product,
  float32 scores, the ``-1e30`` causal mask and the softmax, RoPE in the split-half
  layout, GQA grouped in the einsum (repeated K/V never materialized), SwiGLU,
  RMSNorm,
- ``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)``, the counterpart of
  ``optax.adamw(3e-4, weight_decay=0.01)``.

:class:`Transformer` is the ``nn.Module`` that holds the tree: its parameter names are
the tree's leaf paths (``embed``, ``layers.wq``, ...), so the mesh's ``param_specs``
and the checkpoint's leaf order (``checkpoint.state_dict.tree_flatten``, jax's order)
line up with the reference's. The functions take either the module or the nested
tree of tensors (:meth:`Transformer.tree`). :func:`params_from_reference` and
:func:`params_to_reference` carry weights across from the reference's ``init_params``
(numpy arrays) and back; :func:`adam_state_from_reference` and
:func:`adam_state_to_reference` do the same for the optimizer (optax ``mu``/``nu``/
``count`` against torch's ``exp_avg``/``exp_avg_sq``/``step``).

The products stay ``torch.matmul``/``torch.einsum``: the reference computes them
outside any Pallas kernel. Every entry point that makes tensors takes ``device=None``,
which means the CUDA card (raises without one); ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_resiliency_torch.platform.device import resolve_device

@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**kw) -> "TransformerConfig":
        base = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128,
        )
        base.update(kw)
        return TransformerConfig(**base)

    @staticmethod
    def llama3_8b(**kw) -> "TransformerConfig":
        base = dict(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            d_ff=14336, max_seq_len=8192, rope_theta=500000.0,
        )
        base.update(kw)
        return TransformerConfig(**base)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def dense_init(gen: torch.Generator, shape, fan_in: int, device) -> torch.Tensor:
    """Standard normal over ``sqrt(fan_in)``, float32."""
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) / math.sqrt(fan_in)


def init_params(seed: int, cfg: TransformerConfig, *, with_mlp: bool = True,
                device=None) -> dict:
    """Parameter tree with layer weights stacked on a leading [L] axis, float32, drawn
    from a generator seeded with ``seed`` on ``device`` (the card by default). The
    draws are torch's, not ``jax.random``'s: to hold the port against the reference,
    carry the reference's weights across with :func:`params_from_reference`.

    ``with_mlp=False`` skips the dense SwiGLU weights (the MoE family replaces them
    with expert stacks and must not materialize both)."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    d, h, hkv, dh, f, L = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers,
    )
    ones = functools.partial(torch.ones, dtype=torch.float32, device=dev)
    init = functools.partial(dense_init, gen, device=dev)
    layers = {
        "attn_norm": ones(L, d),
        "wq": init((L, d, h * dh), d),
        "wk": init((L, d, hkv * dh), d),
        "wv": init((L, d, hkv * dh), d),
        "wo": init((L, h * dh, d), h * dh),
        "mlp_norm": ones(L, d),
    }
    if with_mlp:
        layers["w_gate"] = init((L, d, f), d)
        layers["w_up"] = init((L, d, f), d)
        layers["w_down"] = init((L, f, d), f)
    return {
        "embed": init((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones(d),
        "lm_head": init((d, cfg.vocab_size), d),
    }


# -- the module and the tree ------------------------------------------------------


class Transformer(nn.Module):
    """The dense model's parameters as an ``nn.Module``: ``embed``, ``layers.<key>``
    (each stacked on ``[L]``), ``final_norm``, ``lm_head``. ``params`` (a tree as
    :func:`init_params` returns it, or the flat names of :func:`params_from_reference`)
    is taken as it is; without it the weights come from ``init_params(seed, cfg)`` on
    ``device`` (the card by default)."""

    init_fn: Callable = staticmethod(init_params)

    def __init__(self, cfg: TransformerConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = type(self).init_fn(seed, cfg, device=device)
        params = nest(params)
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ParameterDict({k: nn.Parameter(v) for k, v in params["layers"].items()})
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"])

    def tree(self) -> dict:
        """The parameters as the reference's nested tree (the tensors themselves)."""
        return {"embed": self.embed, "layers": dict(self.layers.items()),
                "final_norm": self.final_norm, "lm_head": self.lm_head}

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        return forward(self, tokens, self.cfg, **kw)


def as_tree(params) -> dict:
    """The nested tree of a :class:`Transformer`, a nested tree, or flat names."""
    if isinstance(params, nn.Module):
        return params.tree()
    return nest(params)


def nest(params: dict) -> dict:
    """Flat ``{"layers.wq": t, ...}`` names as the nested tree; a nested tree as it is."""
    if "layers" in params:
        return params
    tree: dict = {}
    for name, value in params.items():
        head, _, rest = name.partition(".")
        if rest:
            tree.setdefault(head, {})[rest] = value
        else:
            tree[head] = value
    return tree


def flat_names(tree: dict) -> dict:
    """The nested tree as flat module names (``layers.wq``), the leaves themselves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def params_from_reference(tree: dict, device=None) -> dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy arrays, or anything ``np.asarray`` takes)
    as the port's flat parameter names, float32 tensors on ``device`` (the card by
    default). Values are copied bit for bit."""
    dev = resolve_device(device)
    return {name: _from_numpy(v, dev) for name, v in flat_names(tree).items()}


def params_to_reference(params) -> dict:
    """The port's parameters (a module, a tree or flat names) as the reference's
    nested tree of float32 numpy arrays."""
    return nest({name: _to_numpy(t) for name, t in flat_names(as_tree(params)).items()})


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


# -- the optimizer state ----------------------------------------------------------


def adamw(lr: float = 3e-4, weight_decay: float = 0.01) -> Callable:
    """An optimizer factory ``params -> torch.optim.AdamW``: by default the
    counterpart of ``optax.adamw(3e-4, weight_decay=0.01)`` (b1 0.9, b2 0.999, eps
    1e-8, decoupled decay on every leaf)."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def adam_state_from_reference(model: nn.Module, optimizer: torch.optim.Optimizer,
                              mu: dict, nu: dict, count) -> None:
    """Load optax's Adam state (``ScaleByAdamState``'s ``mu``, ``nu`` and ``count``,
    trees shaped like the parameters) into ``optimizer``'s ``exp_avg``,
    ``exp_avg_sq`` and ``step`` for ``model``'s parameters, bit for bit."""
    mu, nu = flat_names(mu), flat_names(nu)
    for name, p in model.named_parameters():
        state = optimizer.state[p]
        state["step"] = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
        state["exp_avg"] = _from_numpy(mu[name], p.device)
        state["exp_avg_sq"] = _from_numpy(nu[name], p.device)


def _from_numpy(value, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32, copy=True)).to(device)


def adam_state_to_reference(model: nn.Module, optimizer: torch.optim.Optimizer):
    """``(mu, nu, count)`` of ``optimizer`` for ``model``, as optax holds them: trees
    of float32 numpy arrays shaped like the parameters, and the step count."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        state = optimizer.state[p]
        mu[name] = _to_numpy(state["exp_avg"])
        nu[name] = _to_numpy(state["exp_avg_sq"])
        count = int(state["step"])
    return nest(mu), nest(nu), count


# -- the layers -------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope_tables(cfg: TransformerConfig, seq_len: int, offset: int = 0, device=None):
    dev = resolve_device(device)
    dh = cfg.head_dim
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=dev) / dh
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32, device=dev),
                               exps)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=dev)
    angles = pos[:, None] * inv_freq[None, :]  # [T, dh/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, dh]; cos/sin: [T, dh/2] (the split-half layout)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(q, k, v, causal_offset: int = 0):
    """Plain causal attention. q: [B, T, H, dh]; k/v: [B, T, Hkv, dh] with
    H % Hkv == 0 (GQA): query heads are grouped per KV head in the einsum itself,
    so repeated K/V are never materialized."""
    dh = q.shape[-1]
    b, tq, h, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, tq, hkv, h // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(dh)
    qpos = torch.arange(tq, device=q.device)[:, None] + causal_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = qpos >= kpos
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, tq, h, dh)


def adapt_attn_fn(attn_fn, causal_offset: int = 0):
    """Resolve the layer-level attention callable from a user override.

    The attention blocks hand ``attn_fn`` GQA-shaped tensors (q ``[B, T, H, dh]``,
    k/v ``[B, T, Hkv, dh]``). The default :func:`_attention` consumes those directly.
    Custom fns keep their documented pre-repeated-full-heads contract, so they are
    wrapped with the repeat here, at the seam.

    ``causal_offset`` only applies to the default dense attention; a custom fn owns
    its own position bookkeeping, so combining the two is rejected here rather than
    silently producing a mask anchored at 0."""
    if attn_fn is not None and causal_offset:
        raise ValueError(
            "position_offset is only applied to the default dense attention; "
            "a custom attn_fn must handle positions itself"
        )
    if attn_fn is None:
        return functools.partial(_attention, causal_offset=causal_offset)

    def repeated(q, k, v):
        reps = q.shape[2] // k.shape[2]
        if reps > 1:
            k = torch.repeat_interleave(k, reps, dim=2)
            v = torch.repeat_interleave(v, reps, dim=2)
        return attn_fn(q, k, v)

    return repeated


def _attn_block(cfg: TransformerConfig, x: torch.Tensor, lp: dict, cos, sin, attn_fn):
    """Pre-norm GQA attention with residual; shared by the dense and MoE layers."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    y = rms_norm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(y.dtype)).reshape(b, t, h, dh)
    k = (y @ lp["wk"].to(y.dtype)).reshape(b, t, hkv, dh)
    v = (y @ lp["wv"].to(y.dtype)).reshape(b, t, hkv, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, k, v).reshape(b, t, h * dh)
    return x + attn @ lp["wo"].to(attn.dtype)


def _layer(cfg: TransformerConfig, x: torch.Tensor, lp: dict, cos, sin, attn_fn):
    x = _attn_block(cfg, x, lp, cos, sin, attn_fn)
    # MLP block (SwiGLU)
    y = rms_norm(x, lp["mlp_norm"])
    gate = F.silu(y @ lp["w_gate"].to(y.dtype))
    up = y @ lp["w_up"].to(y.dtype)
    return x + (gate * up) @ lp["w_down"].to(y.dtype)


def layer_slices(layers: dict, n_layers: int):
    """Layer ``l``'s leaves, ``{key: stacked[l]}``, for ``l`` in ``range(n_layers)``:
    the Python loop that stands where the reference's ``lax.scan`` runs."""
    for i in range(n_layers):
        yield {k: v[i] for k, v in layers.items()}


def sharding_context(params):
    """``implicit_replication()`` when ``params`` (a module or a tree) holds DTensors,
    so the plain tensors the model makes (RoPE tables, the causal mask) join them as
    replicated values; a null context otherwise."""
    leaves = params.parameters() if isinstance(params, nn.Module) else flat_names(params).values()
    if any(hasattr(p, "device_mesh") for p in leaves):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        # The context sets the flag on entry and clears it on exit: a nested one
        # (forward inside a train step) must leave the outer one's flag alone.
        if not getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
            return implicit_replication()
    return contextlib.nullcontext()


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to ``Replicate()`` on every mesh dimension; any other
    tensor as it is. The model calls it where DTensor has no sharding rule for an op
    (ROADMAP.md, "DTensor gaps"): the op then runs on the whole value, so the math
    never changes."""
    if not hasattr(t, "redistribute"):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    # DTensor gap: no rule gathers rows of a row-sharded table.
    return replicated(params["embed"]).to(cfg.dtype)[tokens]


def head(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"].to(x.dtype)).float()


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, *, attn_fn=None,
            position_offset: int = 0) -> torch.Tensor:
    """tokens [B, T] int64 → logits [B, T, V] (float32). ``params`` is a
    :class:`Transformer`, its tree or its flat names.

    ``position_offset`` is applied to RoPE and to the DEFAULT dense attention's
    causal mask only; a custom ``attn_fn`` owns its own position bookkeeping, so
    combining the two is rejected (in :func:`adapt_attn_fn`)."""
    params = as_tree(params)
    attn_fn = adapt_attn_fn(attn_fn, position_offset)
    with sharding_context(params):
        x = embed_tokens(params, tokens, cfg)
        cos, sin = rope_tables(cfg, tokens.shape[1], position_offset, device=tokens.device)
        for lp in layer_slices(params["layers"], cfg.n_layers):
            x = _layer(cfg, x, lp, cos, sin, attn_fn)
        return head(params, x)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position next-token NLL, ``logsumexp(logits) - logits[target]``: never
    materializes the ``[B, T, V]`` log-prob tensor."""
    # DTensor gap: the target pick on vocab-sharded logits (a gather along a sharded
    # dim) fails in DTensor's masked partial; the logits are gathered first.
    logits = replicated(logits)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return lse - picked


def loss_fn(params, tokens: torch.Tensor, cfg: TransformerConfig, **kw) -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, T]. The forward pass runs on the FULL
    sequence and the last position's logits are dropped afterwards, as the
    reference does."""
    logits = forward(params, tokens, cfg, **kw)[:, :-1]
    targets = tokens[:, 1:]
    return token_nll(logits, targets).mean()


def make_train_step_from_loss(bound_loss_fn, optimizer: Optional[Callable] = None):
    """Shared factory behind every model family's ``make_train_step``:
    ``(train_step, init_opt_state)`` from a bound ``loss_fn(model, tokens)``.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (default
    :func:`adamw`). ``init_opt_state(model)`` builds it over ``model.parameters()``;
    ``train_step(model, opt, tokens)`` runs forward, backward and the update in
    place, and returns ``(model, opt, loss)`` with the loss detached, in the
    reference's ``(params, opt_state, loss)`` order."""
    optimizer = optimizer or adamw()

    def init_opt_state(model: nn.Module) -> torch.optim.Optimizer:
        return optimizer(model.parameters())

    def train_step(model: nn.Module, opt: torch.optim.Optimizer, tokens: torch.Tensor):
        opt.zero_grad(set_to_none=True)
        with sharding_context(model):
            loss = bound_loss_fn(model, tokens)
            loss.backward()
            opt.step()
        if hasattr(loss, "full_tensor"):  # over a mesh: the global mean on every rank
            loss = loss.full_tensor()
        return model, opt, loss.detach()

    return train_step, init_opt_state


def make_train_step(cfg: TransformerConfig, optimizer: Optional[Callable] = None, attn_fn=None):
    """Returns ``(train_step, init_opt_state)``; ``attn_fn`` overrides the dense
    attention."""
    return make_train_step_from_loss(
        lambda model, tokens: loss_fn(model, tokens, cfg, attn_fn=attn_fn), optimizer
    )
