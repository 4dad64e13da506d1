"""The plain reference of the LFM2-MoE train step: the ``lfm2_moe`` layer stack in float32
and AdamW, written from its published description (LiquidAI's LFM2-24B-A2B
``config.json`` and the ``lfm2_moe`` modelling of Hugging Face transformers),
independent of the program.

- the token embedding, then per layer, each pre-normed (RMSNorm, ``norm_eps``) with a
  residual: the operator ``layer_types[i]``, then the FFN;
- the gated short conv: ``B, C, x = split3(h @ W_in)``, ``y = C * conv(B * x)`` with a
  causal depthwise convolution of ``conv_L_cache`` taps per channel along time (zero
  padding on the left, tap ``L-1`` on the current position), then ``y @ W_out``; no
  biases;
- attention: grouped-query attention whose q and k are RMS-normed over each head's
  channels before the split-half RoPE (theta from ``rope_parameters``), causal softmax,
  the output projection;
- the FFN: SwiGLU (``down(silu(gate(h)) * up(h))``) in the first ``num_dense_layers``
  layers; after them the router ``s = sigmoid(h @ W_r)``, the experts chosen as
  ``topk(s + b, num_experts_per_tok)`` with ``b`` the expert bias, weighted by
  ``s[chosen] / (sum s[chosen] + 1e-6)`` where ``norm_topk_prob``, times
  ``routed_scaling_factor``, and each expert's SwiGLU over its own tokens in an
  explicit loop over the experts, weighted and summed per token;
- a final RMSNorm and the head tied to the embedding (``tie_word_embeddings``);
- the loss: the mean next-token cross-entropy over every position but the last;
- AdamW with decoupled weight decay, bias-corrected moments, over every parameter (the
  expert bias is no parameter).

Departures, noted: the expert bias is held fixed (``lfm2_moe`` training updates it
between steps from the experts' loads, by a rule the configuration does not give), and
there is no auxiliary loss (the family balances its experts by the bias alone). Every
product runs in float32 with TF32 off (:func:`full_precision`). The batch is computed
one sequence at a time, gradients accumulated, so that it fits.

``fp8=True`` is the control, the reference in the precision under the configuration's
bfloat16, as a float8 training program computes it: every tensor that a bfloat16
program holds between its operations (the embedding rows, each norm's output, the
conv's gates and output, q, k, v, the scores and probabilities, each projection's and
each expert's output, the residual stream, the logits) is held in bfloat16, forward and
backward; the attention's two products run on bfloat16 operands; every product with a
weight (the projections of each layer, the router, each expert's three and the head)
runs on float8 e4m3 operands, one scale per tensor (its largest magnitude to 448), its
input, weight and incoming gradient alike, with a bfloat16 output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def full_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Bf16(torch.autograd.Function):
    """A tensor held in bfloat16: rounded on the way forward and on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def e4m3(x: torch.Tensor):
    """``x`` in float8 e4m3 with one scale per tensor: ``(values, scale)``."""
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn), scale


class _Fp8Product(torch.autograd.Function):
    """``a @ w`` on e4m3 operands, forward and backward, each output in bfloat16. The
    operands are kept in float8 for the backward."""

    @staticmethod
    def forward(ctx, a, w):
        (a8, sa), (w8, sw) = e4m3(a), e4m3(w)
        ctx.save_for_backward(a8, sa, w8, sw)
        return ((a8.float() / sa) @ (w8.float() / sw)).to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        a8, sa, w8, sw = ctx.saved_tensors
        a, w = a8.float() / sa, w8.float() / sw
        g8, sg = e4m3(g)
        g = g8.float() / sg
        return (g @ w.T).to(torch.bfloat16).float(), (a.T @ g).to(torch.bfloat16).float()


class Model:
    def __init__(self, cfg: dict, fp8: bool = False, bias_in_choice: bool = True):
        self.cfg = cfg
        self.fp8 = fp8
        self.bias_in_choice = bias_in_choice
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.head_dim = cfg["hidden_size"] // self.heads
        self.eps = cfg["norm_eps"]
        self.routes: list = []  # each routed layer's [T, k] choices and weights, in order

    def held(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor as the model holds it between operations."""
        return _Bf16.apply(x) if self.fp8 else x

    def linear(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A product with a weight."""
        return _Fp8Product.apply(a, w) if self.fp8 else a @ w

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product of two activations."""
        return self.held(a @ b)

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return self.held(x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps)
                         * scale)

    def rope(self, t: int, device):
        half = self.head_dim // 2
        theta = self.cfg["rope_parameters"]["rope_theta"]
        inv = theta ** (-torch.arange(half, dtype=torch.float64, device=device) * 2
                        / self.head_dim)
        ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv[None]
        return torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def conv(self, y: torch.Tensor, w: dict) -> torch.Tensor:
        """The gated short conv of ``y`` ``[T, d]``."""
        t = y.shape[0]
        gate_b, gate_c, x = self.linear(y, w["conv_in"]).chunk(3, dim=-1)
        u = self.held(gate_b * x)
        taps = w["conv_kernel"].shape[-1]
        padded = F.pad(u, (0, 0, taps - 1, 0))
        conv = sum(padded[j:j + t] * w["conv_kernel"][:, j] for j in range(taps))
        return self.linear(self.held(gate_c * self.held(conv)), w["conv_out"])

    def attention(self, y: torch.Tensor, w: dict, cos, sin) -> torch.Tensor:
        t, h, hkv, dh = y.shape[0], self.heads, self.kv_heads, self.head_dim
        q = self.norm(self.linear(y, w["wq"]).view(t, h, dh), w["q_norm"])
        k = self.norm(self.linear(y, w["wk"]).view(t, hkv, dh), w["k_norm"])
        q = self.held(self.rotate(q, cos, sin))
        k = self.held(self.rotate(k, cos, sin))
        v = self.linear(y, w["wv"]).view(t, hkv, dh)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        scores = self.mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(dh)
        causal = torch.ones(t, t, dtype=torch.bool, device=y.device).tril()
        probs = self.held(torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1))
        out = self.mm(probs, v.transpose(0, 1)).transpose(0, 1).reshape(t, h * dh)
        return self.linear(out, w["wo"])

    def swiglu(self, y, gate, up, down) -> torch.Tensor:
        g = self.held(F.silu(self.linear(y, gate)))
        return self.linear(self.held(g * self.linear(y, up)), down)

    def routed(self, y: torch.Tensor, w: dict, bias: torch.Tensor) -> torch.Tensor:
        """The routed experts over ``y`` ``[T, d]``: the router, then one expert at a
        time over the tokens that chose it."""
        cfg = self.cfg
        scores = torch.sigmoid(self.linear(y, w["w_router"]))
        pick = scores.detach() + bias if self.bias_in_choice else scores.detach()
        chosen = torch.topk(pick, cfg["num_experts_per_tok"], dim=-1).indices
        weights = scores.gather(-1, chosen)
        if cfg["norm_topk_prob"]:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
        weights = weights * cfg["routed_scaling_factor"]
        self.routes.append((chosen.detach(), weights.detach()))
        gate, up, down = (w[k].unbind(0) for k in ("we_gate", "we_up", "we_down"))
        out = torch.zeros_like(y)
        for e in range(cfg["num_experts"]):
            token, slot = torch.nonzero(chosen == e, as_tuple=True)
            if token.numel():
                expert = self.held(self.swiglu(y[token], gate[e], up[e], down[e]))
                out = out.index_add(0, token, expert * weights[token, slot][:, None])
        return self.held(out)

    def logits(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The logits ``[T, V]`` of one sequence ``[T]``."""
        cfg = self.cfg
        cos, sin = self.rope(tokens.shape[0], tokens.device)
        stacked = {k[len("layers."):]: v.unbind(0) for k, v in p.items()
                   if k.startswith("layers.")}
        bias = p["expert_bias"].unbind(0)
        at = {"conv": 0, "full_attention": 0}
        x = self.held(p["embed"][tokens])
        for i, kind in enumerate(cfg["layer_types"]):
            j = at[kind]
            at[kind] += 1
            keys = (("conv_in", "conv_kernel", "conv_out") if kind == "conv"
                    else ("wq", "wk", "wv", "wo", "q_norm", "k_norm"))
            w = {k: stacked[k][j] for k in keys}
            y = self.norm(x, stacked["op_norm"][i])
            op = self.conv(y, w) if kind == "conv" else self.attention(y, w, cos, sin)
            x = self.held(x + op)
            y = self.norm(x, stacked["ffn_norm"][i])
            if i < cfg["num_dense_layers"]:
                ffn = self.swiglu(y, stacked["w_gate"][i], stacked["w_up"][i],
                                  stacked["w_down"][i])
            else:
                m = i - cfg["num_dense_layers"]
                ffn = self.routed(y, {k: stacked[k][m] for k in
                                      ("w_router", "we_gate", "we_up", "we_down")}, bias[m])
            x = self.held(x + ffn)
        return self.linear(self.norm(x, p["final_norm"]), p["embed"].T)

    def nll_sum(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The summed next-token NLL of one sequence ``[T]``."""
        logits = self.logits(p, tokens)[:-1]
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, tokens[1:, None])[:, 0]).sum()


class AdamW:
    """Decoupled weight decay, then the bias-corrected Adam update."""

    def __init__(self, params: dict, lr: float, betas, eps: float, weight_decay: float):
        self.params = params
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def train(cfg: dict, optimizer: dict, weights: dict, batches: list, fp8: bool = False,
          rows=None, bias_in_choice: bool = True) -> dict:
    """Steps of the reference from ``weights`` (flat names; consumed: trained in place;
    ``expert_bias`` held fixed) over ``batches`` (``[b, T]`` each). Returns each step's
    loss, each parameter's norm and largest magnitude of the first step's gradient, each
    parameter's norm of its change over the steps, and the first step's expert choices,
    ``[b, T, k]`` per routed layer. ``rows`` limits each batch to its first rows (a
    fault's half batch); ``bias_in_choice=False`` leaves the bias out of the choice (a
    fault). The starting weights wait in host memory, so that the cell's state and the
    reference's fit the card together with one sequence's activations."""
    model = Model(cfg, fp8=fp8, bias_in_choice=bias_in_choice)
    bias = weights["expert_bias"].detach()
    params = {k: v.detach().requires_grad_(True) for k, v in weights.items()
              if k != "expert_bias"}
    start = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
    opt = AdamW(params, optimizer["lr"], tuple(optimizer["betas"]), optimizer["eps"],
                optimizer["weight_decay"])
    losses, grad_norms, grad_max, choices = [], None, None, None
    for tokens in batches:
        tokens = tokens[:rows] if rows else tokens
        b, t = tokens.shape
        for p in params.values():
            p.grad = None
        total = 0.0
        for row in tokens:
            loss = model.nll_sum(dict(params, expert_bias=bias), row) / (b * (t - 1))
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if grad_norms is None:
            grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
            grad_max = {k: float(p.grad.abs().amax()) for k, p in params.items()}
            layers = len(model.routes) // b
            choices = [torch.stack([c for c, _ in model.routes[m::layers]])
                       for m in range(layers)]
        model.routes.clear()
        opt.step()
    change_norms = {k: float((params[k].detach() - start[k].to(params[k].device)).norm())
                    for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "grad_max": grad_max,
            "change_norms": change_norms, "choices": choices}
