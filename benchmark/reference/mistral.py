"""The plain reference of the train step: a Mistral-7B decoder stack in float32 and
AdamW, written from the published description (Mistral-7B-v0.1's ``config.json`` and
the Mistral paper, arXiv:2310.06825), independent of the program.

- token embedding, then per layer: RMSNorm, grouped-query attention with RoPE
  (split-half rotation, theta from the config), causal softmax, the output
  projection and the residual; RMSNorm, SwiGLU (``down(silu(gate(x)) * up(x))``)
  and the residual; a final RMSNorm and the untied head;
- the loss: the mean next-token cross-entropy over every position but the last;
- AdamW with decoupled weight decay, bias-corrected moments.

Departures, noted: Mistral's 4,096-token sliding window is left out, because the
sequences run here are no longer than the window, where it equals full causal
attention. Every matmul runs in float32 with TF32 off (:func:`full_precision`). The
batch is computed one sequence at a time, gradients accumulated, so that it fits.

``fp8=True`` is the control, the reference in the precision under the configuration's
bfloat16, as a float8 training program computes it: every tensor that a bfloat16
program holds between its operations (the embedding rows, each norm's output, q, k, v,
the scores and probabilities, each projection's output, the residual stream, the
logits) is held in bfloat16, forward and backward; the attention's two products run on
bfloat16 operands; every product with a weight (the seven projections of a layer and
the head) runs on float8 e4m3 operands, one scale per tensor (its largest magnitude to
448), its input, weight and incoming gradient alike, with a bfloat16 output.
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


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor."""
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Product(torch.autograd.Function):
    """``a @ w`` on e4m3 operands, forward and backward, each output in bfloat16."""

    @staticmethod
    def forward(ctx, a, w):
        a8, w8 = e4m3(a), e4m3(w)
        ctx.save_for_backward(a8, w8)
        return (a8 @ w8).to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        a8, w8 = ctx.saved_tensors
        g8 = e4m3(g)
        return ((g8 @ w8.T).to(torch.bfloat16).float(),
                (a8.T @ g8).to(torch.bfloat16).float())


class Model:
    def __init__(self, cfg: dict, fp8: bool = False):
        self.cfg = cfg
        self.fp8 = fp8
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.head_dim = cfg["hidden_size"] // self.heads
        self.eps = cfg["rms_norm_eps"]

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
        inv = self.cfg["rope_theta"] ** (-torch.arange(half, dtype=torch.float64,
                                                       device=device) * 2 / self.head_dim)
        ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv[None]
        return torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, y: torch.Tensor, p: dict, layer: int, cos, sin) -> torch.Tensor:
        t, h, hkv, dh = y.shape[0], self.heads, self.kv_heads, self.head_dim
        q = self.held(self.rotate(self.linear(y, p["layers.wq"][layer]).view(t, h, dh), cos,
                                  sin))
        k = self.held(self.rotate(self.linear(y, p["layers.wk"][layer]).view(t, hkv, dh), cos,
                                  sin))
        v = self.linear(y, p["layers.wv"][layer]).view(t, hkv, dh)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        scores = self.mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(dh)
        causal = torch.ones(t, t, dtype=torch.bool, device=y.device).tril()
        probs = self.held(torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1))
        out = self.mm(probs, v.transpose(0, 1)).transpose(0, 1).reshape(t, h * dh)
        return self.linear(out, p["layers.wo"][layer])

    def nll_sum(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The summed next-token NLL of one sequence ``[T]``."""
        cos, sin = self.rope(tokens.shape[0], tokens.device)
        x = self.held(p["embed"][tokens])
        for layer in range(self.cfg["num_hidden_layers"]):
            x = self.held(x + self.attention(self.norm(x, p["layers.attn_norm"][layer]), p,
                                             layer, cos, sin))
            y = self.norm(x, p["layers.mlp_norm"][layer])
            gate = self.held(F.silu(self.linear(y, p["layers.w_gate"][layer])))
            up = self.linear(y, p["layers.w_up"][layer])
            x = self.held(x + self.linear(self.held(gate * up), p["layers.w_down"][layer]))
        logits = self.linear(self.norm(x[:-1], p["final_norm"]), p["lm_head"])
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
          rows=None) -> dict:
    """Steps of the reference from ``weights`` (consumed: trained in place) over
    ``batches`` (``[b, T]`` each). Returns each step's loss, each leaf's norm and
    largest magnitude of the first step's gradient, and each leaf's norm of its change
    over the steps.
    ``rows`` limits each batch to its first rows (a fault's half batch)."""
    model = Model(cfg, fp8=fp8)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach() for k, v in weights.items()}
    opt = AdamW(params, optimizer["lr"], tuple(optimizer["betas"]), optimizer["eps"],
                optimizer["weight_decay"])
    losses, grad_norms, grad_max = [], None, None
    for tokens in batches:
        tokens = tokens[:rows] if rows else tokens
        b, t = tokens.shape
        for p in params.values():
            p.grad = None
        total = 0.0
        for row in tokens:
            loss = model.nll_sum(params, row) / (b * (t - 1))
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if grad_norms is None:
            grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
            grad_max = {k: float(p.grad.abs().amax()) for k, p in params.items()}
        opt.step()
    change_norms = {k: float((params[k].detach() - start[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "grad_max": grad_max,
            "change_norms": change_norms}
