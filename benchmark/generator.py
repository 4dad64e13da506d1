"""The general generator: inputs and weights made from ``--seed`` and the parameters
of a configuration file and a traffic mix.

Everything is made on the run's device in a few large calls from seeded generators,
so the same seed gives the same inputs to the program and to the plain reference,
which calls these functions again on its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Streams of one seed: each input has its own, so adding one never moves another.
WEIGHTS, TOKENS = 3, 4


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    words = np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(2, np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1]))


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    return gen


# -- a decoder's weights and tokens -------------------------------------------------


def decoder_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The leaves of a GQA SwiGLU decoder by name, layer weights stacked on a leading
    ``[L]`` axis, each matrix ``[in, out]``."""
    d, f, v, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], \
        cfg["num_hidden_layers"]
    dh = d // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * dh, cfg["num_key_value_heads"] * dh
    return {
        "embed": (v, d),
        "layers.attn_norm": (n, d),
        "layers.wq": (n, d, q),
        "layers.wk": (n, d, kv),
        "layers.wv": (n, d, kv),
        "layers.wo": (n, q, d),
        "layers.mlp_norm": (n, d),
        "layers.w_gate": (n, d, f),
        "layers.w_up": (n, d, f),
        "layers.w_down": (n, f, d),
        "final_norm": (d,),
        "lm_head": (d, v),
    }


def decoder_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 weights by leaf name, views of one flat buffer drawn in one call: every
    matrix ``N(0, initializer_range)`` as the source's initializer draws it, every
    norm scale 1."""
    shapes = decoder_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch_generator(seed, WEIGHTS, device)
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(cfg["initializer_range"])
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        if name.endswith("norm"):
            leaf.fill_(1.0)
        out[name] = leaf
        at += n
    return out


class TokenBatches:
    """Batches of ``[batch, seq]`` token ids drawn uniformly from the vocabulary, one
    after another from the seed's stream: every row differs."""

    def __init__(self, cfg: dict, batch: int, seq: int, seed: int, device):
        self.shape = (batch, seq)
        self.vocab = cfg["vocab_size"]
        self.device = device
        self.gen = torch_generator(seed, TOKENS, device)

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)
