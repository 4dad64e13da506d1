"""Ring attention: causal attention over a sequence-sharded mesh axis.

Port of ``tpu_resiliency/parallel/ring_attention.py``. The sequence axis of the
activations is sharded over the mesh's ``sp`` axis, and attention runs as a ring:
each rank keeps its local Q block and rotates the K/V blocks around the ``sp`` group
(``parallel/p2p.py`` ``shift``, one hop per step, differentiable), folding each
incoming block into a numerically stable online softmax with float32 ``(m, l, o)``
accumulators. Peak memory per rank is O(T_local) and the communication is
nearest-neighbour.

Usage (the transformer takes it through ``forward(..., attn_fn=...)``)::

    attn_fn = make_ring_attn_fn(mesh)       # axes: dp, sp, tp
    logits = forward(model, tokens, cfg, attn_fn=attn_fn)

The kernel is causal with GLOBAL positions: shard ``i`` of the ring owns positions
``[i*T_local, (i+1)*T_local)``, and the mask of each rotating K/V block is computed
against its source shard, so the result is the dense ``models.transformer._attention``
(held to it in the tests).

Where the reference wraps the block in ``shard_map``, ``attn_fn`` takes q/k/v as
DTensors, redistributes them to the reference's ``in_specs`` (batch over ``dp``,
sequence over ``sp``, heads over ``tp``), runs the block on their local tensors and
returns a DTensor with the same placements. Plain tensors are taken as the global
value every rank holds, and the result is returned whole. With ``sp = 1`` the ring
is one block, with no exchange. The reference's ``_cached_sharded_kernel`` cache is
gone: there is no program to compile, only the group and the placements to look up.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpu_resiliency_torch.parallel import mesh as pm
from tpu_resiliency_torch.parallel.mesh import DP, SP, TP
from tpu_resiliency_torch.parallel.p2p import shift

NEG_INF = -1e30


def _ring_block(q, k, v, *, group, causal: bool):
    """The local kernel. q/k/v: [B, T_local, H, dh], this rank's block; ``group`` is
    the ``sp`` ring (None for a ring of one)."""
    sp = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    b, tl, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)

    qf = q.float()
    ar = torch.arange(tl, device=q.device)
    q_pos = idx * tl + ar  # global positions of the resident Q block

    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, tl, h, dh), dtype=torch.float32, device=q.device)

    for r in range(sp):
        # Block r arrived from shard (idx - r): its K positions are global.
        src = (idx - r) % sp
        k_pos = src * tl + ar
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]  # [Tq, Tk]
            scores = torch.where(mask[None, None], scores, NEG_INF)
        block_m = scores.amax(dim=-1)  # [B, H, Tq]
        new_m = torch.maximum(m, block_m)
        # Fully masked rows keep new_m == NEG_INF; exp(NEG_INF - NEG_INF) would be
        # 1, so probabilities are explicitly zeroed where the score was masked.
        p = torch.exp(scores - new_m[..., None])
        p = torch.where(scores <= NEG_INF, 0.0, p)
        correction = torch.exp(m - new_m)  # [B, H, Tq]
        l = l * correction + p.sum(dim=-1)
        o = o * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v.float()
        )
        m = new_m
        if r + 1 < sp:
            k, v = shift((k, v), group)

    o = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


def make_ring_attn_fn(mesh, *, causal: bool = True, axis_name: str = SP,
                      batch_axis: str = DP, head_axis: str = TP):
    """Build an ``attn_fn`` for ``models.transformer.forward``: q/k/v enter as
    [B, T, H, dh] logically, placed batch over ``dp``, sequence over ``sp``, heads
    over ``tp``. KV must be pre-repeated to full heads (``transformer.adapt_attn_fn``
    wraps custom fns with exactly that repeat), so head counts divide over ``tp``."""
    from torch.distributed.tensor import DTensor, Replicate

    sizes = pm.axis_sizes(mesh)
    group = mesh.get_group(axis_name) if sizes.get(axis_name, 1) > 1 else None
    spec = (batch_axis, axis_name, head_axis, None)

    def attn_fn(q, k, v):
        whole = not isinstance(q, DTensor)
        if whole:
            sub = pm.active_mesh(mesh)
            q, k, v = (DTensor.from_local(x, sub, [Replicate()] * sub.ndim, run_check=False)
                       for x in (q, k, v))
        sub = q.device_mesh
        places = pm.placements(sub, spec)
        q, k, v = (x.redistribute(sub, places) for x in (q, k, v))
        o = _ring_block(q.to_local(), k.to_local(), v.to_local(), group=group, causal=causal)
        out = DTensor.from_local(o, sub, places, run_check=False)
        return out.full_tensor() if whole else out

    return attn_fn
