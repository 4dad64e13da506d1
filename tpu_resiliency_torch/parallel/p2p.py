"""Differentiable neighbour exchanges over a process group.

The reference's ring attention and pipeline hop activations one step around a mesh
axis with ``lax.ppermute``, and JAX derives the backward pass: the transpose of a
permutation is the inverse permutation. ``torch.distributed``'s send and receive are
not autograd-aware (``torch.distributed.nn.functional`` has no point-to-point op), so
:func:`shift` is that permutation as a ``torch.autograd.Function``:

- forward: every rank of ``group`` sends its tensors to the next rank,
  ``(i + 1) % n``, and receives the previous rank's, ``(i - 1) % n``, in one
  ``batch_isend_irecv``;
- backward: the transpose, each gradient sent one hop the other way.

With ``n = 2`` the next and the previous rank are the same peer; each tensor carries
its own tag, so the sends and receives of a tuple pair up in order on gloo.

:func:`replicate_in` and :func:`read_from` are the two other transposes the pipeline
needs. An input replicated over a group is the identity forward, and its cotangent is
the sum over the group (the reference's "replicated-over-pp inputs transpose to a
psum"). A value every rank reads from one rank is a broadcast forward; each rank
computes the same loss from it, so the source's cotangent is its own. Torch's
``torch.distributed.nn.functional.broadcast`` does not serve here: its backward sums
the identical cotangents of the group, and on a sub-group it compares the global
source rank with the group rank and zeroes the source's gradient (torch 2.13).

Every rank of ``group`` must run the backward of each call, so its outputs must be
part of the graph that leads to the rank's loss (``parallel/pipeline.py`` keeps them
there as the reference's ``where`` does).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _neighbours(group) -> tuple[int, int]:
    """Global ranks of the next and the previous rank of this one in ``group``."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return dist.get_global_rank(group, (i + 1) % n), dist.get_global_rank(group, (i - 1) % n)


def _exchange(tensors: Sequence[torch.Tensor], to: int, frm: int, group) -> list[torch.Tensor]:
    """Send each of ``tensors`` to global rank ``to`` and receive as many from ``frm``."""
    sent = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = []
    for tag, (s, r) in enumerate(zip(sent, received)):
        ops.append(dist.P2POp(dist.isend, s, to, group, tag))
        ops.append(dist.P2POp(dist.irecv, r, frm, group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return received


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        nxt, prev = _neighbours(group)
        return tuple(_exchange(tensors, nxt, prev, group))

    @staticmethod
    def backward(ctx, *grads):
        nxt, prev = _neighbours(ctx.group)
        return (None, *_exchange(grads, prev, nxt, ctx.group))


def shift(tensors: Sequence[torch.Tensor], group) -> tuple[torch.Tensor, ...]:
    """``lax.ppermute(tensors, axis, [(j, (j + 1) % n) for j in range(n)])`` over
    ``group``: returns the tensors of the previous rank. Differentiable; a group of
    one rank returns its inputs."""
    if dist.get_world_size(group) == 1:
        return tuple(tensors)
    return _Shift.apply(group, *tensors)


class _ReplicateIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, tensor):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return None, grad


def replicate_in(tensor: torch.Tensor, group) -> torch.Tensor:
    """The identity on a value every rank of ``group`` holds alike; its gradient is
    the sum of the ranks' gradients, so the value's producer sees every consumer."""
    if dist.get_world_size(group) == 1:
        return tensor
    return _ReplicateIn.apply(group, tensor)


class _ReadFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, src, tensor):
        ctx.is_src = dist.get_global_rank(group, src) == dist.get_rank()
        out = tensor.contiguous().clone()
        dist.broadcast(out, group_src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad if ctx.is_src else torch.zeros_like(grad)


def read_from(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """Every rank of ``group`` gets group rank ``src``'s ``tensor``. Each rank must go
    on to compute the same loss from it (a value replicated over the group): the
    gradient reaches ``src`` once, and the other ranks' inputs get none."""
    if dist.get_world_size(group) == 1:
        return tensor
    return _ReadFrom.apply(group, src, tensor)
