"""Pipeline parallelism: GPipe-style microbatch schedule over the ``pp`` mesh axis.

Port of ``tpu_resiliency/parallel/pipeline.py``. The stacked ``[L]`` layer axis of
the models' parameter trees shards into ``pp`` contiguous stages (each rank holds
``L/pp`` layers and loops over them, the same layer body as the unpipelined models).
Microbatches flow through the stage ring: at tick ``t`` stage 0 takes microbatch
``t``, every stage applies its layers, and the result hops one stage on
(``parallel/p2p.py`` ``shift``, differentiable), so stage ``s`` works on microbatch
``t - s``. After ``n_micro + pp - 1`` ticks every microbatch has crossed every stage,
and the last stage's results are broadcast back over ``pp``. Autograd runs the
reverse schedule: the shift's backward is the hop the other way, so there is no
hand-written backward pass.

What differs from the reference, and why:

- The schedule is a Python loop over ticks where the reference runs ``lax.scan``;
  a stage skips its layers on a tick where it holds no microbatch (the reference
  computes and masks them because a scan has static shapes). Loss and gradients are
  the same.
- Each pp rank holds its ``L/pp`` layers as local tensors (``to_local()`` of the
  pp-sharded leaf), re-wrapped as DTensors on the sub-mesh of the remaining axes
  where ``tp``, ``ep`` or ``dp`` are larger than 1, so tensor- and expert-parallel
  layers run inside a stage as they do unpipelined. Indexing a pp-sharded DTensor
  per layer would all-gather it. ``mesh.checkpoint_layout`` still describes ``[L]``
  as sharded over ``pp``.
- The last stage's buffer reaches every stage through a differentiable broadcast,
  ``p2p.read_from`` (the reference: ``all_gather`` and an index). Every stage
  computes the same loss from it, so its gradient reaches the last stage once.
  The carries enter the pipeline through ``p2p.replicate_in``, whose backward sums
  over ``pp`` as the transpose of the reference's replicated ``in_specs`` does.
- Microbatches are cut from each dp rank's rows, so a dp rank's microbatch ``i`` is
  its share of the global microbatch ``i``; with ``dp = 1`` they are the reference's.
- The reference's float32 boundary (a workaround for an XLA CPU miscompile of bf16
  all-reduces) is dropped: the carries keep their dtypes.

Composition limits (the reference's): ring attention (``sp > 1``) does not nest
inside the pipeline body; pipelined configs run dense attention (``sp == 1``,
enforced), while long-context jobs shard ``sp`` without ``pp``.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_resiliency_torch.parallel import mesh as pm
from tpu_resiliency_torch.parallel.mesh import PP, SP
from tpu_resiliency_torch.parallel.p2p import read_from, replicate_in, shift


def _is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh")


def _sub_mesh(mesh, names):
    """The sub-mesh of root ``mesh`` on ``names`` (None for no names)."""
    if not names:
        return None
    return mesh[tuple(names)] if len(names) > 1 else mesh[names[0]]


def _stage_placements(t, axis_name, drop_leading: bool):
    """The placements of DTensor ``t`` without its ``axis_name`` mesh dim: those of
    its local value on the stage mesh. ``drop_leading``: the value loses its leading
    (microbatch) dim, so a shard of dim d becomes a shard of dim d - 1."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == axis_name:
            continue
        if isinstance(p, Shard) and drop_leading:
            if p.dim == 0:
                raise ValueError(f"the microbatch dim is sharded over {name}")
            p = Shard(p.dim - 1)
        elif not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"unsupported placement {p} on {name}")
        out.append(p)
    return out


def make_stacked_pipeline(mesh, layer_fn: Callable, n_micro: int, axis_name: str = PP):
    """Build ``apply(layers, carries, consts) -> carries_out``.

    - ``layers``: dict whose leaves stack the layer axis ``[L, ...]``, placed as
      ``pipeline_layer_specs`` places them (DTensors sharded over ``axis_name`` on
      dim 0), or plain tensors every rank holds whole; ``L`` must divide evenly into
      the ``axis_name`` stages.
    - ``carries``: tuple of tensors with leading ``[n_micro]``, one activation carry
      per microbatch (e.g. ``(x,)`` or ``(x, aux)``), replicated over ``axis_name``.
    - ``consts``: per-call constants every stage uses (e.g. RoPE tables).
    - ``layer_fn(carry, lp, consts) -> carry`` applies ONE layer.

    Returns the carries after every stage, placed as ``carries`` were.
    """
    from torch.distributed.tensor import DTensor

    sizes = pm.axis_sizes(mesh)
    n_stages = sizes[axis_name]
    group = mesh.get_group(axis_name) if n_stages > 1 else None
    stage = mesh.get_local_rank(axis_name) if n_stages > 1 else 0

    def stage_mesh_of(t):
        return _sub_mesh(mesh, [n for n in t.device_mesh.mesh_dim_names if n != axis_name])

    def local_layers(layers):
        """This stage's ``[L/pp]`` leaves: DTensors on the stage mesh, or plain."""
        out = {}
        for k, v in layers.items():
            if not _is_dtensor(v):
                per = v.shape[0] // n_stages
                out[k] = v[stage * per:(stage + 1) * per]
                continue
            local = v.to_local()
            sm = stage_mesh_of(v)
            out[k] = local if sm is None else DTensor.from_local(
                local, sm, _stage_placements(v, axis_name, drop_leading=False), run_check=False)
        return out

    def stage_fn(layers_local, carry, consts, n_layers):
        for i in range(n_layers):
            carry = layer_fn(carry, {k: v[i] for k, v in layers_local.items()}, consts)
        return carry

    def apply(layers, carries, consts):
        n_layers = next(iter(layers.values())).shape[0]
        if n_layers % n_stages:
            raise ValueError(f"n_layers={n_layers} not divisible by {axis_name}={n_stages}")
        layers_local = local_layers(layers)
        n_local = n_layers // n_stages
        # Each carry leaf as local microbatches, and how to wrap one for the stage.
        leaves = []
        for c in carries:
            if _is_dtensor(c):
                sm = stage_mesh_of(c)
                places = None if sm is None else _stage_placements(c, axis_name, drop_leading=True)
                local = c.to_local()
            else:
                sm = places = None
                local = c
            if group is not None:
                local = replicate_in(local, group)
            leaves.append((local, sm, places))

        def wrap(state):
            return tuple(v if sm is None else DTensor.from_local(v, sm, p, run_check=False)
                         for v, (_, sm, p) in zip(state, leaves))

        def unwrap(carry):
            return [c if sm is None else c.redistribute(sm, p).to_local()
                    for c, (_, sm, p) in zip(carry, leaves)]

        first = torch.tensor(stage == 0)
        state = [l[0] for l, _, _ in leaves]
        outs = []
        n_ticks = n_micro + n_stages - 1
        for t in range(n_ticks):
            mb = t - stage
            if 0 <= mb < n_micro:
                y = unwrap(stage_fn(layers_local, wrap(state), consts, n_local))
            else:  # no microbatch here on this tick: the layers are skipped
                y = state
            if t >= n_stages - 1:
                # The last stage emits microbatch t - (pp - 1). Every stage keeps its
                # value so that its part of the graph stays connected; only the last
                # stage's is read back.
                outs.append(y)
            if t + 1 == n_ticks:
                break
            inj = [l[min(t + 1, n_micro - 1)] for l, _, _ in leaves]
            if group is None:
                state = inj
            else:
                # The reference's where(stage == 0, injected, received): what stage 0
                # receives stays in its graph, so every stage runs each hop's backward.
                nxt = shift(y, group)
                state = [torch.where(first, a, b) for a, b in zip(inj, nxt)]

        result = []
        for j, (_, sm, p) in enumerate(leaves):
            buf = torch.stack([y[j] for y in outs])
            if group is not None:
                buf = read_from(buf, n_stages - 1, group)
            c = carries[j]
            result.append(DTensor.from_local(buf, c.device_mesh, c.placements, run_check=False)
                          if _is_dtensor(c) else buf)
        return tuple(result)

    return apply


def _check_pipeline_mesh(mesh, cfg, n_micro):
    sizes = pm.axis_sizes(mesh)
    n_stages = sizes[PP]
    if cfg.n_layers % n_stages != 0:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={n_stages}")
    if sizes.get(SP, 1) != 1:
        raise ValueError(
            "pipelined configs run dense attention: ring attention (sp > 1) does not "
            "nest inside the pp stage body"
        )
    if n_micro < 1:
        raise ValueError("n_micro must be >= 1")


def _microbatches(x, n_micro: int):
    """[B, ...] → [n_micro, B/n_micro, ...], each dp rank cutting its own rows."""
    if not _is_dtensor(x):
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    from torch.distributed.tensor import DTensor, Shard

    local = x.to_local()
    if local.shape[0] % n_micro:
        raise ValueError(f"local batch {local.shape[0]} not divisible by n_micro={n_micro}")
    places = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(local.reshape(n_micro, -1, *local.shape[1:]), x.device_mesh,
                              places, run_check=False)


def _whole_batch(x):
    """The inverse of :func:`_microbatches`."""
    if not _is_dtensor(x):
        return x.reshape(-1, *x.shape[2:])
    from torch.distributed.tensor import DTensor, Shard

    local = x.to_local()
    places = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(local.reshape(-1, *local.shape[2:]), x.device_mesh, places,
                              run_check=False)


def make_pipelined_loss_fn(cfg, mesh, n_micro: int, family: str = "dense"):
    """Cross-entropy loss with the layer stack pipelined over ``pp``; takes
    ``(params, tokens)`` as the models' ``loss_fn`` does.

    ``family``: ``"dense"`` (``models.transformer``) or ``"moe"`` (``models.moe``:
    the router aux rides the microbatch carry and is averaged).
    """
    from tpu_resiliency_torch.models import moe as moe_mod
    from tpu_resiliency_torch.models import transformer as tfm

    _check_pipeline_mesh(mesh, cfg, n_micro)

    if family == "dense":

        def layer_fn(carry, lp, consts):
            (x,) = carry
            cos, sin = consts
            return (tfm._layer(cfg, x, lp, cos, sin, tfm._attention),)

    elif family == "moe":

        def layer_fn(carry, lp, consts):
            x, aux = carry
            cos, sin = consts
            x, layer_aux = moe_mod._moe_layer(cfg, x, lp, cos, sin, tfm._attention)
            return (x, aux + layer_aux)

    else:
        raise ValueError(f"unknown family: {family!r}")

    pipeline = make_stacked_pipeline(mesh, layer_fn, n_micro)

    def loss_fn(params, tokens):
        from torch.distributed.tensor import DTensor, Replicate

        params = tfm.as_tree(params)
        B, T = tokens.shape
        if B % n_micro != 0:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        with tfm.sharding_context(params):
            x = tfm.embed_tokens(params, tokens, cfg)
            cos, sin = tfm.rope_tables(cfg, T, device=tokens.device)
            carries = (_microbatches(x, n_micro),)
            if family == "moe":
                aux = torch.zeros((n_micro,), dtype=torch.float32, device=tokens.device)
                if _is_dtensor(x):
                    aux = DTensor.from_local(aux, x.device_mesh,
                                             [Replicate()] * x.device_mesh.ndim, run_check=False)
                carries = carries + (aux,)
            out = pipeline(params["layers"], carries, (cos, sin))
            logits = tfm.head(params, _whole_batch(out[0]))[:, :-1]
            loss = tfm.token_nll(logits, tokens[:, 1:]).mean()
            if family == "moe":
                loss = loss + cfg.router_aux_weight * out[1].mean() / cfg.n_layers
        return loss

    return loss_fn


def make_pipelined_train_step(cfg, mesh, n_micro: int, family: str = "dense", optimizer=None):
    """(train_step, init_opt_state) with the layer stack pipelined over ``pp``: the
    same contract as the models' ``make_train_step``."""
    from tpu_resiliency_torch.models.transformer import make_train_step_from_loss

    loss_fn = make_pipelined_loss_fn(cfg, mesh, n_micro, family)
    return make_train_step_from_loss(loss_fn, optimizer)
