"""Mesh axis conventions and sharding-spec helpers for the framework's models.

Port of ``tpu_resiliency/parallel/mesh.py``. Axis names used throughout:

- ``dp``: data parallel (batch axis; gradients reduced over the group),
- ``tp``: tensor parallel (attention heads / MLP hidden sharded),
- ``sp``: sequence/context parallel (the sequence axis; attention runs as a ring,
  ``parallel/ring_attention.py``),
- ``pp``: pipeline parallel (the stacked ``[L]`` layer axis in stages; microbatches
  hop stage to stage, ``parallel/pipeline.py``),
- ``ep``: expert parallel (the MoE expert axis).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (gloo on the CPU, NCCL on the card; ``platform/device.py``
``make_mesh``). The spec helpers return what the reference's return: per leaf, a
tuple with one entry per tensor dim, an axis name or ``None`` (the reference's
``PartitionSpec`` is such a tuple), so a test compares them leaf by leaf.
:func:`tree_shardings` turns them into DTensor placements (one ``Shard(dim)`` or
``Replicate()`` per mesh dimension), :func:`distribute_model` places a model's
parameters by them, and :func:`checkpoint_layout` hands them to
``checkpoint/reshard.py``'s ``TreeLayout.for_local_tree``, which takes tuples of axis
names. The integer arithmetic (``default_split``, ``moe_pipeline_split``,
``axis_sizes``) is the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

DP, TP, SP, PP, EP = "dp", "tp", "sp", "pp", "ep"


def build_mesh(
    n_devices: Optional[int] = None,
    *,
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    devices: Optional[Sequence[int]] = None,
    device=None,
):
    """Build a ``DeviceMesh`` with the framework's canonical axes (pp, dp, ep, sp, tp)
    over ``devices``, ranks of the default process group (all of them by default).

    If ``n_devices`` is given without explicit axis sizes, all devices go to ``dp``.
    Axis order puts ``pp`` outermost and ``tp`` innermost, as the reference's does.
    ``device=None`` means the card (NCCL); ``device="cpu"`` a gloo mesh."""
    from tpu_resiliency_torch.platform.device import make_mesh, process_count

    devs = list(devices) if devices is not None else list(range(process_count()))
    if n_devices is not None:
        devs = devs[:n_devices]
    total = dp * tp * sp * pp * ep
    if total == 1 and n_devices:
        dp, total = len(devs), len(devs)
    if total != len(devs):
        raise ValueError(f"dp*tp*sp*pp*ep = {total} != {len(devs)} devices")
    return make_mesh({PP: pp, DP: dp, EP: ep, SP: sp, TP: tp}, devices=devs, device=device)


def default_split(n_devices: int) -> dict[str, int]:
    """A sensible (dp, tp, sp) split for n devices (pp/ep left to dedicated configs —
    see :func:`moe_pipeline_split`): 8 devices → (dp=2, tp=2, sp=2)."""
    if n_devices % 8 == 0:
        return {"dp": n_devices // 4, "tp": 2, "sp": 2, "pp": 1, "ep": 1}
    tp = 2 if n_devices % 2 == 0 else 1
    return {"dp": n_devices // tp, "tp": tp, "sp": 1, "pp": 1, "ep": 1}


def moe_pipeline_split(n_devices: int) -> dict[str, int]:
    """A (dp, pp, ep) split exercising the pipeline + expert axes: 8 devices →
    (dp=2, pp=2, ep=2)."""
    if n_devices % 4 == 0:
        return {"dp": n_devices // 4, "tp": 1, "sp": 1, "pp": 2, "ep": 2}
    if n_devices % 2 == 0:
        return {"dp": n_devices // 2, "tp": 1, "sp": 1, "pp": 1, "ep": 2}
    return {"dp": n_devices, "tp": 1, "sp": 1, "pp": 1, "ep": 1}


def param_specs(cfg) -> dict:
    """Specs for the transformer parameter tree (see models/transformer.py).

    Megatron-style: wq/wk/wv and w_gate/w_up shard their output dim over ``tp``; wo
    and w_down shard their input dim over ``tp``; embeddings shard vocab over
    ``tp``; norms replicate."""
    return {
        "embed": (TP, None),  # [V, D]
        "layers": {
            "attn_norm": (None, None),  # [L, D]
            "wq": (None, None, TP),  # [L, D, H*dh]
            "wk": (None, None, TP),  # [L, D, Hkv*dh]
            "wv": (None, None, TP),  # [L, D, Hkv*dh]
            "wo": (None, TP, None),  # [L, H*dh, D]
            "mlp_norm": (None, None),  # [L, D]
            "w_gate": (None, None, TP),  # [L, D, F]
            "w_up": (None, None, TP),  # [L, D, F]
            "w_down": (None, TP, None),  # [L, F, D]
        },
        "final_norm": (None,),  # [D]
        "lm_head": (None, TP),  # [D, V]
    }


def moe_param_specs(cfg) -> dict:
    """Specs for the MoE parameter tree (see models/moe.py): a replicated router
    and experts stacked on an ``[E]`` axis sharded over ``ep``; within each expert
    the SwiGLU weights keep the megatron column/row split over ``tp``."""
    specs = param_specs(cfg)
    layers = dict(specs["layers"])
    for k in ("w_gate", "w_up", "w_down"):
        del layers[k]
    layers["w_router"] = (None, None, None)  # [L, D, E]
    layers["we_gate"] = (None, EP, None, TP)  # [L, E, D, F]
    layers["we_up"] = (None, EP, None, TP)  # [L, E, D, F]
    layers["we_down"] = (None, EP, TP, None)  # [L, E, F, D]
    specs["layers"] = layers
    return specs


def pipeline_layer_specs(layer_specs: dict) -> dict:
    """Prepend ``pp`` to the leading stacked-``[L]`` dim of every per-layer spec, so
    each pipeline stage holds only its own layers."""
    return {k: (PP, *spec[1:]) for k, spec in layer_specs.items()}


def batch_spec():
    return (DP, SP)  # tokens [B, T]


def active_mesh(mesh):
    """The sub-mesh of ``mesh``'s axes whose size exceeds 1 (its last axis when none
    does): the mesh DTensor places on. The sharding is the same, since an axis of
    size 1 splits nothing, but DTensor's sharding propagation searches redistribution
    paths across every mesh dimension, and on the full five-axis mesh that search
    took minutes per op (torch 2.13, ROADMAP.md "DTensor gaps")."""
    names = [n for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape) if s > 1]
    names = names or [mesh.mesh_dim_names[-1]]
    if len(names) == len(mesh.mesh_dim_names):
        return mesh
    return mesh[tuple(names)] if len(names) > 1 else mesh[names[0]]


def placements(mesh, spec) -> tuple:
    """One DTensor placement per mesh dimension for a leaf of spec ``spec``:
    ``Shard(dim)`` on the mesh dimension that ``spec`` names at tensor dim ``dim``,
    ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    spec = tuple(spec or ())
    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def tree_shardings(mesh, specs):
    """Map a spec tree to DTensor placements (the reference's ``NamedSharding``s):
    one per dimension of :func:`active_mesh` of ``mesh``."""
    sub = active_mesh(mesh)
    return _map_specs(lambda spec: placements(sub, spec), specs)


def distribute_model(model, mesh, specs) -> None:
    """Replace every parameter of ``model`` (a ``models`` module, whose parameter names
    are the tree's leaf paths) by a DTensor placed per ``specs`` on ``mesh``. Every
    rank must hold the same full values (seeded alike); rank 0's are scattered."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    sub = active_mesh(mesh)
    shardings = tree_shardings(mesh, specs)
    for name, p in list(model.named_parameters()):
        owner = model
        *path, leaf = name.split(".")
        place = shardings
        for part in path:
            owner = getattr(owner, part) if not isinstance(owner, dict) else owner[part]
            place = place[part]
        dt = distribute_tensor(p.detach(), sub, list(place[leaf]))
        setattr(owner, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))


def distribute_batch(tokens, mesh):
    """Tokens ``[B, T]`` as a DTensor placed per :func:`batch_spec` (every rank passes
    the same global batch; rank 0's is scattered)."""
    from torch.distributed.tensor import distribute_tensor

    sub = active_mesh(mesh)
    return distribute_tensor(tokens, sub, list(placements(sub, batch_spec())))


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh — the form the elastic reshard layout
    (``checkpoint/reshard.py``) consumes."""
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def checkpoint_layout(mesh, tree, spec_tree, ranks: Optional[Sequence[int]] = None):
    """A :class:`~tpu_resiliency_torch.checkpoint.reshard.TreeLayout` for saving
    ``tree`` (this rank's LOCAL tree) sharded per ``spec_tree`` on ``mesh``: pass it
    to ``LocalCheckpointManager.save(..., layout=...)`` and any later world can resume
    through ``load_resharded``. ``ranks`` defaults to one rank per mesh position
    (``range(n)``); pass the job's actual global rank order when it differs."""
    from tpu_resiliency_torch.checkpoint.reshard import TreeLayout

    sizes = axis_sizes(mesh)
    if ranks is None:
        ranks = range(int(np.prod(mesh.mesh.shape, dtype=np.int64)))
    # Mesh axis order is authoritative (row-major rank grid follows it).
    axes = [(n, sizes[n]) for n in map(str, mesh.mesh_dim_names)]
    return TreeLayout.for_local_tree(tree, spec_tree, axes, list(ranks))

