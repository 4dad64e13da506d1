"""Elastic resharding: resume any checkpoint on any world size / mesh topology.

The local checkpoint tier saves one container per rank, each holding that
rank's *local* block of every global array (``state_dict.py`` pops leaves in
tree order; ``format.py`` records their shapes in the ``TPURES02`` header).
Until this module, a resumed world had to match the saving world's sharding
exactly — losing part of a slice meant "restart blocked until capacity
returns" (the scenario the reference's elastic agent gestures at but never
implements). This module closes that gap with pure index algebra:

- a :class:`TreeLayout` describes how every leaf's GLOBAL index space is
  block-partitioned over a rank grid (the ``parallel/mesh.py`` axis language:
  per-dim axis names over ``{dp, tp, sp, pp, ep, ...}`` sizes). The saving
  world embeds its layout in each container's header meta (``meta["layout"]``,
  schema ``tpu-reshard-1``); any *target* layout — fewer ranks, more ranks, or
  a changed DP/TP split of the same count — is just another ``TreeLayout``.
- :func:`build_plan` intersects the two grids: for each target rank it maps
  every newly-owned index range back to the source grid cell that held it,
  with the candidate source owners (replicas included) and the exact byte
  ranges inside the source leaf payload. Cells of a uniform grid never
  overlap, so the plan covers every global index exactly once by
  construction — :meth:`ReshardPlan.validate` proves it, and
  :meth:`ReshardPlan.require_available` turns "coverage impossible" into a
  :class:`CheckpointError` naming the missing source ranks.
- the execution side lives in ``local_manager.load_resharded`` (slice local
  shards, ranged-fetch the rest from clique peers) and
  ``comm.PeerExchange.fetch_ranges`` (the ranged-read wire op).

Everything here is numpy/stdlib only — the algebra must be runnable from
operator tooling (``ckpt_info --plan``) without touching JAX or tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from tpu_resiliency_torch.exceptions import CheckpointError

#: Mesh axis precedence (outermost first) — matches ``parallel.mesh.build_mesh``:
#: ``pp`` outermost (rare, large-grained hops), ``tp`` innermost (per-matmul
#: collectives on the fastest loops). Layouts may use any subset, or extra
#: axis names appended after these.
AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")

#: Header-meta schema tag for an embedded layout (``meta["layout"]``).
LAYOUT_SCHEMA = "tpu-reshard-1"
LAYOUT_META_KEY = "layout"


def _prod(xs: Iterable[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class Box:
    """An axis-aligned block of a global index space: ``offset`` + ``shape``."""

    offset: tuple[int, ...]
    shape: tuple[int, ...]

    @property
    def elems(self) -> int:
        return _prod(self.shape)

    def intersect(self, other: "Box") -> Optional["Box"]:
        off, shp = [], []
        for o1, s1, o2, s2 in zip(self.offset, self.shape, other.offset, other.shape):
            lo, hi = max(o1, o2), min(o1 + s1, o2 + s2)
            if hi <= lo:
                return None
            off.append(lo)
            shp.append(hi - lo)
        return Box(tuple(off), tuple(shp))


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf's global geometry + partition spec (axis name or None per dim)."""

    global_shape: tuple[int, ...]
    dtype: str
    spec: tuple[Optional[str], ...]

    @property
    def itemsize(self) -> int:
        from tpu_resiliency_torch.checkpoint.format import resolve_dtype

        return resolve_dtype(self.dtype).itemsize

    @property
    def global_nbytes(self) -> int:
        return _prod(self.global_shape) * self.itemsize


def _normalize_spec(spec: Any, ndim: int) -> tuple[Optional[str], ...]:
    """Accept a PartitionSpec, tuple/list, or None; pad missing trailing dims
    with None (PartitionSpec semantics). Nested tuples (multi-axis dims) are
    not supported — one axis per dim is what ``parallel/mesh.py`` uses."""
    if spec is None:
        entries: list = []
    else:
        entries = list(spec)
    out: list[Optional[str]] = []
    for e in entries:
        if e is None:
            out.append(None)
        elif isinstance(e, str):
            out.append(e)
        else:
            raise CheckpointError(
                f"reshard: unsupported partition-spec entry {e!r} "
                f"(one axis name or None per dim)"
            )
    if len(out) > ndim:
        raise CheckpointError(
            f"reshard: spec {tuple(entries)} longer than array rank {ndim}"
        )
    out.extend([None] * (ndim - len(out)))
    return tuple(out)


class TreeLayout:
    """How a whole pytree's leaves are block-partitioned over a rank grid.

    ``axes`` is an ordered ``(name, size)`` sequence (outermost first; the
    mesh axis order); ``ranks`` lists the world's rank ids in row-major grid
    order; ``leaves`` gives each leaf's global shape, dtype and per-dim axis
    spec. A leaf dim sharded on axis ``a`` is split into ``size(a)`` balanced
    contiguous blocks (``np.array_split`` bounds: block ``j`` spans
    ``[D*j//n, D*(j+1)//n)`` — uniform when divisible, off-by-one otherwise,
    which is what lets a world shrink 4→3 without a divisibility miracle);
    axes a leaf does not use replicate it across those axes — every rank
    sharing a grid cell holds an identical copy (the redundancy a shrink
    survives on).
    """

    def __init__(
        self,
        axes: Sequence[tuple[str, int]],
        ranks: Sequence[int],
        leaves: Sequence[LeafSpec],
    ):
        self.axes: tuple[tuple[str, int], ...] = tuple(
            (str(n), int(s)) for n, s in axes
        )
        self.ranks: tuple[int, ...] = tuple(int(r) for r in ranks)
        # Specs normalize to one entry per dim (short PartitionSpec-style
        # tuples pad trailing dims with None = replicated).
        self.leaves: list[LeafSpec] = [
            LeafSpec(
                global_shape=tuple(int(x) for x in l.global_shape),
                dtype=str(l.dtype),
                spec=_normalize_spec(l.spec, len(l.global_shape)),
            )
            for l in leaves
        ]
        sizes = dict(self.axes)
        if len(sizes) != len(self.axes):
            raise CheckpointError(f"reshard: duplicate axis names in {self.axes}")
        if _prod(s for _, s in self.axes) != len(self.ranks):
            raise CheckpointError(
                f"reshard: axes {dict(self.axes)} describe "
                f"{_prod(s for _, s in self.axes)} ranks, got {len(self.ranks)}"
            )
        if len(set(self.ranks)) != len(self.ranks):
            raise CheckpointError(f"reshard: duplicate rank ids in {self.ranks}")
        for i, leaf in enumerate(self.leaves):
            used = [a for a in leaf.spec if a is not None]
            if len(used) != len(set(used)):
                raise CheckpointError(
                    f"reshard: leaf {i} uses an axis on more than one dim: "
                    f"{leaf.spec}"
                )
            for d, a in enumerate(leaf.spec):
                if a is None:
                    continue
                if a not in sizes:
                    raise CheckpointError(
                        f"reshard: leaf {i} dim {d} sharded on unknown axis "
                        f"{a!r} (axes: {sorted(sizes)})"
                    )

    # -- geometry ----------------------------------------------------------

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    def coords(self, rank: int) -> dict[str, int]:
        """Grid coordinates of ``rank`` (row-major over the axis order)."""
        try:
            i = self.ranks.index(rank)
        except ValueError:
            raise CheckpointError(
                f"reshard: rank {rank} not in layout world {list(self.ranks)}"
            ) from None
        out: dict[str, int] = {}
        for name, size in reversed(self.axes):
            out[name] = i % size
            i //= size
        return out

    def box(self, leaf: int, rank: int) -> Box:
        """``rank``'s local block of leaf ``leaf``'s global index space
        (balanced ``np.array_split`` bounds per sharded dim)."""
        spec = self.leaves[leaf]
        sizes = dict(self.axes)
        coords = self.coords(rank)
        offset, shape = [], []
        for d, ax in enumerate(spec.spec):
            if ax is None:
                offset.append(0)
                shape.append(spec.global_shape[d])
            else:
                D, n, c = spec.global_shape[d], sizes[ax], coords[ax]
                lo, hi = D * c // n, D * (c + 1) // n
                offset.append(lo)
                shape.append(hi - lo)
        return Box(tuple(offset), tuple(shape))

    def local_nbytes(self, leaf: int, rank: int) -> int:
        return self.box(leaf, rank).elems * self.leaves[leaf].itemsize

    def cells(self, leaf: int) -> list[tuple[Box, tuple[int, ...]]]:
        """Distinct blocks of leaf ``leaf`` with the ranks that hold each —
        replicas grouped (identical box ⇒ identical bytes). Deterministic
        order: by block offset, owners sorted."""
        by_box: dict[tuple, list[int]] = {}
        for r in self.ranks:
            b = self.box(leaf, r)
            by_box.setdefault((b.offset, b.shape), []).append(r)
        return [
            (Box(off, shp), tuple(sorted(owners)))
            for (off, shp), owners in sorted(by_box.items())
        ]

    # -- serialization -----------------------------------------------------

    def to_meta(self) -> dict:
        """The container-meta form (rides ``meta["layout"]`` in every saved
        header, so ANY surviving container describes the whole saved world)."""
        return {
            "schema": LAYOUT_SCHEMA,
            "axes": [[n, s] for n, s in self.axes],
            "ranks": list(self.ranks),
            "leaves": [
                {
                    "global_shape": list(l.global_shape),
                    "dtype": l.dtype,
                    "spec": list(l.spec),
                }
                for l in self.leaves
            ],
        }

    @classmethod
    def from_meta(cls, meta: dict) -> "TreeLayout":
        if not isinstance(meta, dict) or meta.get("schema") != LAYOUT_SCHEMA:
            raise CheckpointError(
                f"reshard: not a {LAYOUT_SCHEMA} layout meta: "
                f"{type(meta).__name__}"
            )
        try:
            return cls(
                axes=[(n, int(s)) for n, s in meta["axes"]],
                ranks=[int(r) for r in meta["ranks"]],
                leaves=[
                    LeafSpec(
                        global_shape=tuple(int(x) for x in l["global_shape"]),
                        dtype=str(l["dtype"]),
                        spec=tuple(
                            None if a is None else str(a) for a in l["spec"]
                        ),
                    )
                    for l in meta["leaves"]
                ],
            )
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointError(f"reshard: corrupt layout meta ({e!r})") from e

    # -- construction helpers ----------------------------------------------

    @classmethod
    def for_local_tree(
        cls,
        tree: Any,
        spec_tree: Any,
        axes: Sequence[tuple[str, int]] | dict[str, int],
        ranks: Sequence[int],
        global_shapes: Optional[Sequence[tuple[int, ...]]] = None,
    ) -> "TreeLayout":
        """Build a layout from a rank's LOCAL pytree + a mirrored spec pytree.

        ``spec_tree`` mirrors ``tree`` with a per-leaf partition spec (a
        tuple of axis names / ``None``, or ``None`` for fully replicated) at
        each array leaf. Global shapes are
        inferred as ``local * size(a)`` per sharded dim — exact when the dim
        divides evenly (the usual save-time world); a world holding BALANCED
        blocks (it resumed via a non-divisible reshard) passes the true
        ``global_shapes`` explicitly (or just reuses the layout
        ``load_resharded`` returned in ``meta``). Non-array leaves (step
        counters) are skipped — leaf order matches
        ``PyTreeStateDict.pop_tensors``."""
        from tpu_resiliency_torch.checkpoint.state_dict import _is_array, dtype_name, tree_flatten

        if isinstance(axes, dict):
            order = [a for a in AXIS_ORDER if a in axes]
            order += [a for a in axes if a not in AXIS_ORDER]
            axes = [(a, axes[a]) for a in order]
        sizes = dict(axes)

        def is_spec(x) -> bool:
            if x is None:
                return True
            return isinstance(x, (tuple, list)) and all(
                e is None or isinstance(e, str) for e in x
            )

        data_leaves = tree_flatten(tree)[0]
        spec_leaves = tree_flatten(spec_tree, is_leaf=is_spec)[0]
        arrays = [l for l in data_leaves if _is_array(l)]
        if len(spec_leaves) == len(data_leaves):
            # Mirrored structure: specs for non-array leaves are ignored.
            spec_for = [
                s for l, s in zip(data_leaves, spec_leaves) if _is_array(l)
            ]
        elif len(spec_leaves) == len(arrays):
            spec_for = list(spec_leaves)
        else:
            raise CheckpointError(
                f"reshard: spec tree has {len(spec_leaves)} leaves for a tree "
                f"with {len(data_leaves)} leaves ({len(arrays)} arrays)"
            )
        if global_shapes is not None and len(global_shapes) != len(arrays):
            raise CheckpointError(
                f"reshard: {len(global_shapes)} global shapes for "
                f"{len(arrays)} array leaves"
            )
        leaves = []
        for i, (arr, raw) in enumerate(zip(arrays, spec_for)):
            spec = _normalize_spec(raw, np.ndim(arr))
            if global_shapes is not None:
                gshape = tuple(int(x) for x in global_shapes[i])
            else:
                gshape = tuple(
                    int(s) * (sizes[a] if a is not None else 1)
                    for s, a in zip(np.shape(arr), spec)
                )
            dt = dtype_name(arr)
            leaves.append(LeafSpec(gshape, dt, spec))
        return cls(axes=list(axes), ranks=ranks, leaves=leaves)

    def retarget(
        self,
        ranks: Sequence[int],
        axes: Sequence[tuple[str, int]] | dict[str, int] | None = None,
    ) -> "TreeLayout":
        """The layout this tree would have on a DIFFERENT world.

        Default rule (elastic data-parallel practice: shrink/grow ``dp``,
        keep the model split): every axis keeps its size except ``dp``, which
        absorbs the world-size change. Pass ``axes`` explicitly for a changed
        model split (e.g. a new dp/tp factorization of the same count)."""
        ranks = [int(r) for r in ranks]
        if axes is None:
            others = _prod(s for n, s in self.axes if n != "dp")
            if len(ranks) % others != 0:
                raise CheckpointError(
                    f"reshard: cannot retarget world of {len(ranks)} ranks by "
                    f"rescaling dp: non-dp axes fix a factor of {others}"
                )
            axes = [
                (n, len(ranks) // others if n == "dp" else s)
                for n, s in self.axes
            ]
            if "dp" not in dict(self.axes):
                if others != len(ranks):
                    axes = [("dp", len(ranks) // others)] + list(axes)
        elif isinstance(axes, dict):
            order = [a for a in AXIS_ORDER if a in axes]
            order += [a for a in axes if a not in AXIS_ORDER]
            axes = [(a, axes[a]) for a in order]
        return TreeLayout(axes=list(axes), ranks=ranks, leaves=self.leaves)


def extract_layout(meta: dict) -> Optional[TreeLayout]:
    """Pull an embedded layout out of a container's ``meta`` (None if absent)."""
    raw = (meta or {}).get(LAYOUT_META_KEY)
    if raw is None:
        return None
    return TreeLayout.from_meta(raw)


# -- the plan -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Range:
    """One contiguous byte run: ``src_off`` inside the source leaf payload,
    ``dst_off`` inside the target rank's local leaf buffer."""

    src_off: int
    dst_off: int
    nbytes: int


@dataclasses.dataclass
class Segment:
    """The part of one target leaf served by one source grid cell: any of
    ``owners`` (replicas — identical bytes) can serve ``ranges``."""

    leaf: int
    owners: tuple[int, ...]
    ranges: list[Range]

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.ranges)


@dataclasses.dataclass
class RankPlan:
    """Everything one target rank must assemble."""

    rank: int
    #: per-leaf target local shape (the box this rank owns under the target layout)
    local_shapes: list[tuple[int, ...]]
    segments: list[Segment]

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.segments)


def _box_ranges(inter: Box, src: Box, dst: Box, itemsize: int) -> list[Range]:
    """Decompose the intersection box into byte runs contiguous in BOTH the
    source local array and the target local array (C order).

    Trailing dims the intersection spans fully in both collapse into the run;
    the next dim up becomes the run dim (any contiguous index interval along
    it stays contiguous in both memories). Adjacent runs coalesce."""
    n = len(inter.shape)
    if n == 0:  # scalar leaf
        return [Range(0, 0, itemsize)]
    rel_src = tuple(i - s for i, s in zip(inter.offset, src.offset))
    rel_dst = tuple(i - s for i, s in zip(inter.offset, dst.offset))
    k = n
    while k > 0 and inter.shape[k - 1] == src.shape[k - 1] == dst.shape[k - 1]:
        k -= 1
    if k == 0:
        return [Range(0, 0, inter.elems * itemsize)]
    run_elems = _prod(inter.shape[k - 1 :])
    src_strides = [_prod(src.shape[d + 1 :]) for d in range(n)]
    dst_strides = [_prod(dst.shape[d + 1 :]) for d in range(n)]
    base_src = sum(rel_src[d] * src_strides[d] for d in range(k))
    base_dst = sum(rel_dst[d] * dst_strides[d] for d in range(k))
    ranges: list[Range] = []
    for coord in np.ndindex(*inter.shape[: k - 1]):
        so = base_src + sum(c * src_strides[d] for d, c in enumerate(coord))
        do = base_dst + sum(c * dst_strides[d] for d, c in enumerate(coord))
        ranges.append(Range(so * itemsize, do * itemsize, run_elems * itemsize))
    ranges.sort(key=lambda r: r.dst_off)
    merged: list[Range] = []
    for r in ranges:
        if (
            merged
            and merged[-1].dst_off + merged[-1].nbytes == r.dst_off
            and merged[-1].src_off + merged[-1].nbytes == r.src_off
        ):
            merged[-1] = Range(
                merged[-1].src_off, merged[-1].dst_off, merged[-1].nbytes + r.nbytes
            )
        else:
            merged.append(r)
    return merged


class ReshardPlan:
    """The full repartition map for (source layout) → (target layout)."""

    def __init__(self, source: TreeLayout, target: TreeLayout):
        if len(source.leaves) != len(target.leaves):
            raise CheckpointError(
                f"reshard: leaf count mismatch (source {len(source.leaves)}, "
                f"target {len(target.leaves)})"
            )
        for i, (a, b) in enumerate(zip(source.leaves, target.leaves)):
            if a.global_shape != b.global_shape or a.dtype != b.dtype:
                raise CheckpointError(
                    f"reshard: leaf {i} geometry mismatch — source "
                    f"{a.global_shape}/{a.dtype} vs target "
                    f"{b.global_shape}/{b.dtype}"
                )
        self.source = source
        self.target = target
        self._cells = [source.cells(i) for i in range(len(source.leaves))]
        self._per_rank: dict[int, RankPlan] = {}

    @property
    def direction(self) -> str:
        n, m = self.source.world_size, self.target.world_size
        return "shrink" if m < n else ("grow" if m > n else "resplit")

    def for_rank(self, rank: int) -> RankPlan:
        if rank not in self._per_rank:
            self._per_rank[rank] = self._build_rank(rank)
        return self._per_rank[rank]

    def _build_rank(self, rank: int) -> RankPlan:
        shapes: list[tuple[int, ...]] = []
        segments: list[Segment] = []
        for i, spec in enumerate(self.target.leaves):
            tbox = self.target.box(i, rank)
            shapes.append(tbox.shape)
            for sbox, owners in self._cells[i]:
                inter = tbox.intersect(sbox)
                if inter is None:
                    continue
                segments.append(
                    Segment(
                        leaf=i,
                        owners=owners,
                        ranges=_box_ranges(inter, sbox, tbox, spec.itemsize),
                    )
                )
        return RankPlan(rank=rank, local_shapes=shapes, segments=segments)

    # -- proofs ------------------------------------------------------------

    def validate(self) -> None:
        """Prove exact cover: for every target rank, every leaf's local byte
        space is tiled by the plan's destination ranges with no gap and no
        overlap (grid cells of a uniform partition cannot overlap, but this
        check holds regardless of how the plan was built)."""
        for rank in self.target.ranks:
            rp = self.for_rank(rank)
            for i, spec in enumerate(self.target.leaves):
                want = _prod(rp.local_shapes[i]) * spec.itemsize
                runs = sorted(
                    (r.dst_off, r.nbytes)
                    for s in rp.segments
                    if s.leaf == i
                    for r in s.ranges
                )
                pos = 0
                for off, nb in runs:
                    if off != pos:
                        raise CheckpointError(
                            f"reshard plan: leaf {i} target rank {rank} "
                            f"{'overlap' if off < pos else 'gap'} at byte "
                            f"{min(off, pos)} (expected {pos}, got {off})"
                        )
                    pos = off + nb
                if pos != want:
                    raise CheckpointError(
                        f"reshard plan: leaf {i} target rank {rank} covers "
                        f"{pos} of {want} bytes"
                    )

    def missing_sources(self, available: Iterable[int]) -> dict[int, list[int]]:
        """Source ranks whose data is needed but absent: ``{leaf: [ranks]}``
        of cells where NO replica owner is in ``available``."""
        avail = set(int(r) for r in available)
        out: dict[int, set[int]] = {}
        for rank in self.target.ranks:
            for seg in self.for_rank(rank).segments:
                if not (set(seg.owners) & avail):
                    out.setdefault(seg.leaf, set()).update(seg.owners)
        return {leaf: sorted(ranks) for leaf, ranks in sorted(out.items())}

    def require_available(self, available: Iterable[int]) -> None:
        """Raise a :class:`CheckpointError` naming the missing source ranks
        when ``available`` cannot cover the target world."""
        missing = self.missing_sources(available)
        if missing:
            all_missing = sorted({r for rs in missing.values() for r in rs})
            raise CheckpointError(
                f"reshard: coverage impossible — no surviving copy of source "
                f"rank(s) {all_missing} (needed for leaf(s) "
                f"{sorted(missing)}; available: {sorted(set(available))})"
            )

    # -- summaries ---------------------------------------------------------

    def summary(
        self,
        rank: Optional[int] = None,
        local_owners: Optional[dict[int, set[int]]] = None,
    ) -> dict:
        """Byte accounting for one rank (or the whole target world).

        ``local_owners[rank]`` = source-owner containers on that rank's own
        disk; ranges servable from one of them count as ``local_bytes``,
        everything else as ``peer_bytes`` (the ranged-fetch volume)."""
        ranks = [rank] if rank is not None else list(self.target.ranks)
        local = peer = total = nranges = 0
        for r in ranks:
            held = (local_owners or {}).get(r, set())
            for seg in self.for_rank(r).segments:
                nb = seg.nbytes
                total += nb
                nranges += len(seg.ranges)
                if set(seg.owners) & set(held):
                    local += nb
                else:
                    peer += nb
        return {
            "direction": self.direction,
            "source_world": self.source.world_size,
            "target_world": self.target.world_size,
            "ranks": len(ranks),
            "total_bytes": total,
            "local_bytes": local,
            "peer_bytes": peer,
            "ranges": nranges,
        }


def build_plan(source: TreeLayout, target: TreeLayout) -> ReshardPlan:
    """Compute (and prove) the repartition plan for source → target."""
    plan = ReshardPlan(source, target)
    plan.validate()
    return plan


def assemble_rank(
    plan: ReshardPlan,
    rank: int,
    read_range,
    pick_owner=None,
) -> list[np.ndarray]:
    """Materialize ``rank``'s target-local leaves from a plan.

    ``read_range(owner, leaf, src_off, nbytes) -> bytes-like`` supplies source
    bytes; ``pick_owner(segment) -> owner`` chooses among replicas (default:
    lowest rank). The in-memory executor behind the property tests and any
    caller that already has all source shards at hand — the on-disk / ranged-
    fetch executor is ``local_manager.load_resharded``."""
    rp = plan.for_rank(rank)
    out: list[np.ndarray] = []
    buffers: list[np.ndarray] = []
    for i, spec in enumerate(plan.target.leaves):
        from tpu_resiliency_torch.checkpoint.format import resolve_dtype

        buf = np.empty(rp.local_shapes[i], dtype=resolve_dtype(spec.dtype))
        buffers.append(buf)
        out.append(buf)
    for seg in rp.segments:
        owner = pick_owner(seg) if pick_owner is not None else seg.owners[0]
        flat = buffers[seg.leaf].reshape(-1).view(np.uint8)
        for r in seg.ranges:
            got = read_range(owner, seg.leaf, r.src_off, r.nbytes)
            view = memoryview(got)
            if view.nbytes != r.nbytes:
                raise CheckpointError(
                    f"reshard: short read from owner {owner} leaf {seg.leaf} "
                    f"({view.nbytes} of {r.nbytes} bytes)"
                )
            flat[r.dst_off : r.dst_off + r.nbytes] = np.frombuffer(
                view, dtype=np.uint8
            )
    return out


def slice_local(
    global_arrays: Sequence[np.ndarray], layout: TreeLayout, rank: int
) -> list[np.ndarray]:
    """A rank's local blocks of materialized global arrays (test/bench helper
    — production shards come off the device already local)."""
    out = []
    for i, arr in enumerate(global_arrays):
        b = layout.box(i, rank)
        sl = tuple(slice(o, o + s) for o, s in zip(b.offset, b.shape))
        out.append(np.ascontiguousarray(arr[sl]))
    return out
