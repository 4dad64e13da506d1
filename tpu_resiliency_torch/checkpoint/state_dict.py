"""Tensor-aware state dicts on torch: split a tree into payload tensors and a hollow skeleton.

Port of ``tpu_resiliency/checkpoint/state_dict.py``. ``pop_tensors`` swaps every
tensor leaf (``torch.Tensor`` or ``np.ndarray``) of a nested structure of dicts,
lists, tuples and namedtuples for a :class:`TensorPlaceholder`, leaving a picklable
"hollow" skeleton; the payload moves through the fast path (device→host copies, raw
file IO, peer sockets).

Two things differ from the JAX reference, and both are traps:

- **Leaf order.** :func:`tree_flatten` orders leaves exactly as
  ``jax.tree_util.tree_flatten`` does: dict keys sorted (an ``OrderedDict`` keeps its
  own order), ``None`` a node with no leaves. ``torch.utils._pytree`` keeps insertion
  order and counts ``None`` as a leaf, so placeholder indices, payload order and
  reshard layouts would differ from the reference's on the same tree.
- **Mutable tensors.** A JAX array never changes; a torch tensor is updated in place
  by the next ``optimizer.step()``. :meth:`PyTreeStateDict.copy_tensors_to_host_async`
  therefore snapshots every tensor leaf on the device at the moment of the call (a
  ``clone`` on the current stream, so any later kernel on that stream runs after it),
  and the background half copies the snapshot to pinned host memory on a side stream,
  one CUDA event per leaf. The caller pays enqueue cost only; the snapshot costs one
  state's worth of device memory until the copies land, freed leaf by leaf as
  :meth:`HostSnapshot.resolve` advances.

The host side of the port is numpy, as the reference's: dtypes numpy lacks (bf16,
fp8) travel as raw unsigned integers of the same width, tagged with the reference's
dtype name (``format.RAW_DTYPES``), so container headers keep ``"bfloat16"``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from tpu_resiliency_torch.checkpoint.format import RAW_DTYPES, _dtype_name, resolve_dtype
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.utils.events import record as record_event


# -- the flatten, in jax.tree_util's order --------------------------------------

_LEAF = object()


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> tuple[list, Any]:
    """``(leaves, treedef)`` in ``jax.tree_util.tree_flatten``'s order. Nodes are
    dict (keys sorted), ``defaultdict`` (keys sorted), ``OrderedDict`` (its order),
    list, tuple, namedtuple and ``None`` (no leaves); anything else is a leaf, as is
    a node ``is_leaf`` accepts. Treedefs compare equal when the structures do."""
    leaves: list = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return _LEAF
        if node is None:
            return None
        kind = type(node)
        if kind in (dict, collections.defaultdict, collections.OrderedDict):
            keys = list(node) if kind is collections.OrderedDict else sorted(node)
            aux = node.default_factory if kind is collections.defaultdict else None
            return (kind, aux, tuple(keys), tuple(walk(node[k]) for k in keys))
        if kind in (list, tuple) or _is_namedtuple(node):
            return (kind, None, len(node), tuple(walk(c) for c in node))
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    """Inverse of :func:`tree_flatten` (dicts come back in sorted-key order, as JAX
    rebuilds them)."""
    it = iter(leaves)

    def build(d):
        if d is _LEAF:
            return next(it)
        if d is None:
            return None
        kind, aux, keys, children = d
        values = [build(c) for c in children]
        if kind is collections.defaultdict:
            return collections.defaultdict(aux, zip(keys, values))
        if kind in (dict, collections.OrderedDict):
            return kind(zip(keys, values))
        if kind in (list, tuple):
            return kind(values)
        return kind(*values)  # namedtuple

    try:
        out = build(treedef)
    except StopIteration:
        raise CheckpointError("tree_unflatten: too few leaves for the tree") from None
    if next(it, _LEAF) is not _LEAF:
        raise CheckpointError("tree_unflatten: too many leaves for the tree")
    return out


# -- dtypes and host arrays -----------------------------------------------------


def dtype_name(x: Any) -> str:
    """The reference's name of a dtype, or of a tensor's or array's dtype:
    ``"float32"``, ``"bfloat16"``, ``"float8_e4m3fn"`` (torch's own names for these
    are the reference's)."""
    dt = getattr(x, "dtype", x)
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return _dtype_name(np.dtype(dt))


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"no torch dtype named {name!r}")
    return dt


#: Raw integer dtypes a tagged host array is reinterpreted through, by width.
_RAW_NUMPY = {1: np.uint8, 2: np.int16}
_RAW_TORCH = {1: torch.uint8, 2: torch.int16}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array over the same memory. Dtypes numpy lacks come
    as raw unsigned integers of their width, tagged with their name."""
    name = dtype_name(t)
    if name in RAW_DTYPES:
        return t.view(_RAW_TORCH[t.element_size()]).numpy().view(resolve_dtype(name))
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy host array as a CPU tensor over the same memory (a tagged raw array,
    or the reference's ``ml_dtypes`` array, as its torch dtype). A read-only array
    (a payload read from a file) is shared read-only: copy before writing to it."""
    name = _dtype_name(a.dtype)
    raw = a.view(_RAW_NUMPY[a.itemsize]) if name in RAW_DTYPES else a
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(raw)
    return t.view(torch_dtype(name)) if name in RAW_DTYPES else t


def _is_array(leaf: Any) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray)) and not np.isscalar(leaf)


def leaf_specs(tensors: Sequence[Any]) -> list[dict]:
    """Container-format leaf specs (shape/dtype/nbytes) straight from the tensors'
    metadata — no host copy, no blocking: the pipelined save pickles the header and
    sizes the staging lease before any D2H byte has landed."""
    specs = []
    for t in tensors:
        name = dtype_name(t)
        nbytes = int(np.prod(tuple(t.shape), dtype=np.int64)) * resolve_dtype(name).itemsize
        specs.append({"shape": tuple(t.shape), "dtype": name, "nbytes": nbytes})
    return specs


def host_empty(shape: Sequence[int], dtype: torch.dtype, pin: bool = True) -> torch.Tensor:
    """An uninitialised host tensor, pinned by default; a failed allocation raises
    :class:`CheckpointError`."""
    try:
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=pin)
    except RuntimeError as e:
        kind = "pinned " if pin else ""
        raise CheckpointError(
            f"could not allocate {kind}host memory for {tuple(shape)} {dtype} ({e})"
        ) from e


_side_streams: dict = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream the device-to-host copies of ``device`` run on (one per card)."""
    with _side_lock:
        stream = _side_streams.get(device.index)
        if stream is None:
            stream = _side_streams[device.index] = torch.cuda.Stream(device)
        return stream


# -- the placeholder ------------------------------------------------------------


@dataclasses.dataclass
class TensorPlaceholder:
    """Stands in for a tensor leaf inside a hollow tree.

    Analogue of the reference's ``TensorPlaceholder``
    (``checkpointing/local/basic_state_dict.py:30-54``), extended with the leaf's
    device so the tensor can be restored where it was. Hollow skeletons name this
    class by the JAX package's path (``checkpoint/hollow_pickle.py``), so a container
    written by either package loads in the other.
    """

    shape: tuple
    dtype: str
    index: int
    sharding: Any = None  # torch.device | None; not pickled across hosts

    def __getstate__(self):
        # Devices belong to the saving process; the restore side supplies its own.
        return {
            "shape": self.shape,
            "dtype": self.dtype,
            "index": self.index,
            "sharding": None,
        }

    def __setstate__(self, state):
        for k, v in state.items():
            setattr(self, k, v)


# -- the snapshot ---------------------------------------------------------------


class HostSnapshot:
    """Leaf-by-leaf D2H resolver: the handle the pipelined save's background half
    consumes.

    Created by :meth:`PyTreeStateDict.copy_tensors_to_host_async`. Construction
    snapshots every tensor leaf where it lies, so in-place updates after the call never
    reach the saved bytes: a card leaf by a ``clone`` on the card's current stream,
    followed by one event; a CPU leaf by a copy into a recycled staging buffer when
    ``pool`` holds a released one of this tree's signature
    (:meth:`~tpu_resiliency_torch.checkpoint.staging.HostStagingPool.try_acquire`,
    which neither allocates nor waits), and by a fresh clone otherwise. A buffer is
    released only by :meth:`release`, after the background half is done with every
    leaf, so a foreground copy never lands in one a writer may still read. Without a
    lease from the foreground, the first ``resolve`` (on the background thread)
    acquires one (pinned host memory when a card exists). The first ``resolve``
    enqueues every card leaf's ``non_blocking`` copy into the lease on a side stream
    that waits on the snapshot's event, one event per leaf. ``resolve(i)`` then waits
    only on leaf ``i``'s event, returns the staged host array and drops the device
    snapshot of that leaf, so device memory frees as the pipeline advances.
    Single-consumer: the background writer resolves leaves in order; no internal
    locking.
    """

    def __init__(self, tensors: Sequence[Any], pool: Any = None):
        self.specs = leaf_specs(tensors)
        self.nbytes = sum(s["nbytes"] for s in self.specs)
        self._pool = pool
        host = [isinstance(t, torch.Tensor) and not t.is_cuda for t in tensors]
        self._lease = pool.try_acquire(self.specs) if pool is not None and any(host) else None
        #: Whether the host leaves went into a recycled staging buffer (else clones).
        self.recycled = self._lease is not None
        #: Each leaf's snapshot, ``None`` for a host leaf already in the lease.
        self._tensors: list = []
        for i, t in enumerate(tensors):
            if self.recycled and host[i]:
                self._lease.fill(i, t.detach())
                t = None
            elif isinstance(t, torch.Tensor):
                t = t.detach().clone(memory_format=torch.contiguous_format)
            self._tensors.append(t)
        #: Each leaf's card, or None for a host leaf.
        self._cards = [t.device if isinstance(t, torch.Tensor) and t.is_cuda else None
                       for t in self._tensors]
        #: The card's current stream reaches this event once every snapshot clone ran.
        self._snapshotted = {d: torch.cuda.current_stream(d).record_event()
                             for d in set(self._cards) - {None}}
        self._d2h: dict = {}
        #: The card leaves' copies are enqueued at the first resolve, on the
        #: background thread; without a lease from the foreground, that is also when
        #: the lease is acquired: the foreground never pays the miss-path allocation,
        #: nor blocks when both double-buffer slots are still leased to earlier saves'
        #: background halves.
        self._staged = False
        self._released = False
        self._resolved: list[Optional[np.ndarray]] = [None] * len(self._tensors)

    def __len__(self) -> int:
        return len(self._resolved)

    def _ensure_lease(self):
        if not self._staged and not self._released:
            from tpu_resiliency_torch.checkpoint.staging import StagingLease

            if self._lease is None:
                self._lease = (
                    self._pool.acquire(self.specs) if self._pool is not None
                    else StagingLease.unpooled(self.specs)
                )
            lease = self._lease
            for device, event in self._snapshotted.items():
                side = _side_stream(device)
                side.wait_event(event)
                self._d2h[device] = (side.record_event(torch.cuda.Event(enable_timing=True)),
                                     torch.cuda.Event(enable_timing=True))
            for i, t in enumerate(self._tensors):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    with torch.cuda.stream(_side_stream(t.device)):
                        lease.fill(i, t)
                elif t is not None:
                    lease.fill(i, t)
            for device, (_, end) in self._d2h.items():
                end.record(_side_stream(device))
            self._staged = True
        return self._lease

    def resolve(self, i: int) -> np.ndarray:
        """Materialize leaf ``i`` on host (blocking only on ITS transfer)."""
        out = self._resolved[i]
        if out is None:
            lease = self._ensure_lease()
            if lease is None:
                raise CheckpointError("snapshot resolved after its release")
            lease.wait(i)
            out = to_numpy(lease.views[i])
            self._resolved[i] = out
            self._tensors[i] = None
        return out

    def resolve_view(self, i: int) -> memoryview:
        """Leaf ``i`` as the flat uint8 window writers and senders consume."""
        self.resolve(i)
        return self._lease.raw_views[i]

    def resolve_all(self) -> list[np.ndarray]:
        return [self.resolve(i) for i in range(len(self))]

    def __iter__(self):
        for i in range(len(self)):
            yield self.resolve(i)

    def _record_d2h(self) -> None:
        """One ``ckpt.save.d2h`` timing event per card: the device time from the side
        stream's first copy to its last (the materialized path's span of that name
        holds its blocking copy)."""
        for device, (start, end) in self._d2h.items():
            end.synchronize()
            nbytes = sum(s["nbytes"] for s, t in zip(self.specs, self._cards) if t == device)
            record_event("checkpoint", "timing", name="ckpt.save.d2h", ok=True,
                         duration_s=start.elapsed_time(end) / 1e3, bytes=nbytes,
                         device=str(device), engine="pipelined")
        self._d2h = {}

    def release(self) -> None:
        """Return the staging lease to its pool (idempotent). Call only after
        every consumer (file writer, peer sends) is done with the views. Copies
        still in flight are waited for first: no copy may land in a buffer the
        pool hands out again, nor read a device snapshot the allocator reuses."""
        self._released = True
        if self._lease is not None:
            self._lease.wait_all()
            self._record_d2h()
            self._lease.release()
            self._lease = None
        # The staged views belong to the pool again: none may be handed out.
        self._tensors = [None] * len(self._tensors)
        self._resolved = [None] * len(self._resolved)


# -- the state dict -------------------------------------------------------------


class PyTreeStateDict:
    """A tree with pop/insert tensor semantics for local checkpointing.

    Contract (mirrors reference ``base_state_dict.py:29-115``):

    - ``pop_tensors()`` → list of tensor leaves; ``self`` becomes hollow (picklable).
    - ``insert_tensors(tensors)`` → re-inflates the hollow skeleton.
    - ``copy_tensors_to_host()`` → payload becomes host numpy (pinned copies, one wait).
    - ``restore_tensor_device(shardings=...)`` → payload becomes torch tensors again.
    - ``tree`` → the underlying tree (hollow or full).
    """

    def __init__(self, tree: Any):
        self._tree = tree
        self._hollow = False
        self._tensors: Optional[list] = None
        self._shardings: Optional[list] = None

    @classmethod
    def from_hollow(
        cls,
        hollow_tree: Any,
        tensors: Sequence[Any],
        shardings: Optional[Sequence[Any]] = None,
        device: Any = None,
    ) -> "PyTreeStateDict":
        """Rebuild a full state dict from a loaded (hollow skeleton, payload) pair,
        placing tensors on ``device`` (``None`` means the CUDA card) — the standard
        restore path after ``LocalCheckpointManager.load`` / ``ckpt_format.read_payload``."""
        sd = cls.__new__(cls)
        sd._tree = hollow_tree
        sd._hollow = True
        sd._tensors = list(tensors)
        sd._shardings = None
        sd.restore_tensor_device(shardings=shardings, device=device)
        sd.insert_tensors(sd._tensors)
        return sd

    # -- introspection -----------------------------------------------------

    @property
    def is_hollow(self) -> bool:
        return self._hollow

    @property
    def tree(self) -> Any:
        if self._hollow:
            raise CheckpointError("state dict is hollow; insert_tensors() first")
        return self._tree

    @property
    def hollow_tree(self) -> Any:
        if not self._hollow:
            raise CheckpointError("state dict is not hollow; pop_tensors() first")
        return self._tree

    def tensors(self) -> list:
        if self._tensors is None:
            raise CheckpointError("tensors were not popped")
        return self._tensors

    # -- pop / insert ------------------------------------------------------

    def pop_tensors(self) -> list:
        """Replace every tensor leaf with a placeholder; return the tensors in order."""
        if self._hollow:
            raise CheckpointError("pop_tensors() on an already-hollow state dict")
        leaves, treedef = tree_flatten(self._tree)
        tensors: list = []
        hollow_leaves: list = []
        for leaf in leaves:
            if _is_array(leaf):
                hollow_leaves.append(
                    TensorPlaceholder(
                        shape=tuple(leaf.shape),
                        dtype=dtype_name(leaf),
                        index=len(tensors),
                        sharding=leaf.device if isinstance(leaf, torch.Tensor) else None,
                    )
                )
                tensors.append(leaf)
            else:
                hollow_leaves.append(leaf)
        self._tree = tree_unflatten(treedef, hollow_leaves)
        self._tensors = tensors
        self._hollow = True
        return tensors

    def insert_tensors(self, tensors: Sequence[Any]) -> None:
        """Inverse of :meth:`pop_tensors`."""
        if not self._hollow:
            raise CheckpointError("insert_tensors() on a non-hollow state dict")
        leaves, treedef = tree_flatten(
            self._tree, is_leaf=lambda x: isinstance(x, TensorPlaceholder)
        )
        n_ph = sum(isinstance(leaf, TensorPlaceholder) for leaf in leaves)
        if n_ph != len(tensors):
            raise CheckpointError(f"expected {n_ph} tensors, got {len(tensors)}")
        bad = [
            leaf.index
            for leaf in leaves
            if isinstance(leaf, TensorPlaceholder)
            and not 0 <= leaf.index < len(tensors)
        ]
        if bad:
            raise CheckpointError(
                f"hollow skeleton placeholder index(es) {sorted(bad)} out of "
                f"range for {len(tensors)} tensors (corrupt skeleton?)"
            )
        full = [
            tensors[leaf.index] if isinstance(leaf, TensorPlaceholder) else leaf
            for leaf in leaves
        ]
        self._tree = tree_unflatten(treedef, full)
        self._tensors = list(tensors)
        self._hollow = False

    # -- device movement ---------------------------------------------------

    def copy_tensors_to_host(self) -> None:
        """The blocking copy: every card leaf goes ``non_blocking`` into its own pinned
        buffer, all copies queued before one wait; a CPU tensor is cloned; numpy
        arrays stay. The payload becomes host numpy, the devices are recorded."""
        if self._tensors is None:
            raise CheckpointError("pop_tensors() before copy_tensors_to_host()")
        self._shardings = [
            t.device if isinstance(t, torch.Tensor) else None for t in self._tensors
        ]
        host: list = []
        cards: set = set()
        for t in self._tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                dst = host_empty(t.shape, t.dtype)
                try:
                    dst.copy_(t.detach(), non_blocking=True)
                except RuntimeError as e:
                    raise CheckpointError(f"device-to-host copy failed ({e})") from e
                cards.add(t.device)
                host.append(dst)
            elif isinstance(t, torch.Tensor):
                host.append(t.detach().clone(memory_format=torch.contiguous_format))
            else:
                host.append(np.asarray(t))
        for device in cards:
            torch.cuda.current_stream(device).synchronize()
        self._tensors = [to_numpy(h) if isinstance(h, torch.Tensor) else h for h in host]

    def copy_tensors_to_host_async(self, pool: Any = None) -> HostSnapshot:
        """Non-blocking counterpart of :meth:`copy_tensors_to_host`: snapshot every
        leaf and return a :class:`HostSnapshot` whose background half copies the
        snapshot to pinned host memory leaf by leaf.

        The caller-visible cost is enqueue: one device ``clone`` per card leaf on the
        current stream and one event, no host synchronize, and one host copy per CPU
        leaf. ``pool`` (a
        :class:`~tpu_resiliency_torch.checkpoint.staging.HostStagingPool`) stages the
        leaves into recycled pinned buffers so steady-state saves allocate nothing
        large: the CPU leaves are copied straight into a released lease when the pool
        holds one, else cloned and the lease is acquired lazily at first resolve (on
        the background thread); the snapshot owns it — ``release()`` when the
        background half is done. ``self`` keeps its tensors untouched (devices are
        recorded for a later restore)."""
        if self._tensors is None:
            raise CheckpointError("pop_tensors() before copy_tensors_to_host_async()")
        self._shardings = [
            t.device if isinstance(t, torch.Tensor) else None for t in self._tensors
        ]
        return HostSnapshot(self._tensors, pool=pool)

    def _align_shardings_pytree(self, shardings) -> list:
        """Flatten a device tree that mirrors the saved tree's structure into a flat
        list aligned with the popped tensor order. Non-tensor leaves in the saved
        tree (e.g. a step counter) are allowed: their entries are ignored."""
        # None must count as a leaf on BOTH sides: in the saved tree it may be an
        # optional field, in the device tree it means "default placement".
        is_ph = lambda x: isinstance(x, TensorPlaceholder) or x is None  # noqa: E731
        tree_leaves, tree_def = tree_flatten(self._tree, is_leaf=is_ph)
        sh_leaves, sh_def = tree_flatten(shardings, is_leaf=lambda x: x is None)
        if len(sh_leaves) != len(tree_leaves) or sh_def != tree_def:
            raise CheckpointError(
                f"shardings tree does not mirror the saved tree — pass a tree "
                f"with a device/None at each saved-tree leaf, or a flat "
                f"per-tensor sequence.\n  shardings: {len(sh_leaves)} leaves\n"
                f"  saved tree: {len(tree_leaves)} leaves"
            )
        out: list = [None] * len(self._tensors)
        cursor = 0  # full-tree case: tensors appear in tree order == pop order
        for leaf, s in zip(tree_leaves, sh_leaves):
            if isinstance(leaf, TensorPlaceholder):
                out[leaf.index] = s
            elif _is_array(leaf):
                out[cursor] = s
                cursor += 1
        return out

    def restore_tensor_device(
        self,
        shardings: Optional[Sequence[Any]] = None,
        device: Any = None,
    ) -> None:
        """Place the payload as torch tensors (per-leaf device > ``device`` > the card).

        ``shardings`` may be a flat sequence of ``torch.device``/``None`` (aligned with
        the popped tensor list) OR a tree mirroring the saved tree's structure with a
        device or ``None`` at each leaf. ``device=None`` means the CUDA card, and
        raises without one."""
        if self._tensors is None:
            raise CheckpointError("no tensors to restore")
        target = shardings if shardings is not None else self._shardings
        # The reference's interpretation order for a list/tuple of placements:
        # flat per-tensor when the length matches, else a mirrored tree, else the
        # legacy flat prefix form (the tail gets default placement).
        if target is not None and not isinstance(target, (list, tuple)):
            target = self._align_shardings_pytree(target)
        elif target is not None:
            all_placement = all(s is None or isinstance(s, torch.device) for s in target)
            if not (all_placement and len(target) == len(self._tensors)):
                try:
                    target = self._align_shardings_pytree(target)
                except CheckpointError:
                    if not all_placement:
                        raise
        default = None
        out = []
        for i, t in enumerate(self._tensors):
            s = target[i] if target is not None and i < len(target) else None
            if s is None:
                if default is None:
                    default = resolve_device(device)
                s = default
            out.append(_place(t, torch.device(s)))
        self._tensors = out
        if self._hollow:
            return
        # Payload already re-inserted: rebuild the tree with the placed tensors.
        self.insert_if_full()

    def insert_if_full(self) -> None:
        if not self._hollow and self._tensors is not None:
            tensors = self._tensors
            self.pop_tensors()
            self.insert_tensors(tensors)


def _place(t: Any, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a tensor on ``device``, owning its memory when it
    came from a read-only buffer."""
    if isinstance(t, torch.Tensor):
        return t.to(device)
    a = np.asarray(t)
    if device.type == "cpu" and not a.flags.writeable:
        a = a.copy()
    return from_numpy(a).to(device)


def split_tree(tree: Any) -> tuple[PyTreeStateDict, list]:
    """Convenience: wrap + pop in one call. Returns (hollow wrapper, tensors)."""
    sd = PyTreeStateDict(tree)
    tensors = sd.pop_tensors()
    return sd, tensors


def tree_size_bytes(tensors: Sequence[Any]) -> int:
    return sum(s["nbytes"] for s in leaf_specs(tensors))


def sync_placeholder_shapes(hollow_tree: Any, tensors: Sequence[Any]) -> Any:
    """Update a hollow skeleton's placeholders to the ACTUAL payload geometry.

    After an elastic reshard (``local_manager.load_resharded``) the loaded
    skeleton's placeholders still describe the SAVING world's local blocks; the
    reassembled tensors are the TARGET world's. In-place on the placeholders;
    returns ``hollow_tree`` for chaining."""
    leaves = tree_flatten(hollow_tree, is_leaf=lambda x: isinstance(x, TensorPlaceholder))[0]
    for leaf in leaves:
        if isinstance(leaf, TensorPlaceholder) and 0 <= leaf.index < len(tensors):
            t = tensors[leaf.index]
            leaf.shape = tuple(t.shape)
            leaf.dtype = dtype_name(t)
    return hollow_tree


def make_restore_shardings(
    hollow: Any, spec_fn: Callable[[TensorPlaceholder], Any]
) -> list:
    """Build a device list for ``restore_tensor_device`` from a hollow skeleton."""
    leaves = tree_flatten(hollow, is_leaf=lambda x: isinstance(x, TensorPlaceholder))[0]
    placeholders = [leaf for leaf in leaves if isinstance(leaf, TensorPlaceholder)]
    placeholders.sort(key=lambda p: p.index)
    return [spec_fn(p) for p in placeholders]
