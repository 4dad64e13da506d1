"""The port's elastic reshard (``checkpoint/reshard.py`` and the manager's
``load_resharded``) held against the JAX package's (``tests/checkpoint/test_reshard.py``).

The plan algebra is a copy: on the same seeded layouts it must build the same plans
and the N→M→N round trip must be byte-identical in both packages. ``for_local_tree``
runs on the port's flatten, so its leaves follow JAX's sorted-key order on a torch
tree. End to end, a world of the port shrinks, saves at its own layout and grows
back, byte-identical, and a one-rank load of a two-rank checkpoint (own shard plus
mirror on one disk) equals the concatenation, as ``chip_smoke.py`` checks on the card.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import World, packages, run_ranks
from tpu_resiliency_torch.checkpoint import reshard as R
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.state_dict import (
    PyTreeStateDict,
    TensorPlaceholder,
    tree_flatten,
)
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()
GLOBAL = np.arange(24 * 6, dtype=np.float32).reshape(24, 6)


def _mem_read(locals_by_rank):
    def read(owner, leaf, off, n):
        flat = np.asarray(locals_by_rank[owner][leaf]).reshape(-1).view(np.uint8)
        return flat[off:off + n].tobytes()

    return read


def _random_case(mod, seed):
    """The reference's random case (``TestPlanAlgebra._random_case``), built with
    ``mod``'s layout classes."""
    rng = np.random.default_rng(seed)
    worlds = [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (6, 1), (2, 3), (1, 2)]
    src_axes = list(zip(["dp", "tp"], worlds[rng.integers(0, len(worlds))]))
    tgt_axes = list(zip(["dp", "tp"], worlds[rng.integers(0, len(worlds))]))
    n = int(np.prod([s for _, s in src_axes]))
    m = int(np.prod([s for _, s in tgt_axes]))
    leaves, arrays = [], []
    for _ in range(int(rng.integers(1, 4))):
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(2, 13)) for _ in range(ndim))
        options: list = [None, "dp", "tp"]
        spec_raw = [options[rng.integers(0, 3)] for _ in range(ndim)]
        seen: set = set()
        spec = tuple(a if a is None or (a not in seen and not seen.add(a)) else None
                     for a in spec_raw)
        leaves.append(mod.LeafSpec(shape, "float32", spec))
        arrays.append(rng.standard_normal(shape).astype(np.float32))
    return (mod.TreeLayout(src_axes, list(range(n)), leaves),
            mod.TreeLayout(tgt_axes, list(range(m)), leaves), arrays)


def _round_trip(mod, seed):
    src, tgt, arrays = _random_case(mod, seed)
    plan = mod.build_plan(src, tgt)
    locals_src = {r: mod.slice_local(arrays, src, r) for r in src.ranks}
    locals_tgt = {r: mod.assemble_rank(plan, r, _mem_read(locals_src)) for r in tgt.ranks}
    back = mod.build_plan(tgt, src)
    locals_rt = {r: mod.assemble_rank(back, r, _mem_read(locals_tgt)) for r in src.ranks}
    return ({r: [a.tobytes() for a in v] for r, v in locals_src.items()},
            {r: [a.tobytes() for a in v] for r, v in locals_tgt.items()},
            {r: [a.tobytes() for a in v] for r, v in locals_rt.items()},
            (plan.direction, back.direction))


@pytest.mark.parametrize("seed", range(10))
def test_n_m_n_round_trip_is_byte_identical_and_equals_the_references(seed):
    port = _round_trip(R, seed)
    assert port == _round_trip(PKG["ref"].reshard, seed)
    src_bytes, _, rt_bytes, _ = port
    assert rt_bytes == src_bytes


def test_for_local_tree_follows_jax_order_on_a_torch_tree():
    """Leaves in sorted-key order (not insertion order), non-tensor leaves skipped,
    bf16 named as the reference names it; the layout's meta equals the reference's
    for the same tree as JAX arrays."""
    v = np.ones((4, 3), np.float32)
    torch_tree = {"z": torch.ones((2, 5)), "step": 7, "a": torch.from_numpy(v),
                  "m": torch.ones((6,), dtype=torch.bfloat16)}
    jax_tree = {"z": jnp.ones((2, 5)), "step": 7, "a": jnp.asarray(v),
                "m": jnp.ones((6,), jnp.bfloat16)}
    specs = {"z": (None, "tp"), "step": None, "a": ("dp",), "m": None}
    axes = {"tp": 2, "dp": 2}
    port = R.TreeLayout.for_local_tree(torch_tree, specs, axes, [0, 1, 2, 3])
    ref = PKG["ref"].reshard.TreeLayout.for_local_tree(jax_tree, specs, axes, [0, 1, 2, 3])
    assert port.to_meta() == ref.to_meta()
    assert [l.global_shape for l in port.leaves] == [(8, 3), (6,), (2, 10)]
    assert [l.dtype for l in port.leaves] == ["float32", "bfloat16", "float32"]
    popped = PyTreeStateDict(dict(torch_tree)).pop_tensors()
    assert [tuple(t.shape) for t in popped] == [(4, 3), (6,), (2, 5)]
    with pytest.raises(CheckpointError, match="spec tree has"):
        R.TreeLayout.for_local_tree(torch_tree, {"a": ("dp",)}, axes, [0, 1, 2, 3])


def _save_world(side, root, layout, it=1, step=11, data=GLOBAL):
    w = World(PKG[side])

    def body(rank):
        mgr, ex = w.manager(root, rank, layout.ranks)
        try:
            block = PKG[side].reshard.slice_local([data], layout, rank)[0]
            leaf = jnp.asarray(block) if side == "ref" else torch.from_numpy(block.copy())
            mgr.save(it, PKG[side].sd.PyTreeStateDict({"w": leaf, "step": step}),
                     is_async=False, layout=layout)
        finally:
            mgr.close()
            ex.close()

    try:
        run_ranks(list(layout.ranks), body)
    finally:
        w.close()


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_shrink_save_and_grow_are_byte_identical(tmp_path, saver):
    """4 ranks save (either package); 3 port ranks reshard with rank 3's state from
    its mirror and save at their own layout; 4 port ranks grow back with rank 3's
    disk wiped. Every block equals the global array's."""
    root = str(tmp_path / "ckpt")
    src = R.TreeLayout([("dp", 4)], [0, 1, 2, 3], [R.LeafSpec(GLOBAL.shape, "float32", ("dp",))])
    _save_world(saver, root, src)
    tgt3 = src.retarget([0, 1, 2])
    w = World(PKG["port"])

    def shrink_and_save(rank):
        mgr, ex = w.manager(root, rank, [0, 1, 2], gen=1, keep=2)
        try:
            hollow, tensors, meta = mgr.load_resharded()
            resumed = torch.from_numpy(np.asarray(tensors[0]).copy())
            layout = R.TreeLayout.from_meta(meta["layout"])
            mgr.save(2, PyTreeStateDict({"w": resumed, "step": 12}), is_async=False,
                     layout=layout)
            return hollow["step"], resumed.numpy().tobytes(), meta["layout"]["ranks"]
        finally:
            mgr.close()
            ex.close()

    try:
        out = run_ranks([0, 1, 2], shrink_and_save)
    finally:
        w.close()
    for rank, (step, block, ranks) in zip([0, 1, 2], out):
        assert step == 11 and ranks == [0, 1, 2]
        assert block == R.slice_local([GLOBAL], tgt3, rank)[0].tobytes()

    shutil.rmtree(os.path.join(root, "s0", "r3"))
    w = World(PKG["port"])

    def grow(rank):
        mgr, ex = w.manager(root, rank, [0, 1, 2, 3], gen=2)
        try:
            tree, meta = mgr.load_resharded_tree(device="cpu")
            return tree["step"], tree["w"].numpy().tobytes(), meta["iteration"]
        finally:
            mgr.close()
            ex.close()

    try:
        grown = run_ranks([0, 1, 2, 3], grow)
    finally:
        w.close()
    assert grown == [(12, R.slice_local([GLOBAL], src, r)[0].tobytes(), 2) for r in range(4)]


def test_one_rank_load_of_two_ranks_equals_their_concatenation(tmp_path):
    """A two-rank checkpoint whose containers both sit on rank 0's disk (own shard +
    mirror) loads on one rank with no network, placeholders synced to the target's
    shapes, and the tree equals the concatenation of the two blocks."""
    root = str(tmp_path / "ckpt")
    data = GLOBAL[:8, :4].copy()
    src = R.TreeLayout([("dp", 2)], [0, 1], [R.LeafSpec(data.shape, "float32", ("dp",))])
    _save_world("port", root, src, data=data)
    mgr = LocalCheckpointManager(root, rank=0, comm=None)
    hollow, tensors, meta = mgr.load_resharded()
    phs = [x for x in tree_flatten(hollow, is_leaf=lambda x: isinstance(x, TensorPlaceholder))[0]
           if isinstance(x, TensorPlaceholder)]
    assert [p.shape for p in phs] == [(8, 4)]
    tree, meta2 = mgr.load_resharded_tree(device="cpu")
    blocks = [R.slice_local([data], src, r)[0] for r in (0, 1)]
    assert tree["step"] == 11 and meta2["layout"]["ranks"] == [0]
    assert torch.equal(tree["w"], torch.from_numpy(np.concatenate(blocks)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.load_resharded_tree()
    mgr.close()


def test_save_rejects_a_layout_in_insertion_order(tmp_path):
    """The classic mistake the sorted-key order invites: layout leaves listed in
    insertion order fail at save time, as in the reference."""
    tree = {"z": torch.zeros((4, 2)), "a": torch.zeros((3,))}
    wrong = R.TreeLayout([("dp", 1)], [0], [R.LeafSpec((4, 2), "float32", (None, None)),
                                            R.LeafSpec((3,), "float32", (None,))])
    mgr = LocalCheckpointManager(str(tmp_path), rank=0)
    with pytest.raises(CheckpointError, match="sorted-key"):
        mgr.save(1, PyTreeStateDict(tree), is_async=False, layout=wrong)
    right = R.TreeLayout.for_local_tree(tree, {"z": None, "a": None}, {"dp": 1}, [0])
    mgr.save(1, PyTreeStateDict(tree), is_async=False, layout=right)
    mgr.close()
