"""The port's tensor-aware state dict, container format and whole-tree checkpointer
(``tpu_resiliency_torch.checkpoint``: ``state_dict``, ``format``, ``async_ckpt``)
held against the JAX package's (``tests/checkpoint/test_state_dict.py``).

The same seeded tree goes through both packages: JAX CPU arrays into the reference,
CPU tensors with ``device="cpu"`` into the port. Leaf order must equal
``jax.tree_util.tree_flatten``'s, hollow skeletons and container files must be
byte-identical (bf16 compared as int16), and a container written by either package
must load in the other with equal values.
"""

import collections
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import Pair, bits, make_tree, packages, same_bits
from tpu_resiliency.checkpoint.async_ckpt import AsyncCheckpointer as RefCheckpointer
from tpu_resiliency.checkpoint.state_dict import PyTreeStateDict as RefStateDict
from tpu_resiliency.exceptions import CheckpointError as RefCheckpointError
from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint import hollow_pickle
from tpu_resiliency_torch.checkpoint.async_ckpt import AsyncCheckpointer
from tpu_resiliency_torch.checkpoint.state_dict import (
    PyTreeStateDict,
    TensorPlaceholder,
    from_numpy,
    leaf_specs,
    to_numpy,
    tree_flatten,
    tree_unflatten,
)
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()

#: Trees whose leaf order the flatten must share with ``jax.tree_util``.
ORDER_TREES = {
    "issue": {"b": 1, "a": (2, None), "c": [3]},
    "nested_unsorted": {"z": {"d": 1, "b": {"y": 2, "x": 3}}, "a": [4, {"q": 5, "p": 6}]},
    "none_everywhere": {"k": None, "j": [None, 1, (None, 2)], "i": {"n": None}},
    "tuples": ((3, 2), (1,), ()),
    "namedtuple": Pair(zulu={"b": 1, "a": 2}, alpha=(3, None)),
    "ordered": collections.OrderedDict([("z", 1), ("a", {"d": 2, "c": 3})]),
    "defaultdict": collections.defaultdict(int, {"b": 1, "a": [2, 3]}),
    "empty": {"a": [], "b": {}, "c": ()},
    "leaf": 5,
    "none": None,
}


@pytest.mark.parametrize("name", sorted(ORDER_TREES))
def test_leaf_order_equals_jax_tree_util(name):
    tree = ORDER_TREES[name]
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_flatten(tree)[0]
    rebuilt = tree_unflatten(treedef, leaves)
    assert rebuilt == jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree), leaves)
    assert type(rebuilt) is type(tree)


def test_leaf_order_with_is_leaf_equals_jax():
    tree = {"b": None, "a": [None, 1]}
    is_none = lambda x: x is None  # noqa: E731
    assert tree_flatten(tree, is_leaf=is_none)[0] == jax.tree_util.tree_flatten(
        tree, is_leaf=is_none)[0]
    assert tree_flatten(tree)[1] == tree_flatten({"a": [None, 9], "b": None})[1]
    assert tree_flatten(tree)[1] != tree_flatten({"a": [9, None], "b": None})[1]


def test_the_issue_tree_differs_under_torch_pytree():
    """The trap the flatten avoids: torch's own pytree keeps insertion order and
    counts ``None`` as a leaf."""
    import torch.utils._pytree as torch_pytree

    tree = ORDER_TREES["issue"]
    assert torch_pytree.tree_flatten(tree)[0] == [1, 2, None, 3]
    assert tree_flatten(tree)[0] == [2, 1, 3]


@pytest.mark.parametrize("seed", [0, 1])
def test_pop_gives_the_references_placeholders_and_skeleton_bytes(seed):
    ref = RefStateDict(make_tree(seed, "jax"))
    port = PyTreeStateDict(make_tree(seed, "torch"))
    ref_tensors, port_tensors = ref.pop_tensors(), port.pop_tensors()
    assert len(ref_tensors) == len(port_tensors) == 7
    for a, b in zip(ref_tensors, port_tensors):
        assert same_bits(a, b)
    is_ph = lambda x: type(x).__name__ == "TensorPlaceholder"  # noqa: E731
    ref_ph = [x for x in jax.tree_util.tree_leaves(ref.hollow_tree, is_leaf=is_ph) if is_ph(x)]
    port_ph = [x for x in tree_flatten(port.hollow_tree, is_leaf=is_ph)[0] if is_ph(x)]
    assert [(p.shape, p.dtype, p.index) for p in port_ph] == [
        (p.shape, p.dtype, p.index) for p in ref_ph]
    assert "bfloat16" in [p.dtype for p in port_ph]
    # The skeleton pickles to the reference's bytes: same structure, same wire name.
    assert hollow_pickle.dumps(port.hollow_tree) == pickle.dumps(
        ref.hollow_tree, protocol=pickle.HIGHEST_PROTOCOL)
    assert pickle.loads(hollow_pickle.dumps(port.hollow_tree)) is not None
    restored = hollow_pickle.loads(pickle.dumps(ref.hollow_tree))
    assert [type(x) for x in tree_flatten(restored, is_leaf=is_ph)[0] if is_ph(x)] == [
        TensorPlaceholder] * 7


def test_leaf_specs_and_host_views_carry_the_reference_dtype_names():
    tensors = PyTreeStateDict(make_tree(0, "torch")).pop_tensors()
    ref_tensors = RefStateDict(make_tree(0, "jax")).pop_tensors()
    from tpu_resiliency.checkpoint.state_dict import leaf_specs as ref_leaf_specs

    assert leaf_specs(tensors) == ref_leaf_specs(ref_tensors)
    bf = next(t for t in tensors if t.dtype == torch.bfloat16)
    host = to_numpy(bf)
    assert ckpt_format._dtype_name(host.dtype) == "bfloat16" and host.itemsize == 2
    assert torch.equal(from_numpy(host), bf)
    assert from_numpy(np.asarray(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))).dtype \
        == torch.bfloat16


def test_host_copy_and_device_restore():
    tree = make_tree(2, "torch")
    sd = PyTreeStateDict(tree)
    sd.pop_tensors()
    sd.copy_tensors_to_host()
    assert all(isinstance(t, np.ndarray) for t in sd.tensors())
    sd.restore_tensor_device(device="cpu")
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in sd.tensors())
    sd.insert_tensors(sd.tensors())
    assert same_bits(sd.tree["zeta"]["bias"], tree["zeta"]["bias"])
    assert sd.tree["mid"].alpha[1] == 3 and isinstance(sd.tree["mid"], Pair)


def test_restore_without_a_card_raises_and_records_devices():
    sd = PyTreeStateDict({"w": torch.ones(3)})
    sd.pop_tensors()
    sd.copy_tensors_to_host()
    sd.restore_tensor_device()  # the recorded device: the CPU, where it came from
    assert sd.tensors()[0].device.type == "cpu"
    hollow = PyTreeStateDict({"w": torch.ones(3)})
    tensors = [t.numpy() for t in hollow.pop_tensors()]
    if torch.cuda.is_available():
        placed = PyTreeStateDict.from_hollow(hollow.hollow_tree, tensors)
        assert placed.tree["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PyTreeStateDict.from_hollow(hollow.hollow_tree, tensors)


@pytest.mark.parametrize("case", ["double_pop", "wrong_count", "bad_index"])
def test_misuse_raises_as_the_reference(case):
    def run(cls, tree, err):
        sd = cls(tree)
        sd.pop_tensors()
        if case == "double_pop":
            with pytest.raises(err):
                sd.pop_tensors()
        elif case == "wrong_count":
            with pytest.raises(err, match="expected 1 tensors, got 2"):
                sd.insert_tensors([np.zeros(1), np.zeros(1)])
        else:
            ph = sd.hollow_tree["w"]
            ph.index = 5
            with pytest.raises(err, match="out of range"):
                sd.insert_tensors([np.zeros(1)])

    run(RefStateDict, {"w": jnp.ones(1), "n": 2}, RefCheckpointError)
    run(PyTreeStateDict, {"w": torch.ones(1), "n": 2}, CheckpointError)


def test_non_array_leaves_preserved():
    for cls in (RefStateDict, PyTreeStateDict):
        sd = cls({"a": 1, "b": "x", "c": None})
        assert sd.pop_tensors() == []
        sd.insert_tensors([])
        assert sd.tree == {"a": 1, "b": "x", "c": None}


def test_shardings_tree_mirrors_the_saved_tree():
    sd = PyTreeStateDict({"b": torch.ones(2), "a": [torch.zeros(1), 3], "n": None})
    tensors = [t.numpy() for t in sd.pop_tensors()]
    cpu = torch.device("cpu")
    placed = PyTreeStateDict.from_hollow(sd.hollow_tree, tensors,
                                         shardings={"a": [cpu, None], "b": cpu, "n": None},
                                         device="cpu")
    assert placed.tree["a"][1] == 3 and placed.tree["b"].device == cpu
    with pytest.raises(CheckpointError, match="does not mirror"):
        PyTreeStateDict.from_hollow(sd.hollow_tree, tensors, shardings={"a": [cpu]},
                                    device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_container_files_are_byte_identical(tmp_path, seed):
    """The blocking save of both packages on the same tree writes the same bytes."""
    ref_path, port_path = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    RefCheckpointer().save(make_tree(seed, "jax"), ref_path, meta={"it": seed})
    AsyncCheckpointer().save(make_tree(seed, "torch"), port_path, meta={"it": seed})
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    _, tensors, _ = ckpt_format.read_payload(port_path)
    bf = [t for t in tensors if ckpt_format._dtype_name(t.dtype) == "bfloat16"]
    assert len(bf) == 1 and bf[0].dtype.itemsize == 2


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_containers_load_across_the_packages(tmp_path, writer):
    path = str(tmp_path / "x.ckpt")
    want = make_tree(4, "torch")
    if writer == "ref":
        ckpt = RefCheckpointer()
        ckpt.async_save(make_tree(4, "jax"), path, meta={"iteration": 4})
    else:
        ckpt = AsyncCheckpointer()
        ckpt.async_save(make_tree(4, "torch"), path, meta={"iteration": 4})
    ckpt.finalize_all()
    ckpt.close()
    port_tree, port_meta = AsyncCheckpointer.load(path, device="cpu")
    ref_tree, ref_meta = RefCheckpointer.load(path)
    assert port_meta == ref_meta == {"iteration": 4}
    want_leaves = tree_flatten(want)[0]
    for got in (tree_flatten(port_tree)[0], jax.tree_util.tree_flatten(ref_tree)[0]):
        assert len(got) == len(want_leaves)
        for g, w in zip(got, want_leaves):
            if isinstance(w, torch.Tensor):
                assert same_bits(g, w)
            else:
                assert g == w
    assert port_tree["zeta"]["bias"].dtype == torch.bfloat16
    assert isinstance(port_tree["mid"], Pair) and isinstance(port_tree["ordered"],
                                                             collections.OrderedDict)


def test_async_save_roundtrip_and_changed_scalars(tmp_path):
    ckpt = AsyncCheckpointer()
    tree = make_tree(5, "torch")
    ckpt.async_save(tree, str(tmp_path / "a.ckpt"), meta={"iteration": 11})
    ckpt.finalize_all()
    ckpt.async_save(dict(tree, step=9999), str(tmp_path / "b.ckpt"))
    ckpt.finalize_all()
    loaded, meta = AsyncCheckpointer.load(str(tmp_path / "a.ckpt"), device="cpu")
    assert meta["iteration"] == 11 and loaded["step"] == 7
    assert same_bits(loaded["zeta"]["w"], tree["zeta"]["w"])
    assert AsyncCheckpointer.load(str(tmp_path / "b.ckpt"), device="cpu")[0]["step"] == 9999
    ckpt.close()


def test_separation_hint_splits_as_the_reference(tmp_path):
    """``_split_hollow`` re-indexes each part on the port's flatten: the routed and
    main files hold the reference's leaves, and the merged load equals the tree."""
    for name, cls, lib in (("ref", RefCheckpointer, "jax"), ("port", AsyncCheckpointer, "torch")):
        ckpt = cls()
        ckpt.async_save(make_tree(6, lib), str(tmp_path / f"{name}.ckpt"), meta={"it": 6},
                        separation_hint="zeta")
        ckpt.finalize_all()
        ckpt.close()
    for part in ("ref.ckpt", "ref.zeta.*.ckpt"):
        ref_file = next(tmp_path.glob(part))
        port_file = next(tmp_path.glob(part.replace("ref", "port")))
        _, ref_t, _ = PKG["ref"].format.read_payload(str(ref_file))
        _, port_t, _ = ckpt_format.read_payload(str(port_file))
        assert [bits(t).tobytes() for t in ref_t] == [bits(t).tobytes() for t in port_t]
    merged, meta = AsyncCheckpointer.load(str(tmp_path / "port.ckpt"), device="cpu",
                                          separation_hint="zeta")
    assert meta == {"it": 6}
    want = make_tree(6, "torch")
    assert same_bits(merged["zeta"]["bias"], want["zeta"]["bias"])
    assert same_bits(merged["alpha"][2], want["alpha"][2])


def test_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "c.ckpt")
    AsyncCheckpointer().save({"w": torch.ones(2)}, path)
    if torch.cuda.is_available():
        assert AsyncCheckpointer.load(path)[0]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncCheckpointer.load(path)
    assert AsyncCheckpointer.load(path, device="cpu")[0]["w"].device.type == "cpu"
