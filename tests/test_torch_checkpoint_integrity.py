"""The port's integrity plane (the v2/v3 container checks of ``checkpoint/format.py``
and the manager's recovery ladder) held against the JAX package's
(``tests/checkpoint/test_integrity.py``).

Each scenario damages the same bytes of the same seeded containers in a world of
each package and must end the same way: the same verdicts and errors, the same
recovered iteration and bytes. The chaos-disk bitflip and the cold tier's torn
upload are left out: the reference's own tests of those fail on the CPU.
"""

import os
import pickle
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import World, packages, run_ranks
from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint.local_manager import CkptID, LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict, TensorPlaceholder
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()


def _arrays():
    rng = np.random.default_rng(11)
    return [rng.standard_normal(256).astype(np.float32), np.ones((3, 5), dtype=np.int32)]


def _flip(path, offset, mask=0x10):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ mask]))


def _outcome(fmt, path):
    verdict = fmt.verify_file(path)[0]
    try:
        fmt.read_payload(path)
        return verdict, None
    except Exception as e:  # the verdict and the error's class and text
        return verdict, type(e).__name__, str(e).replace(path, "<path>")


DAMAGE = {
    "none": lambda path: None,
    "payload_bitflip": lambda path: _flip(path, os.path.getsize(path) - 100),
    "header_bitflip": lambda path: _flip(path, len(ckpt_format.MAGIC) + 12),
    "truncated": lambda path: os.truncate(path, os.path.getsize(path) - 7),
    "trailer_bitflip": lambda path: _flip(path, os.path.getsize(path) - 3),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damage_is_detected_as_the_reference_detects_it(tmp_path, damage):
    outcomes = {}
    for side in ("ref", "port"):
        path = str(tmp_path / f"{side}.ckpt")
        written = PKG[side].format.write_payload(path, b"hollow", _arrays(), meta={"it": 7})
        assert written == os.path.getsize(path)
        DAMAGE[damage](path)
        outcomes[side] = _outcome(PKG[side].format, path)
    assert outcomes["port"] == outcomes["ref"]
    assert (outcomes["port"][0] == "ok") == (damage == "none")


def _shard_path(root, holder, it, owner):
    return os.path.join(root, "s0", f"r{holder}", CkptID(it, owner).filename())


def _leaf(side, rank, it):
    v = np.full((512,), rank * 10.0 + it, np.float32)
    return jnp.asarray(v) if side == "ref" else torch.from_numpy(v)


def _ladder(side, root, flips):
    """Two ranks save iterations 1 and 2 with full mirrors; ``flips`` damages
    ``(holder, owner)`` copies of iteration 2; a fresh world then loads."""
    world = [0, 1]
    w = World(PKG[side])

    def save(rank):
        mgr, ex = w.manager(root, rank, world, keep=2)
        try:
            for it in (1, 2):
                mgr.save(it, PKG[side].sd.PyTreeStateDict({"w": _leaf(side, rank, it),
                                                           "step": it}), is_async=False)
        finally:
            mgr.close()
            ex.close()

    def load(rank):
        mgr, ex = w.manager(root, rank, world, gen=1, keep=2)
        try:
            hollow, tensors, meta = mgr.load()
            return meta["iteration"], hollow["step"], np.asarray(tensors[0]).tobytes()
        finally:
            mgr.close()
            ex.close()

    try:
        run_ranks(world, save, timeout=120.0)
        for holder, owner in flips:
            _flip(_shard_path(root, holder, 2, owner), 150)
        out = run_ranks(world, load, timeout=120.0)
    finally:
        w.close()
    quarantined = sorted(n.split(".corrupt")[0] for n in os.listdir(os.path.join(root, "s0", "r0"))
                         if ".corrupt" in n)
    return out, quarantined


@pytest.mark.parametrize("flips", [(), ((0, 0),), ((0, 0), (1, 0))],
                         ids=["intact", "own_copy", "own_and_mirror"])
def test_recovery_ladder_ends_as_the_references(tmp_path, flips):
    """A corrupt own copy is quarantined and recovered from the peer's mirror
    byte-identical; with the mirror corrupt too, both ranks agree on iteration 1."""
    port = _ladder("port", str(tmp_path / "port"), flips)
    assert port == _ladder("ref", str(tmp_path / "ref"), flips)
    it = 1 if len(flips) == 2 else 2
    assert port[0] == [(it, it, np.full((512,), r * 10.0 + it, np.float32).tobytes())
                       for r in (0, 1)]
    if len(flips) == 1:
        assert ckpt_format.verify_file(_shard_path(str(tmp_path / "port"), 0, 2, 0))[0] == "ok"


@pytest.mark.parametrize("side", ["ref", "port"])
def test_single_rank_falls_back_locally_then_raises(tmp_path, side):
    Manager = PKG[side].local.LocalCheckpointManager
    root = str(tmp_path)
    mgr = Manager(root, rank=0, keep=2)
    for it in (1, 2):
        mgr.save(it, PKG[side].sd.PyTreeStateDict({"w": _leaf(side, 0, it), "step": it}),
                 is_async=False)
    _flip(_shard_path(root, 0, 2, 0), 150)
    hollow, tensors, meta = mgr.load()
    assert meta["iteration"] == 1 and hollow["step"] == 1
    _flip(_shard_path(root, 0, 1, 0), 150)
    with pytest.raises(PKG[side].local.CheckpointError, match="no intact checkpoint"):
        mgr.load()
    mgr.close()


def test_pipelined_save_produces_a_verifiable_container(tmp_path):
    mgr = LocalCheckpointManager(str(tmp_path), rank=0)
    assert mgr.pipelined
    mgr.save(4, PyTreeStateDict({"w": _leaf("port", 0, 4), "b": torch.ones(3).bfloat16(),
                                 "step": 4}), is_async=True)
    mgr.maybe_finalize(blocking=True)
    path = _shard_path(str(tmp_path), 0, 4, 0)
    assert ckpt_format.verify_file(path)[0] == "ok"
    assert PKG["ref"].format.verify_file(path)[0] == "ok"
    assert mgr.load(4)[2]["iteration"] == 4
    mgr.close()


def test_damage_is_classified_as_checkpoint_error(tmp_path):
    mgr = LocalCheckpointManager(str(tmp_path), rank=0)
    with pytest.raises(CheckpointError, match="unreadable shard"):
        mgr._read_blob(3, 0)
    path = _shard_path(str(tmp_path), 0, 5, 0)
    with open(path, "wb") as f:
        f.write(b"garbage that is not a container at all")
    with pytest.raises(CheckpointError, match="bad magic"):
        mgr._read_local_shard(5, 0)
    # A damaged hollow pickle (through the port's placeholder-mapping unpickler).
    path = _shard_path(str(tmp_path), 0, 6, 0)
    header = pickle.dumps({"hollow": b"\x80\x04corrupt-pickle", "leaves": [], "meta": {}})
    with open(path, "wb") as f:
        f.write(ckpt_format.MAGIC_V1 + struct.pack("<Q", len(header)) + header)
    with pytest.raises(CheckpointError, match="corrupt hollow skeleton"):
        mgr._read_local_shard(6, 0)
    mgr.close()
    sd = PyTreeStateDict.__new__(PyTreeStateDict)
    sd._tree = {"w": TensorPlaceholder(shape=(4,), dtype="float32", index=7)}
    sd._hollow, sd._tensors, sd._shardings = True, None, None
    with pytest.raises(CheckpointError, match="out of range"):
        sd.insert_tensors([np.zeros(4, np.float32)])
