"""The port's replication wire (``checkpoint/comm.py``, ``replication.py`` and the
zero-copy container parts of ``format.py``) held against the JAX package's
(``tests/checkpoint/test_replication_protocol.py``).

The copies must speak the reference's protocol: container parts are byte-identical
on the same arrays (a bf16 leaf included), and a port exchange sends to and receives
from a reference exchange on one store, at each frame protocol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import World, bits, packages, run_ranks
from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint.replication import ExchangePlan
from tpu_resiliency_torch.checkpoint.state_dict import to_numpy
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()


def shard_arrays(side):
    """Seeded leaves as each package's host side holds them: the reference's bf16 is
    an ``ml_dtypes`` array, the port's a raw ``uint16`` tagged ``bfloat16``."""
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal(256).astype(np.float32)
    i32 = rng.integers(-50, 50, (3, 5)).astype(np.int32)
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    if side == "ref":
        return [f32, i32, np.asarray(jnp.asarray(bf).astype(jnp.bfloat16))]
    return [f32, i32, to_numpy(torch.from_numpy(bf).to(torch.bfloat16))]


def parts(side):
    prefix, views = PKG[side].format.serialize_parts(b"hollow", shard_arrays(side),
                                                     meta={"it": 7})
    return prefix, views, b"".join([prefix, *[bytes(v) for v in views]])


def test_container_parts_equal_the_references():
    prefix, views, joined = parts("port")
    assert joined == parts("ref")[2]
    assert joined == ckpt_format.serialize_to_bytes(b"hollow", shard_arrays("port"),
                                                    meta={"it": 7})
    assert ckpt_format.parts_nbytes(prefix, views) == len(joined)


def test_deserialize_from_buffer_is_zero_copy_and_tags_bf16():
    joined = parts("port")[2]
    buf = bytearray(joined)
    hollow, tensors, meta = ckpt_format.deserialize_from_buffer(buf)
    assert hollow == b"hollow" and meta == {"it": 7}
    assert not tensors[0].flags["OWNDATA"]
    assert ckpt_format._dtype_name(tensors[2].dtype) == "bfloat16"
    _, ref_tensors, _ = PKG["ref"].format.deserialize_from_buffer(bytearray(joined))
    assert [bits(t).tobytes() for t in tensors] == [bits(t).tobytes() for t in ref_tensors]
    off = joined.index(tensors[0][1].tobytes())
    buf[off:off + 4] = np.float32(99.0).tobytes()
    assert float(tensors[0][1]) == 99.0


def test_write_parts_matches_write_blob(tmp_path):
    prefix, views, joined = parts("port")
    a, b = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    ckpt_format.write_parts(a, [prefix, *views])
    ckpt_format.write_blob(b, joined)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read() == joined


@pytest.mark.parametrize("sender, receiver", [("port", "ref"), ("ref", "port"),
                                              ("port", "port")])
@pytest.mark.parametrize("sender_proto, receiver_proto", [(2, 2), (2, 1), (1, 2)])
def test_exchange_round_trips_across_packages(sender, receiver, sender_proto, receiver_proto):
    """Rank 0 sends a container's parts, rank 1 receives them, each from its own
    package, on one store: the bytes arrive intact at every protocol pairing."""
    prefix, views, joined = parts(sender)
    sides = {0: (sender, sender_proto), 1: (receiver, receiver_proto)}
    w = World(PKG["port"])

    def body(rank):
        side, proto = sides[rank]
        ex = PKG[side].comm.PeerExchange(w.store(PKG[side]), rank, timeout=30.0, protocol=proto)
        ex.start()
        try:
            if rank == 0:
                ex.send_parts(1, "shard", [prefix, *views])
                return None
            got = ex.recv(0, "shard", timeout=30.0)
            assert PKG[side].format.deserialize_from_buffer(got)[2] == {"it": 7}
            return bytes(got)
        finally:
            ex.close()

    try:
        assert run_ranks([0, 1], body)[1] == joined
    finally:
        w.close()


@pytest.mark.parametrize("sides", [("port", "port"), ("ref", "port")])
def test_clique_replicate_round_converges(sides):
    """A replicate round over two ranks (a v1 member among them) converges to the
    same mirrors, whichever package each rank runs."""
    w = World(PKG["ref"])

    def body(rank):
        pkg = PKG[sides[rank]]
        comm = pkg.comm.StoreComm(w.store(pkg), rank, [0, 1], timeout=30.0)
        ex = pkg.comm.PeerExchange(w.store(pkg), rank, timeout=30.0,
                                   protocol=1 if rank == 1 else None)
        ex.start()
        try:
            strat = pkg.repl.CliqueReplicationStrategy(comm, ex, 1, 2)
            held = strat.replicate(f"shard-{rank}".encode())
            return {o: bytes(b).decode() for o, b in held.items()}
        finally:
            ex.close()

    try:
        assert run_ranks([0, 1], body) == [{0: "shard-0", 1: "shard-1"}] * 2
    finally:
        w.close()


PLANS = {
    "avoid_when_healthy": dict(wanted={0: 0}, holders={1: {0}, 2: {0}}, avoid={1}),
    "sole_holder": dict(wanted={0: 0}, holders={1: {0}}, avoid={1}),
    "ties_by_rank": dict(wanted={0: 0, 1: 1}, holders={2: {0, 1}, 3: {0, 1}}),
    "healthy_split": dict(wanted={0: 0, 1: 1}, holders={2: {0, 1}, 3: {0, 1}, 4: {0, 1}},
                          avoid={4}),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_exchange_plans_equal_the_references(name):
    port = ExchangePlan.build(**PLANS[name])
    ref = PKG["ref"].repl.ExchangePlan.build(**PLANS[name])
    assert (port.sends, port.recvs) == (ref.sends, ref.recvs)


def test_no_live_holder_raises():
    with pytest.raises(CheckpointError, match="no live holder"):
        ExchangePlan.build(wanted={0: 5}, holders={1: {2}}, avoid={1})
