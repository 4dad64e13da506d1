"""Shared helpers of the port's checkpoint tests (``tests/test_torch_checkpoint_*.py``):
the same seeded tree built for each package (numpy values into JAX CPU arrays for
the reference, CPU tensors for the port), bit-level comparison, and threads-as-ranks
worlds on each package's own store.
"""

import collections
import concurrent.futures as cf

import jax.numpy as jnp
import numpy as np
import torch

#: A namedtuple node: JAX and the port keep its field order.
Pair = collections.namedtuple("Pair", "zulu alpha")

_INT_VIEW_NP = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
_INT_VIEW_TORCH = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def seeded_values(seed: int) -> dict:
    """The leaves' numpy values, from ``seed``."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((6, 4)).astype(np.float32),
        "bf": rng.standard_normal((5, 3)).astype(np.float32),  # stored as bf16
        "i": rng.integers(-9, 9, (3, 2)).astype(np.int32),
        "s": np.asarray(rng.standard_normal(), np.float32),  # a 0-d leaf
        "m": rng.standard_normal((2, 7)).astype(np.float16),  # JAX runs without x64
        "flag": rng.integers(0, 2, (4,)).astype(bool),
    }


def make_tree(seed: int, lib: str):
    """A tree with unsorted keys, ``None``, a tuple, a namedtuple, an ``OrderedDict``,
    a bf16 leaf, a 0-d leaf and non-array leaves, as ``lib`` ("jax" or "torch")
    holds it."""
    v = seeded_values(seed)
    if lib == "jax":
        conv = jnp.asarray
        bf = jnp.asarray(v["bf"]).astype(jnp.bfloat16)
    else:
        conv = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        bf = torch.from_numpy(v["bf"].copy()).to(torch.bfloat16)
    return {
        "zeta": {"w": conv(v["w"]), "bias": bf},
        "alpha": (conv(v["i"]), None, conv(v["s"])),
        "mid": Pair(zulu=conv(v["m"]), alpha=[conv(v["flag"]), 3]),
        "ordered": collections.OrderedDict([("y", conv(v["w"][:2])), ("x", 1.5)]),
        "step": 7,
        "name": "run",
    }


def bits(x) -> np.ndarray:
    """Any array or tensor (bf16 included) as a numpy integer view of its bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.view(_INT_VIEW_TORCH[t.element_size()]).numpy()
    a = np.asarray(x)
    a = a if a.flags.c_contiguous else a.copy(order="C")
    return a.view(_INT_VIEW_NP[a.itemsize])


def same_bits(a, b) -> bool:
    x, y = bits(a), bits(b)
    return x.shape == y.shape and np.array_equal(x, y)


def run_ranks(world, fn, timeout=90.0):
    """Run ``fn(rank)`` for each rank on its own thread; raise the first failure."""
    with cf.ThreadPoolExecutor(max_workers=len(world)) as pool:
        futures = [pool.submit(fn, r) for r in world]
        return [f.result(timeout=timeout) for f in futures]


def packages():
    """``{"ref": modules of the JAX package, "port": the port's}`` the tests drive."""
    import tpu_resiliency.checkpoint.async_ckpt as r_async
    import tpu_resiliency.checkpoint.comm as r_comm
    import tpu_resiliency.checkpoint.format as r_format
    import tpu_resiliency.checkpoint.local_manager as r_local
    import tpu_resiliency.checkpoint.replication as r_repl
    import tpu_resiliency.checkpoint.reshard as r_reshard
    import tpu_resiliency.checkpoint.staging as r_staging
    import tpu_resiliency.checkpoint.state_dict as r_sd
    import tpu_resiliency.platform.store as r_store
    import tpu_resiliency_torch.checkpoint.async_ckpt as p_async
    import tpu_resiliency_torch.checkpoint.comm as p_comm
    import tpu_resiliency_torch.checkpoint.format as p_format
    import tpu_resiliency_torch.checkpoint.local_manager as p_local
    import tpu_resiliency_torch.checkpoint.replication as p_repl
    import tpu_resiliency_torch.checkpoint.reshard as p_reshard
    import tpu_resiliency_torch.checkpoint.staging as p_staging
    import tpu_resiliency_torch.checkpoint.state_dict as p_sd
    import tpu_resiliency_torch.platform.store as p_store

    ns = collections.namedtuple("ns", "async_ckpt comm format local repl reshard staging sd store")
    return {
        "ref": ns(r_async, r_comm, r_format, r_local, r_repl, r_reshard, r_staging, r_sd, r_store),
        "port": ns(p_async, p_comm, p_format, p_local, p_repl, p_reshard, p_staging, p_sd,
                   p_store),
    }


class World:
    """A store server of one package and a factory of clients on it."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.server = pkg.store.KVServer(host="127.0.0.1", port=0)
        self.stores = []

    def store(self, pkg=None):
        pkg = pkg or self.pkg
        s = pkg.store.CoordStore("127.0.0.1", self.server.port, timeout=30.0)
        self.stores.append(s)
        return s

    def manager(self, root, rank, world, factor=2, gen=0, pkg=None, **kw):
        """A replicated ``LocalCheckpointManager`` for ``rank`` of ``world`` from
        ``pkg`` (the server's package by default), and its peer exchange (close it
        after the manager)."""
        pkg = pkg or self.pkg
        comm = pkg.comm.StoreComm(self.store(pkg), rank, list(world), timeout=30.0,
                                  generation=gen)
        ex = pkg.comm.PeerExchange(self.store(pkg), rank, timeout=30.0)
        ex.start()
        strat = pkg.repl.CliqueReplicationStrategy(
            comm, ex, replication_jump=1, replication_factor=factor
        )
        return pkg.local.LocalCheckpointManager(root, rank=rank, comm=comm, replication=strat,
                                                **kw), ex

    def close(self):
        for s in self.stores:
            s.close()
        self.server.close()
