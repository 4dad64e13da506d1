"""Shared helpers of the port's model tests: the reference's weights carried into the
port, and small worlds of gloo ranks, each a fresh interpreter (``subprocess``, never
``fork``) that prints one ``RESULT <json>`` line."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from tpu_resiliency_torch.platform.distributed import reserve_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HELD_PORTS = []


def held_port() -> int:
    """A localhost port reserved (``platform/distributed.py`` ``reserve_port``) for the
    rest of this process's life, for a store, a group or a launcher that binds it later,
    here or in a child: no other process takes it first."""
    port, held = reserve_port()
    _HELD_PORTS.append(held)
    return port

def numpy_tree(tree):
    """A JAX tree (nested dicts of arrays) as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


#: Prepended to every child: rank, world and port from argv, a gloo group.
CHILD_HEAD = textwrap.dedent(
    """
    import json, sys
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    args = json.loads(sys.argv[4])
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)

    def result(payload):
        print("RESULT " + json.dumps(payload), flush=True)
    """
)


def run_gloo(body: str, world: int, args=None, timeout: float = 240.0, threads=None) -> list:
    """Run ``body`` (after :data:`CHILD_HEAD`) in ``world`` gloo ranks; returns each
    rank's ``RESULT`` payload, in rank order. A rank that fails fails the call.
    ``threads``: each rank's intra-op threads (``OMP_NUM_THREADS``; torch's default
    otherwise, every core in every rank)."""
    code = CHILD_HEAD + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    port, held = reserve_port()  # held until every rank is done
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port),
                               json.dumps(args or {})], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for r in range(world)]
    results = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} failed:\n{out[-2000:]}\n{err[-4000:]}"
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert lines, f"rank {r} printed no result:\n{out[-2000:]}\n{err[-2000:]}"
            results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        held.close()
    return results
