"""The torch.distributed abort → re-initialize path of the port, driven end to end
across real processes, as ``tests/inprocess/test_abort_reinit.py`` drives the
reference's ``jax.distributed`` one. Two scenarios, both through the full Wrapper
restart loop with ``AbortTorchDistributed`` in the abort chain, on 2 gloo processes:

- **exception fault**: rank 1 raises after its collective steps; both ranks restart,
  tear down the world-2 group, and initialize a fresh one (new rendezvous port) at
  iteration 1 — world size unchanged, the group provably new.
- **rank death**: rank 1 dies; the survivor restarts alone, initializes with
  ``world_size=1``, and completes — the world SHRANK across the re-init.

Each runs beside the reference's own scenario (its child script, by its own
harness) at once, and must give its outcome in the same run: the same exit codes,
iterations, world sizes and ranks, and the same collective sum once the reference's
two virtual devices per process are counted (each port process holds one tensor).
Faults land between steps, as in the reference: a collective already in flight
against a dead peer is the monitor process's case.

The ``gpu`` test runs NCCL abort and re-init in one process on the card.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

from tests.inprocess import test_abort_reinit as reference
from tests.torch_model_util import held_port
from tpu_resiliency_torch.platform import distributed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


CHILD = textwrap.dedent(
    """
    import json, os, sys, time

    rank, world, store_port, fault = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    group_ports = [int(p) for p in sys.argv[5].split(",")]  # rendezvous port per iteration
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                      TPU_RESILIENCY_STORE_PORT=store_port)
    import torch
    import torch.distributed as dist

    from tpu_resiliency_torch.inprocess import (
        AbortCompilationCache, AbortTorchDistributed, CallWrapper, Compose, RetryController,
        Wrapper,
    )
    from tpu_resiliency_torch.platform import distributed

    groups = {}

    @Wrapper(
        initialize=RetryController(max_iterations=4),
        abort=Compose(AbortTorchDistributed(), AbortCompilationCache()),
        monitor_interval=0.05, last_call_wait=0.1, soft_timeout=10.0, hard_timeout=30.0,
        heartbeat_interval=0.2, heartbeat_timeout=10.0, barrier_timeout=60.0,
        completion_timeout=60.0,
    )
    def train(call: CallWrapper):
        fs = call.frozen_state
        w, r = fs.active_world_size, fs.active_rank
        assert not distributed.client_active(), "abort left a stale process group"
        port = group_ports[call.iteration]
        distributed.initialize(f"tcp://127.0.0.1:{port}", w, r, timeout=30.0, device="cpu")
        groups[call.iteration] = dist.group.WORLD
        # Each process contributes initial_rank + 1: the sum proves the collective
        # crossed every live process.
        total = None
        for _ in range(3):
            x = torch.full((1,), float(fs.initial_rank + 1))
            dist.all_reduce(x)
            total = float(x[0])
            call.ping()
        if call.iteration == 0 and fs.initial_rank == 1:
            if fault == "die":
                os._exit(9)
            raise RuntimeError("injected fault after round")
        if call.iteration == 0:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                time.sleep(0.05)
            raise TimeoutError("restart never delivered")
        distributed.shutdown_ordered(call.coord.store, r, w, iteration=call.iteration)
        return {
            "iteration": call.iteration, "world": w, "rank": r,
            "initial_rank": fs.initial_rank, "sum": total, "group_port": port,
            "new_group": 0 in groups and groups[call.iteration] is not groups[0],
        }

    result = train()
    print("ABORT-REINIT " + json.dumps({"rank": rank, "result": result}), flush=True)
    """
)


def _run(fault: str, timeout: float = 120.0):
    store_port = held_port()
    group_ports = ",".join(str(held_port()) for _ in range(4))
    env = dict(os.environ, TPU_RESILIENCY_LOG_LEVEL="WARNING")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), "2", str(store_port), fault, group_ports],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT,
        )
        for r in range(2)
    ]
    outs = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            outs[r] = (p.returncode, out, err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    results = {}
    for rc, out, err in outs.values():
        for ln in out.splitlines():
            if ln.startswith("ABORT-REINIT "):
                payload = json.loads(ln[len("ABORT-REINIT "):])
                results[payload["rank"]] = payload["result"]
    return outs, results, [int(p) for p in group_ports.split(",")]


def _beside_reference(fault: str):
    """The port's scenario and the reference's, at once; asserts the port's outcome
    is the reference's and returns the port's ``_run``."""
    ref = {}
    t = threading.Thread(target=lambda: ref.update(zip(("outs", "results"), reference._run(fault))))
    t.start()
    try:
        got = _run(fault)
    finally:
        t.join()
    outs, results, _ = got
    assert [o[0] for o in outs.values()] == [o[0] for o in ref["outs"].values()], (
        f"port exit codes {[o[0] for o in outs.values()]} != reference "
        f"{[o[0] for o in ref['outs'].values()]}:\n{ref['outs']}")
    keys = ("iteration", "world", "rank", "initial_rank")
    port_view = {r: [res[k] for k in keys] + [res["sum"]] for r, res in results.items()}
    ref_view = {int(r): [res[k] for k in keys] + [res["sum"] * res["world"] / res["n_devices"]]
                for r, res in ref["results"].items()}
    assert port_view == ref_view, f"port {port_view} != reference {ref_view}"
    return got


def test_exception_fault_reinitializes_a_new_group():
    outs, results, ports = _beside_reference("raise")
    for r in (0, 1):
        rc, out, err = outs[r]
        assert rc == 0, f"rank{r} failed:\n{out}\n{err[-3000:]}"
    for r in (0, 1):
        res = results[r]
        assert (res["iteration"], res["world"], res["rank"]) == (1, 2, r), results
        assert res["new_group"] and res["group_port"] == ports[1], results
        assert res["sum"] == 3.0, results  # 1 + 2: both processes in the new group


def test_rank_death_shrinks_world_across_reinit():
    outs, results, ports = _beside_reference("die")
    rc0, out0, err0 = outs[0]
    assert rc0 == 0, f"rank0 failed:\n{out0}\n{err0[-3000:]}"
    assert outs[1][0] == 9  # the injected death
    assert set(results) == {0}, results
    res = results[0]
    assert (res["iteration"], res["world"], res["rank"]) == (1, 1, 0), results
    assert res["new_group"] and res["group_port"] == ports[1], results
    assert res["sum"] == 1.0, results  # its own contribution only


def test_shutdown_for_restart_tears_down_and_never_raises(monkeypatch):
    """One process: initialize, tear down, initialize again with a new rendezvous;
    with nothing live it returns False, and a failing teardown is logged, not raised."""
    import torch.distributed as dist

    assert not distributed.shutdown_for_restart()
    groups = []
    try:
        for _ in range(2):
            distributed.initialize(f"tcp://127.0.0.1:{held_port()}", 1, 0, device="cpu")
            groups.append(dist.group.WORLD)
            x = torch.ones(2)
            dist.all_reduce(x)
            assert x.tolist() == [1.0, 1.0] and dist.get_backend() == "gloo"
            assert distributed.shutdown_for_restart()
            assert not distributed.client_active()
            assert distributed.last_abort_method is None  # no NCCL group on the CPU
        assert groups[1] is not groups[0]

        distributed.initialize(f"tcp://127.0.0.1:{held_port()}", 1, 0, device="cpu")

        def broken(*a, **k):
            raise RuntimeError("teardown failed")

        monkeypatch.setattr(dist, "destroy_process_group", broken)
        assert distributed.shutdown_for_restart()
    finally:
        monkeypatch.undo()
        if dist.is_initialized():
            dist.destroy_process_group()


def test_recoverable_initialize_sets_the_nccl_error_handling(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", "3")
    distributed.initialize(f"tcp://127.0.0.1:{held_port()}", 1, 0, device="cpu")
    try:
        assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == \
            distributed.RECOVERABLE_NCCL_ERROR_HANDLING
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", "3")
    distributed.initialize(f"tcp://127.0.0.1:{held_port()}", 1, 0, device="cpu",
                           recoverable=False)
    try:
        assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "3"
    finally:
        dist.destroy_process_group()


def test_initialize_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(f"tcp://127.0.0.1:{held_port()}", 1, 0)
    assert not distributed.client_active()


NCCL_CHILD = textwrap.dedent(
    """
    import json, socket
    import torch
    import torch.distributed as dist
    from tpu_resiliency_torch.inprocess import AbortTorchDistributed
    from tpu_resiliency_torch.platform import distributed

    def port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    out = []
    for i in range(2):
        distributed.initialize(f"tcp://localhost:{port()}", 1, 0)
        x = torch.full((4,), float(i + 2), device="cuda")
        dist.all_reduce(x)
        out.append({"backend": dist.get_backend(), "sum": x.tolist()})
        AbortTorchDistributed()(None)
        out[-1].update(active=distributed.client_active(), method=distributed.last_abort_method)
    print("NCCL-RESULT " + json.dumps(out), flush=True)
    """
)


@pytest.mark.gpu
def test_nccl_abort_and_reinit_in_one_process():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    p = subprocess.run([sys.executable, "-c", NCCL_CHILD], capture_output=True, text=True,
                       env=env, cwd=REPO_ROOT, timeout=180)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("NCCL-RESULT ")]
    assert p.returncode == 0 and lines, p.stdout + p.stderr[-3000:]
    out = json.loads(lines[0][len("NCCL-RESULT "):])
    for i, o in enumerate(out):
        assert o["backend"] == "nccl" and o["sum"] == [float(i + 2)] * 4, out
        assert not o["active"] and o["method"] in ("backend.abort", "_abort_process_group"), out
