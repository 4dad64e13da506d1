"""Device faults through the port, beside ``tests/inprocess/test_device_faults.py``'s
own scenarios through the reference, run at once (the hang scenario one after the
other; its child scripts, by its own harness):

- ``Fault.DEVICE_ERROR`` kills the device runtime: the liveness probe reports it
  dead, ``CudaHealthCheck`` raises, and a faulted rank is EXCLUDED by the restart
  round's health chain (attempts ``[0]``) rather than respun against a dead device.
- ``Fault.DEVICE_HANG`` parks the main thread in a wait with the GIL released: only
  the monitor process's hard-timeout ladder gets the rank out, and the survivor
  re-enters at world 1.

Here on the CPU the faults are the port's stand-ins (``device="cpu"``: the dead-runtime
mark, a C-level sleep); the ``gpu`` tests run the CUDA kernels of ``csrc/faults.cu``
on the card: the spin kernel hangs a child until it is killed, and the trap kernel's
sticky error flips the probe and the health check. Wrapper scenarios run in fresh
interpreters, as the reference's do; every child has its own timeout. Each CPU
scenario must give the outcome the reference's gives in the same run.
"""

import contextlib
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from tpu_resiliency_torch.exceptions import HealthCheckError
from tpu_resiliency_torch.inprocess import CudaHealthCheck
from tpu_resiliency_torch.inprocess.tools.inject_fault import (
    Fault,
    heal_device_error,
    inject_fault,
)
from tests.inprocess import test_device_faults as reference
from tests.torch_model_util import held_port
from tpu_resiliency_torch.platform import device as port_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_children(child_src: str, argvs, timeout: float = 120.0):
    """One fresh interpreter per argv list, all started together; returns
    ``[(returncode, stdout, stderr)]``."""
    env = dict(os.environ, TPU_RESILIENCY_LOG_LEVEL="WARNING")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", child_src, *map(str, argv)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO_ROOT)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs


def beside(fn, *args, **kw):
    """Start ``fn(*args, **kw)`` in a thread; returns a call that joins it and gives
    its result."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


def result(out: str, tag: str):
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    return json.loads(lines[-1][len(tag) + 1:]) if lines else None


@pytest.fixture
def healed():
    yield
    port_device.set_cpu_runtime_dead(False)


def test_device_error_primitives(healed):
    """DEVICE_ERROR flips the liveness probe and CudaHealthCheck; heal restores. The
    reference's child asserts the same sequence of its probe and JaxHealthCheck."""
    ref = beside(reference._run_children, reference.PRIMITIVES_CHILD, 1, lambda r: [])
    check = CudaHealthCheck(timeout=5.0, device="cpu")
    assert port_device.device_liveness_probe(timeout=15.0, device="cpu")
    check(None)
    inject_fault(Fault.DEVICE_ERROR, device="cpu")
    assert not port_device.device_liveness_probe(timeout=15.0, device="cpu")
    with pytest.raises(HealthCheckError, match="device probe"):
        check(None)
    with pytest.raises(RuntimeError, match="marked dead"):
        port_device.tiny_launch("cpu")
    heal_device_error(device="cpu")
    assert port_device.device_liveness_probe(timeout=15.0, device="cpu")
    check(None)
    rc, out, err = ref()[0]
    assert rc == 0 and "DEVICE-FAULT-PRIMITIVES OK" in out, f"reference:\n{out}\n{err[-3000:]}"


def test_a_wedged_probe_answers_false_within_its_timeout(monkeypatch):
    """A device wait that never returns: the probe answers False after its timeout,
    and the health check raises, instead of blocking the caller."""
    monkeypatch.setattr(port_device, "tiny_launch", lambda dev: time.sleep(30))
    t0 = time.monotonic()
    assert not port_device.device_liveness_probe(timeout=0.5, device="cpu")
    assert time.monotonic() - t0 < 5.0
    from tpu_resiliency_torch.inprocess import health_check

    monkeypatch.setattr(health_check, "tiny_launch", lambda dev: time.sleep(30))
    with pytest.raises(HealthCheckError, match="did not complete within"):
        CudaHealthCheck(timeout=0.5, device="cpu")(None)


@pytest.mark.parametrize("fault", ["DEVICE_HANG", "DEVICE_ERROR"])
def test_device_faults_default_to_the_card(fault):
    """Without a card, a device fault that names no device raises, as every entry
    point does; ``device="cpu"`` must be asked for."""
    if torch.cuda.is_available():
        pytest.skip("the card is here: the default would strike it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inject_fault(getattr(Fault, fault))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaHealthCheck()
    assert not port_device.device_liveness_probe(timeout=5.0)


def test_visible_device_env_and_count(monkeypatch):
    monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    monkeypatch.setenv("TPU_VISIBLE_DEVICES", "0")
    assert port_device.visible_device_env() == {"CUDA_VISIBLE_DEVICES": "2,3"}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert port_device.visible_device_env() == {}
    assert port_device.local_device_count() == torch.cuda.device_count()


ERROR_LADDER_CHILD = textwrap.dedent(
    """
    import json, os, sys

    os.environ.update(RANK="0", WORLD_SIZE="1", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                      TPU_RESILIENCY_STORE_PORT=sys.argv[1])
    from tpu_resiliency_torch.exceptions import HealthCheckError
    from tpu_resiliency_torch.inprocess import (
        CallWrapper, CudaHealthCheck, RetryController, Wrapper,
    )
    from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault
    from tpu_resiliency_torch.platform.device import tiny_launch

    attempts = []

    @Wrapper(
        initialize=RetryController(max_iterations=5),
        health_check=CudaHealthCheck(timeout=5.0, device="cpu"),
        monitor_interval=0.05, last_call_wait=0.1, soft_timeout=10.0, hard_timeout=30.0,
        heartbeat_interval=0.2, heartbeat_timeout=10.0, barrier_timeout=30.0,
        completion_timeout=30.0,
    )
    def train(call: CallWrapper):
        attempts.append(call.iteration)
        if call.iteration == 0:
            inject_fault(Fault.DEVICE_ERROR, device="cpu")
        tiny_launch("cpu")  # the workload's own device use fails on the dead runtime
        return "completed"

    try:
        outcome = train() + " (BAD)"
    except HealthCheckError:
        outcome = "health_excluded"
    print("LADDER-RESULT " + json.dumps({"outcome": outcome, "attempts": attempts}))
    """
)


def test_device_error_excludes_rank_via_health_check():
    """The device dies mid-iteration → fn fault → the restart round's CudaHealthCheck
    finds the runtime dead → rank excluded (HealthCheckError) after one attempt, the
    outcome of the reference's child in the same run."""
    ref = beside(reference._run_children, reference.ERROR_LADDER_CHILD, 1,
                 lambda r: [held_port()])
    ((rc, out, err),) = run_children(ERROR_LADDER_CHILD, [[held_port()]])
    ref_rc, ref_out, ref_err = ref()[0]
    want = result(ref_out, "LADDER-RESULT")
    assert want is not None, f"no reference result (rc {ref_rc}):\n{ref_out}\n{ref_err[-3000:]}"
    payload = result(out, "LADDER-RESULT")
    assert payload is not None, f"no result line (rc {rc}):\n{out}\n{err[-3000:]}"
    assert payload == want, f"port {payload} != reference {want}"
    assert payload == {"outcome": "health_excluded", "attempts": [0]}, payload


HANG_CHILD = textwrap.dedent(
    """
    import json, os, sys, time

    rank = sys.argv[1]
    os.environ.update(RANK=rank, WORLD_SIZE="2", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                      TPU_RESILIENCY_STORE_PORT=sys.argv[2])
    from tpu_resiliency_torch.inprocess import CallWrapper, RetryController, Wrapper
    from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault
    from tpu_resiliency_torch.platform.device import tiny_launch

    @Wrapper(
        initialize=RetryController(max_iterations=4),
        monitor_interval=0.1, last_call_wait=0.1, soft_timeout=1.5, hard_timeout=4.0,
        heartbeat_interval=0.2, heartbeat_timeout=15.0, barrier_timeout=60.0,
        completion_timeout=60.0,
    )
    def train(call: CallWrapper):
        fs = call.frozen_state
        for _ in range(3):
            tiny_launch("cpu")
            call.ping()
        if call.iteration == 0 and fs.initial_rank == 1:
            inject_fault(Fault.DEVICE_HANG, device="cpu")  # never returns
        if call.iteration == 0:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                time.sleep(0.05)
            raise TimeoutError("restart never delivered")
        return {"iteration": call.iteration, "world": fs.active_world_size}

    print("HANG-RESULT " + json.dumps({"rank": rank, "result": train()}), flush=True)
    """
)


@contextlib.contextmanager
def scheduled_first(increment: int = -10):
    """Raise this process's scheduling priority while the body runs; the processes it
    starts inherit it. Where the host refuses (no ``CAP_SYS_NICE``), nothing changes."""
    before = os.nice(0)
    try:
        os.nice(increment)
    except PermissionError:
        yield
        return
    try:
        yield
    finally:
        os.nice(before - os.nice(0))  # raising niceness back is always allowed


def test_device_hang_killed_by_monitor_hard_timeout():
    """A rank parked in a wait with the GIL released stops reporting progress; its
    monitor PROCESS escalates (soft → hard → termination signal), and the survivor
    re-enters at world 1, as the reference's ranks do in the same test.

    The survivor finishes at iteration 1 only if it completes that iteration before
    the dead rank's monitor, one tick (0.1 s) after the kill, records the death against
    it (else a second restart: iteration 2), in either package. A loaded host closes
    that window: four interpreters at once tipped the port's pair (12 stress runs), and
    the whole suite on six workers tipped the reference's pair run alone. So the
    reference's pair runs first and the port's after it, not beside it, each with its
    processes scheduled ahead of the suite's (niceness -10, where the host allows)."""
    ref_port, port = held_port(), held_port()
    with scheduled_first():
        refs = reference._run_children(reference.HANG_CHILD, 2, lambda r: [r, ref_port],
                                       timeout=120.0)
        (rc0, out0, err0), (rc1, out1, err1) = run_children(
            HANG_CHILD, [[0, port], [1, port]], timeout=120.0)
    outcomes = []
    for (r0, o0, e0), (r1, o1, e1) in (((rc0, out0, err0), (rc1, out1, err1)),
                                       (refs[0], refs[1])):
        assert r1 != 0, f"hung rank exited cleanly:\n{o1}\n{e1[-2000:]}"
        assert r0 == 0, f"survivor failed:\n{o0}\n{e0[-3000:]}"
        outcomes.append((result(o1, "HANG-RESULT"), result(o0, "HANG-RESULT")["result"]))
    assert outcomes[0] == outcomes[1], f"port {outcomes[0]} != reference {outcomes[1]}"
    assert outcomes[0] == (None, {"iteration": 1, "world": 1})


# -- on the card ---------------------------------------------------------------------

SPIN_CHILD = textwrap.dedent(
    """
    import threading, time
    from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault, launch_spin

    def report():
        while launch_spin.launches == 0:
            time.sleep(0.01)
        print("SPINNING", flush=True)

    threading.Thread(target=report, daemon=True).start()
    inject_fault(Fault.DEVICE_HANG)
    print("RETURNED", flush=True)
    """
)


@pytest.mark.gpu
def test_the_spin_kernel_hangs_a_child_until_it_is_killed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    p = subprocess.Popen([sys.executable, "-c", SPIN_CHILD], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT)
    try:
        assert p.stdout.readline().strip() == "SPINNING"
        time.sleep(3.0)
        assert p.poll() is None, "the spin kernel returned"
    finally:
        p.kill()
        out, err = p.communicate(timeout=60)
    assert "RETURNED" not in out
    x = torch.ones(1024, device="cuda")
    assert float((x + 1).sum()) == 2048.0  # this process's context still runs


TRAP_CHILD = textwrap.dedent(
    """
    import json, os
    from tpu_resiliency_torch.exceptions import HealthCheckError
    from tpu_resiliency_torch.inprocess import CudaHealthCheck
    from tpu_resiliency_torch.inprocess.tools.inject_fault import (
        Fault, heal_device_error, inject_fault, launch_trap,
    )
    from tpu_resiliency_torch.platform.device import device_liveness_probe

    out = {"before": device_liveness_probe(timeout=15.0)}
    check = CudaHealthCheck(timeout=5.0)
    inject_fault(Fault.DEVICE_ERROR)
    out["after"] = device_liveness_probe(timeout=15.0)
    try:
        check(None)
        out["check"] = "passed"
    except HealthCheckError:
        out["check"] = "HealthCheckError"
    try:
        heal_device_error()
        out["heal"] = "healed"
    except RuntimeError as e:
        out["heal"] = "raised"
    out["launches"] = launch_trap.launches
    print("TRAP-RESULT " + json.dumps(out), flush=True)
    os._exit(0)
    """
)


@pytest.mark.gpu
def test_the_trap_kernel_flips_the_probe_and_the_health_check():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ((rc, out, err),) = run_children(TRAP_CHILD, [[]])
    payload = result(out, "TRAP-RESULT")
    assert payload == {"before": True, "after": False, "check": "HealthCheckError",
                       "heal": "raised", "launches": 1}, f"rc {rc}:\n{out}\n{err[-3000:]}"
