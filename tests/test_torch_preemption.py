"""The port's preemption-synchronized checkpointing
(``tpu_resiliency_torch/integrations/preemption.py``) held against
``tests/integrations/test_preemption.py``: its seven scenarios. Six run here on the
port as the reference wrote them (``torch_port_tests``): the no-op without a process
group, the drain of an in-flight async save before the final save, the rescind window,
the immediate act at grace 0, the refused negative grace, and a broken drain that must
not eat the grace window. The seventh starts two ranks under ``jax.distributed`` and
SIGTERMs one; the port's answer below starts two gloo ranks, each a fresh interpreter,
and SIGTERMs rank 1: the agreement over the group (an ``all_reduce(MAX)`` of the
notice flag each step) must make both ranks save the same step and stop there.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

from tests.torch_port_tests import REPO, port_tests
from tests.torch_model_util import free_port

port_tests(
    "tests/integrations/test_preemption.py", globals(),
    leave_out={"test_one_rank_notice_synchronizes_all_saves":
               "starts JAX processes under jax.distributed; answered below over gloo"},
)

CHILD = textwrap.dedent(
    """
    import json, os, sys, time

    proc_id = int(sys.argv[1]); port = sys.argv[2]; out_dir = sys.argv[3]
    import torch

    from tpu_resiliency_torch.platform import distributed as tdist

    tdist.initialize(f"tcp://127.0.0.1:{port}", 2, proc_id, device="cpu", timeout=60.0)

    from tpu_resiliency_torch.integrations import PreemptionCheckpointCallback
    from tpu_resiliency_torch.integrations.loop import LoopContext, run_training
    from tpu_resiliency_torch.integrations.preemption import install_notice_handler

    saved = {}

    def save(state, step):
        with open(os.path.join(out_dir, f"preempt_save_r{proc_id}.json"), "w") as f:
            json.dump({"step": step, "w": float(state["w"])}, f)
        saved["step"] = step

    cb = PreemptionCheckpointCallback(on_preemption=save)

    def step_fn(state, step):
        time.sleep(0.05)  # give the notice a window to land mid-run
        return {"w": state["w"] + 1.0}

    install_notice_handler()
    print(f"READY {os.getpid()}", flush=True)
    ctx = run_training(step_fn, {"w": torch.zeros(())}, num_steps=400, callbacks=[cb],
                       ctx=LoopContext(rank=proc_id, world_size=2))
    tdist.shutdown_graceful(proc_id, grace=3.0)  # coordinator-last teardown
    print(
        "PREEMPT-RESULT "
        + json.dumps({"rank": proc_id, "stopped_at": ctx.step,
                      "saved": saved.get("step"), "should_stop": ctx.should_stop,
                      "w": float(ctx.state["w"])}),
        flush=True,
    )
    """
)


def test_one_rank_notice_synchronizes_every_rank_save_over_gloo(tmp_path):
    port = free_port()
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, bufs, readers = [], [], []
    for r in range(2):
        p = subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp_path)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=str(tmp_path))
        buf: list[str] = []
        t = threading.Thread(target=lambda p=p, b=buf: b.extend(p.stdout), daemon=True)
        t.start()
        procs.append(p)
        bufs.append(buf)
        readers.append(t)
    try:
        # The notice goes out only once both ranks print READY (their handlers exist).
        deadline = time.monotonic() + 240.0
        while time.monotonic() < deadline:
            if all(any(ln.startswith("READY") for ln in b) for b in bufs):
                break
            dead = [r for r, p in enumerate(procs) if p.poll() is not None]
            if dead:
                readers[dead[0]].join(5.0)
                raise AssertionError(f"rank {dead[0]} died during warmup:\n"
                                     + "".join(bufs[dead[0]])[-3000:])
            time.sleep(0.1)
        else:
            raise AssertionError("ranks never became READY:\n"
                                 + "\n---\n".join("".join(b)[-1500:] for b in bufs))
        time.sleep(1.0)  # both stepping; the notice lands mid-run
        procs[1].send_signal(signal.SIGTERM)  # the preemption notice
        results = {}
        for r, p in enumerate(procs):
            p.wait(timeout=120)
            readers[r].join(10.0)
            out = "".join(bufs[r])
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("PREEMPT-RESULT ")]
            assert line, f"rank {r} no result:\n{out[-2000:]}"
            results[r] = json.loads(line[0][len("PREEMPT-RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    # Both ranks saved the SAME step and stopped there — including rank 0, which
    # never received a signal — before the 400-step horizon.
    assert results[0]["saved"] is not None and results[0]["saved"] == results[1]["saved"]
    assert all(r["should_stop"] for r in results.values()), results
    assert results[0]["stopped_at"] == results[1]["stopped_at"] == results[0]["saved"] + 1
    assert results[0]["stopped_at"] < 400
    saves = [json.loads((tmp_path / f"preempt_save_r{r}.json").read_text()) for r in range(2)]
    assert saves[0] == saves[1] == {"step": results[0]["saved"],
                                    "w": float(results[0]["saved"] + 1)}


def test_the_agreement_is_a_maximum_over_the_group():
    """Two gloo ranks: rank 0 raises its flag with ``notify`` before step 3; both
    agree at step 3, and a ``rescind`` on rank 0 clears the agreement for both in the
    next step."""
    from tests.torch_model_util import run_gloo

    body = """
    from tpu_resiliency_torch.integrations import preemption
    cb = preemption.PreemptionCheckpointCallback(on_preemption=lambda s, i: None)
    seen = []
    for step in range(6):
        if rank == 0 and step == 3:
            preemption.notify()
        if rank == 0 and step == 4:
            preemption.rescind()
        seen.append(cb._reached(step))
    result({"seen": seen, "group": dist.get_backend(preemption.agreement_group())})
    """
    runs = run_gloo(body, 2)
    assert runs[0] == runs[1] == {"seen": [False, False, False, True, False, False],
                                  "group": "gloo"}
