"""The health-vector decisions loop of both packages, side by side: the reference's
own scenario (``tests/inprocess/test_health_loop.py``'s ``body``) and the same
scenario through the port, each world on its own store, the reference's first. A
slow-but-alive rank's section timings flow through the Detector (the port's with
``device="cpu"``) → ``HealthVectorPolicy`` → the coordination store's degraded set
→ ``DemoteDegraded`` benches it as a spare at the next restart round of the
Wrapper. The port must give the outcome the reference gives in the same run; the
reference test's expected values are asserted as well. Ranks are spawned
processes, each joined with its own timeout.
"""

import multiprocessing as mp
import os
import queue
import time

from tests.inprocess import test_health_loop as reference
from tests.test_torch_inprocess_faults import scheduled_first
from tests.test_torch_inprocess_wrap import fast_wrapper, free_port, pkg

STEPS_PER_ROUND = 6
MAX_REPORT_ROUNDS = 8


def _health_loop_body(rank, world, port, q):
    os.environ.update(
        RANK=str(rank),
        WORLD_SIZE=str(world),
        TPU_RESILIENCY_STORE_PORT=str(port),
        TPU_RESILIENCY_STORE_HOST="127.0.0.1",
        TPU_RESILIENCY_LOG_LEVEL="WARNING",
    )
    from tpu_resiliency_torch.inprocess.rank_assignment import DemoteDegraded
    from tpu_resiliency_torch.inprocess.wrap import CallWrapper
    from tpu_resiliency_torch.platform.store import CoordStore
    from tpu_resiliency_torch.telemetry.detector import Detector
    from tpu_resiliency_torch.telemetry.policy import HealthVectorPolicy

    @fast_wrapper(
        pkg("tpu_resiliency_torch"),
        rank_assignment=DemoteDegraded(max_active_world_size=2),
        soft_timeout=45.0,
        hard_timeout=90.0,
        heartbeat_timeout=60.0,
        barrier_timeout=90.0,
        completion_timeout=90.0,
    )
    def train(call: CallWrapper):
        fs = call.frozen_state
        if fs.iteration >= 1:
            return ("ok", fs.iteration, fs.mode.name, fs.active_world_size)
        me, active_world = fs.active_rank, fs.active_world_size
        store = CoordStore("127.0.0.1", int(os.environ["TPU_RESILIENCY_STORE_PORT"]))
        policy = HealthVectorPolicy(
            patience=2,
            recovery=100,
            sinks=[lambda decision: call.coord.set_degraded(decision.degraded)],
        )
        Detector.initialize(
            rank=me,
            world_size=active_world,
            store=store.scoped("telemetry/"),
            gather_on_rank0=False,
            report_time_interval=3600.0,
            device="cpu",
        )
        try:
            for _ in range(MAX_REPORT_ROUNDS):
                for _ in range(STEPS_PER_ROUND):
                    with Detector.detection_section("step", profile_device=False):
                        time.sleep(0.080 if rank == 1 else 0.008)
                report = Detector.generate_report()
                decision = policy.observe(report)
                if 1 in decision.degraded:
                    break
            assert 1 in decision.degraded, decision
        finally:
            Detector.shutdown()
            store.close()
        if rank == 0:
            time.sleep(0.2)
            raise RuntimeError("force the restart round that applies the demotion")
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            time.sleep(0.02)
        return ("parked-forever", fs.iteration, fs.mode.name, fs.active_world_size)

    q.put((rank, train()))


def _run_world(ctx, body, world):
    """Start ``world`` ranks of ``body`` on a fresh store port and collect each rank's
    result, the ranks joined (or ended) before it returns."""
    port, q = free_port(), ctx.Queue()
    procs = [ctx.Process(target=body, args=(r, world, port, q)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + 180
    try:
        while time.monotonic() < deadline and len(results) < world:
            if all(not p.is_alive() for p in procs) and q.empty():
                break
            try:
                r, payload = q.get(timeout=0.5)
                results[r] = payload
            except queue.Empty:
                pass
    finally:
        for p in procs:
            p.join(timeout=20.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
    return results


def test_measured_slowness_demotes_through_the_full_loop():
    """The verdict rests on measured sleeps (80 ms against 8 ms per step), so the two
    worlds do not run at once: the reference's runs to its end first, then the
    port's, each with its processes scheduled ahead of the suite's where the host
    allows (``scheduled_first``), as the hang test's pair runs."""
    world = 3
    ctx = mp.get_context("spawn")
    runs = {}
    with scheduled_first():
        for name, body in (("reference", reference.body), ("port", _health_loop_body)):
            runs[name] = _run_world(ctx, body, world)
    want, results = runs["reference"], runs["port"]
    assert results == want, f"port {results} != reference {want}"
    assert results[1] is None, results
    assert results[0] == ("ok", 1, "ACTIVE", 2), results
    assert results[2] == ("ok", 1, "ACTIVE", 2), results
