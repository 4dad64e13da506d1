"""The restart loop of both packages, side by side: the scenarios of the reference's
``tests/inprocess/test_wrap.py`` run against ``tpu_resiliency.inprocess.wrap`` and the
port's ``tpu_resiliency_torch.inprocess.wrap`` at once, each world of forked rank
processes on its own package's store, with injected faults. The port must give the
outcome the reference gives in the same run: the same results (iterations, world
sizes, active ranks, modes), exclusions, exceptions and, where the scenario names
them, exit codes. The reference test's own expected values are asserted as well.

Also on the CPU, the port alone: config 4's detector workload at a small size under
the Wrapper, as ``chip_smoke.py``'s ``restart_path`` drives it at full width on the
card (the reference's telemetry runs on JAX devices, so it has no such workload here).
"""

import importlib
import multiprocessing as mp
import os
import queue
import threading
import time
import types

from tests.torch_model_util import held_port

REFERENCE, PORT = ROOTS = ("tpu_resiliency", "tpu_resiliency_torch")


def pkg(root: str) -> types.SimpleNamespace:
    """The modules the scenarios use, from package ``root``."""
    names = ("exceptions", "inprocess.wrap", "inprocess.initialize",
             "inprocess.rank_assignment", "platform.store", "utils.events",
             "utils.flight_recorder")
    return types.SimpleNamespace(**{
        n.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{n}") for n in names})


def fast_wrapper(p, **kw):
    """``p.wrap.Wrapper`` with the reference test's fast timeouts."""
    defaults = dict(
        monitor_interval=0.05,
        last_call_wait=0.1,
        soft_timeout=10.0,
        hard_timeout=20.0,
        heartbeat_interval=0.2,
        heartbeat_timeout=10.0,
        barrier_timeout=45.0,
        completion_timeout=45.0,
    )
    defaults.update(kw)
    return p.wrap.Wrapper(**defaults)


def run_worlds(world, body, timeout=90.0, after_start=None, env=None, roots=ROOTS):
    """Fork ``world`` children for each package of ``roots``, both worlds at once,
    each on its own store; child ``rank`` of package ``root`` runs ``body(rank, q,
    pkg(root))`` with ``env(root)`` added to its environment. ``after_start(root,
    port)`` runs in a thread per package once its children are forked. Returns root
    → (rank → result, exit codes); every child is joined with its own timeout."""
    ctx = mp.get_context("fork")
    worlds = {}
    for root in roots:
        port, q, procs = held_port(), ctx.Queue(), []
        for rank in range(world):
            def child(rank=rank, root=root, port=port, q=q):
                os.environ.update(env(root) if env else {})
                os.environ["RANK"] = str(rank)
                os.environ["WORLD_SIZE"] = str(world)
                os.environ["TPU_RESILIENCY_STORE_PORT"] = str(port)
                os.environ["TPU_RESILIENCY_STORE_HOST"] = "127.0.0.1"
                body(rank, q, pkg(root))

            p = ctx.Process(target=child, daemon=False)
            p.start()
            procs.append(p)
        worlds[root] = (port, q, procs)
    helpers = [threading.Thread(target=after_start, args=(root, port))
               for root, (port, _, _) in worlds.items() if after_start is not None]
    for t in helpers:
        t.start()
    results, gone = {root: {} for root in roots}, set()
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            waiting = [root for root in roots if len(results[root]) < world and root not in gone]
            if not waiting:
                break
            for root in waiting:
                _, q, procs = worlds[root]
                try:
                    rank, payload = q.get(timeout=0.5)
                    results[root][rank] = payload
                except queue.Empty:
                    if all(not p.is_alive() for p in procs) and q.empty():
                        gone.add(root)  # every child exited: no more results
    finally:
        for t in helpers:
            t.join(timeout=15.0)
        for _, _, procs in worlds.values():
            for p in procs:
                p.join(timeout=15.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
    return {root: (results[root], [p.exitcode for p in worlds[root][2]]) for root in roots}


def same_outcome(out, codes=False):
    """The port's results (and, with ``codes``, its exit codes) must be the ones
    the reference gave in the same run; returns the port's."""
    (ref, ref_codes), (got, got_codes) = out[REFERENCE], out[PORT]
    assert got == ref, f"port {got} != reference {ref}"
    if codes:
        assert got_codes == ref_codes, f"port exit codes {got_codes} != reference {ref_codes}"
    return got, got_codes


class TestSingleRank:
    def test_success_passthrough(self):
        def body(rank, q, p):
            @fast_wrapper(p)
            def train():
                return "done"

            q.put((rank, train()))

        results, codes = same_outcome(run_worlds(1, body), codes=True)
        assert results == {0: "done"} and codes == [0]

    def test_restart_on_exception(self):
        def body(rank, q, p):
            attempts = []

            @fast_wrapper(p)
            def train(call: p.wrap.CallWrapper):
                attempts.append(call.iteration)
                if len(attempts) < 3:
                    raise RuntimeError(f"boom {len(attempts)}")
                return ("ok", attempts)

            q.put((rank, train()))

        results, codes = same_outcome(run_worlds(1, body), codes=True)
        assert results[0] == ("ok", [0, 1, 2])
        assert codes == [0]

    def test_retry_controller_aborts(self):
        def body(rank, q, p):
            @fast_wrapper(p, initialize=p.initialize.RetryController(max_iterations=2))
            def train():
                raise RuntimeError("always fails")

            try:
                train()
                q.put((rank, "no-abort"))
            except p.exceptions.RestartAbort:
                q.put((rank, "aborted"))

        results, codes = same_outcome(run_worlds(1, body), codes=True)
        assert results == {0: "aborted"} and codes == [0]

    def test_fn_exception_leaves_a_flight_dump(self, tmp_path):
        def body(rank, q, p):
            @fast_wrapper(p)
            def train(call: p.wrap.CallWrapper):
                p.events.record("test", "step", iteration=call.iteration)
                if call.iteration == 0:
                    raise RuntimeError("boom once")
                return call.iteration

            result = train()
            dumps = p.flight_recorder.collect(os.environ["TPU_RESILIENCY_FLIGHT_DIR"])
            flight = [{"flushes": [r.get("reason") for r in records
                                   if r.get("kind") == "flight_flush"][:1],
                       "step_recorded": ("test", "step") in {
                           (r.get("source"), r.get("kind")) for r in records}}
                      for records in dumps.values()]
            q.put((rank, (result, flight)))

        results, codes = same_outcome(run_worlds(
            1, body, env=lambda root: {"TPU_RESILIENCY_FLIGHT_DIR": str(tmp_path / root)}),
            codes=True)
        assert codes == [0]
        assert results == {0: (1, [{"flushes": ["fn_exception"], "step_recorded": True}])}


class TestMultiRank:
    def test_peer_exception_restarts_everyone(self):
        def body(rank, q, p):
            @fast_wrapper(p)
            def train(call: p.wrap.CallWrapper):
                if call.iteration == 0 and rank == 1:
                    raise RuntimeError("rank1 fails round 0")
                deadline = time.monotonic() + 30.0
                while call.iteration == 0 and time.monotonic() < deadline:
                    time.sleep(0.05)
                return ("ok", call.iteration, call.frozen_state.active_world_size)

            q.put((rank, train()))

        results, codes = same_outcome(run_worlds(2, body), codes=True)
        assert codes == [0, 0]
        assert results[0] == ("ok", 1, 2)
        assert results[1] == ("ok", 1, 2)

    def test_rank_death_shrinks_world(self):
        def body(rank, q, p):
            @fast_wrapper(p)
            def train(call: p.wrap.CallWrapper):
                if call.iteration == 0 and rank == 1:
                    os._exit(7)
                deadline = time.monotonic() + 60.0
                while call.iteration == 0 and time.monotonic() < deadline:
                    time.sleep(0.05)
                return ("ok", call.iteration, call.frozen_state.active_world_size)

            q.put((rank, train()))

        out = run_worlds(2, body, timeout=120.0)
        results, codes = same_outcome(out)
        assert codes[1] == out[REFERENCE][1][1] == 7
        assert results[0] == ("ok", 1, 1)

    def test_degraded_rank_demoted_without_dying(self):
        def body(rank, q, p):
            @fast_wrapper(p, rank_assignment=p.rank_assignment.DemoteDegraded(
                max_active_world_size=2))
            def train(call: p.wrap.CallWrapper):
                fs = call.frozen_state
                if call.iteration == 0:
                    if rank == 0:
                        call.coord.set_degraded({1})
                        time.sleep(0.3)
                        raise RuntimeError("force a restart round")
                    deadline = time.monotonic() + 30.0
                    while time.monotonic() < deadline:
                        time.sleep(0.05)
                return ("ok", call.iteration, fs.mode.name, fs.active_rank,
                        fs.active_world_size)

            q.put((rank, train()))

        results, codes = same_outcome(run_worlds(3, body, timeout=120.0), codes=True)
        assert codes == [0, 0, 0]
        assert results[1] is None
        assert results[0] == ("ok", 1, "ACTIVE", 0, 2)
        assert results[2] == ("ok", 1, "ACTIVE", 1, 2)

    def test_system_exit_terminates_rank_not_restart(self):
        def body(rank, q, p):
            attempts = []

            @fast_wrapper(p)
            def train(call: p.wrap.CallWrapper):
                attempts.append(call.iteration)
                if rank == 1:
                    raise SystemExit(5)
                deadline = time.monotonic() + 60.0
                while call.iteration == 0 and time.monotonic() < deadline:
                    time.sleep(0.05)
                return ("ok", call.iteration, call.frozen_state.active_world_size)

            try:
                q.put((rank, train()))
            except SystemExit as e:
                q.put((rank, ("exit", e.code, len(attempts))))

        results, _ = same_outcome(run_worlds(2, body, timeout=120.0))
        assert results[1] == ("exit", 5, 1)
        assert results[0] == ("ok", 1, 1)

    def test_spare_rank_activates_on_failure(self):
        def body(rank, q, p):
            @fast_wrapper(p, rank_assignment=p.rank_assignment.MaxActiveWorldSize(2))
            def train(call: p.wrap.CallWrapper):
                fs = call.frozen_state
                if call.iteration == 0 and rank == 1:
                    os._exit(5)
                deadline = time.monotonic() + 60.0
                while call.iteration == 0 and time.monotonic() < deadline:
                    time.sleep(0.05)
                return ("ok", call.iteration, fs.active_rank, fs.active_world_size)

            q.put((rank, train()))

        out = run_worlds(3, body, timeout=120.0)
        results, codes = same_outcome(out)
        assert codes[1] == out[REFERENCE][1][1] == 5
        assert results[0][0] == "ok" and results[2][0] == "ok"
        assert results[0][3] == 2 and results[2][3] == 2


class TestStandDown:
    def test_proxy_completed_straggler_stands_down(self):
        def body(rank, q, p):
            @fast_wrapper(p, server_linger=10.0)
            def train():
                if rank == 0:
                    time.sleep(0.3)
                    return "ok"
                time.sleep(4.0)
                raise RuntimeError("late fault on the straggler")

            q.put((rank, train()))
            if rank == 0:
                time.sleep(12.0)

        def proxy_straggler(root, port):
            time.sleep(1.5)
            mon = pkg(root).store.CoordStore("127.0.0.1", port, prefix="inprocess/")
            mon.barrier_join(
                "barrier/completion/0", 1, 2, timeout=0.0, wait=False, on_behalf=True
            )
            mon.close()

        results, codes = same_outcome(
            run_worlds(2, body, timeout=90.0, after_start=proxy_straggler), codes=True)
        assert results.get(0) == "ok", results
        assert 1 in results and results[1] is None, results
        assert codes == [0, 0]


# -- config 4's detector workload under the Wrapper, at a small size ---------------

RANKS, SIGNALS, WINDOW = 64, 8, 8
STEPS, FAULT_STEP, PROFILE_EVERY, REPORT_EVERY = 40, 30, 10, 20


def test_detector_workload_restarts_in_process():
    """``chip_smoke.py``'s ``restart_path`` part 1 on the CPU: the Wrapper around
    ``run_training`` with the straggler callback (profiler windows every 10 steps)
    and a ``MeshTelemetry`` report every 20 steps, a gloo group per iteration torn
    down by ``AbortTorchDistributed``; iteration 0 raises inside a profiled step.
    Iteration 1 must open new windows, a new group, and flag the ranks a run without
    a fault flags."""

    def body(rank, q, p):
        import numpy as np
        import torch
        import torch.distributed as dist

        from tpu_resiliency_torch.inprocess import (
            AbortTorchDistributed,
            CallWrapper,
            CudaHealthCheck,
        )
        from tpu_resiliency_torch.inprocess.tools.inject_fault import InjectedFault
        from tpu_resiliency_torch.integrations import (
            LoopContext,
            StragglerDetectionCallback,
            run_training,
        )
        from tpu_resiliency_torch.platform import distributed
        from tpu_resiliency_torch.telemetry import Detector, MeshTelemetry
        from tpu_resiliency_torch.telemetry.device_profiler import profiler_running

        rng = np.random.default_rng(0)
        rows = torch.tensor(rng.uniform(0.9, 1.1, (WINDOW, RANKS, SIGNALS)), dtype=torch.float32)
        rows[:, 5] *= 1.6
        seen = {"windows": {}, "groups": {}}

        class Windows(StragglerDetectionCallback):
            def _fold_profiler_window(self):
                out = super()._fold_profiler_window()
                seen["windows"].setdefault(self.iteration, []).append(self._step_count - 1)
                return out

        def workload(it, fault):
            mt = MeshTelemetry(RANKS, signal_names=tuple(f"s{k}" for k in range(SIGNALS)),
                               window=WINDOW, device="cpu")
            reports = []

            def step(state, i):
                mt.push(state, rows[i % WINDOW])
                if i % REPORT_EVERY == 0:
                    state, rep = mt.generate_report(state)
                    reports.append(rep)
                if fault and i == FAULT_STEP:
                    raise InjectedFault(f"step {i}")
                return state

            cb = Windows(report_time_interval=3600.0, profile_programs_every=PROFILE_EVERY,
                         profile_ops=True, device="cpu")
            cb.iteration = it
            run_training(step, mt.init_state(), STEPS, callbacks=[cb],
                         ctx=LoopContext(rank=0, world_size=1))
            return sorted(s.rank for s in reports[-1].identify_stragglers().by_perf)

        want = workload(-1, fault=False)

        @fast_wrapper(p, abort=AbortTorchDistributed(),
                      health_check=CudaHealthCheck(timeout=30.0, device="cpu"))
        def train(call: CallWrapper):
            it = call.iteration
            assert not (profiler_running() or Detector.initialized or distributed.client_active())
            distributed.initialize(f"tcp://127.0.0.1:{held_port()}", 1, 0, device="cpu")
            seen["groups"][it] = dist.group.WORLD
            t = torch.full((4,), 3.0)
            dist.all_reduce(t)
            flagged = workload(it, fault=it == 0)
            distributed.shutdown_ordered(call.coord.store, 0, 1, iteration=it)
            return it, t.tolist(), flagged

        it, reduced, flagged = train()
        g = seen["groups"]
        q.put((rank, {"iteration": it, "all_reduce": reduced, "flagged": flagged, "want": want,
                      "new_group": sorted(g) == [0, 1] and g[1] is not g[0],
                      "windows": seen["windows"]}))

    results, codes = run_worlds(1, body, timeout=120.0, roots=(PORT,))[PORT]
    assert codes == [0], results
    r = results[0]
    assert r["iteration"] == 1 and r["new_group"] and r["all_reduce"] == [3.0] * 4
    assert r["flagged"] == r["want"] and 5 in r["want"]
    assert r["windows"][0] == [0, 10, 20]  # the window of step 30 faulted
    assert r["windows"][1] == [0, 10, 20, 30]
