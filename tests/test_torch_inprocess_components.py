"""The in-process restart building blocks of both packages:
``tests/inprocess/test_components.py``'s scenarios run against ``tpu_resiliency.inprocess``
and the port, ``tpu_resiliency_torch.inprocess``, each on its own package's store,
and must give the same outcomes. The reference's ``JaxHealthCheck`` is answered by
the port's ``CudaHealthCheck(device="cpu")``; the progress watchdog runs the
pure-Python pending-call path (``use_native=False``), the port's only path.
"""

import importlib
import threading
import time
import types

import pytest

MODULES = (
    "exceptions", "inprocess.attribution", "inprocess.compose", "inprocess.coordination",
    "inprocess.finalize", "inprocess.health_check", "inprocess.initialize",
    "inprocess.monitor_thread", "inprocess.progress_watchdog", "inprocess.rank_assignment",
    "inprocess.state", "inprocess.tools.inject_fault", "platform.store",
)


def _namespace(root: str, health_check) -> types.SimpleNamespace:
    mods = {m.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{m}") for m in MODULES}
    return types.SimpleNamespace(**mods, device_health_check=health_check)


PACKAGES = {
    "jax": lambda: _namespace(
        "tpu_resiliency",
        lambda timeout: importlib.import_module(
            "tpu_resiliency.inprocess.health_check").JaxHealthCheck(timeout=timeout)),
    "torch": lambda: _namespace(
        "tpu_resiliency_torch",
        lambda timeout: importlib.import_module(
            "tpu_resiliency_torch.inprocess.health_check").CudaHealthCheck(
                timeout=timeout, device="cpu")),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]()


@pytest.fixture
def store(pkg):
    server = pkg.store.KVServer(host="127.0.0.1", port=0)
    yield lambda **kw: pkg.store.CoordStore("127.0.0.1", server.port, **kw)
    server.close()


def ctx_for(pkg, rank, world, terminated=()):
    return pkg.rank_assignment.RankAssignmentCtx(
        pkg.state.State(rank=rank, world_size=world), frozenset(terminated)
    )


class TestStateAndFilters:
    def test_state_defaults(self, pkg):
        s = pkg.state.State(rank=3, world_size=8)
        assert s.initial_rank == 3 and s.active_rank == 3
        assert s.mode == pkg.state.Mode.INITIALIZED

    def test_activate_all(self, pkg):
        c = pkg.rank_assignment.ActivateAllRanks()(ctx_for(pkg, 4, 6, terminated={1, 2}))
        assert c.state.mode == pkg.state.Mode.ACTIVE
        assert c.state.active_rank == 2  # survivors [0,3,4,5] → index 2
        assert c.state.active_world_size == 4

    def test_shift_ranks_terminated_rank(self, pkg):
        c = pkg.rank_assignment.ShiftRanks()(ctx_for(pkg, 1, 4, terminated={1}))
        assert c.state.mode == pkg.state.Mode.TERMINATED and c.state.active_rank is None

    def test_fill_gaps_keeps_stable_slots(self, pkg):
        for rank, expect in [(0, 0), (2, 2), (4, 1), (5, 3)]:
            c = pkg.rank_assignment.FillGaps()(ctx_for(pkg, rank, 6, terminated={1, 3}))
            assert (c.state.active_rank, c.state.mode) == (expect, pkg.state.Mode.ACTIVE)

    def test_max_active_world_size(self, pkg):
        c = pkg.rank_assignment.MaxActiveWorldSize(2)(ctx_for(pkg, 3, 4))
        assert c.state.mode == pkg.state.Mode.INACTIVE and c.state.active_world_size == 2

    def test_divisible_by(self, pkg):
        c = pkg.rank_assignment.ActiveWorldSizeDivisibleBy(4)(ctx_for(pkg, 5, 7, terminated={0}))
        assert c.state.active_world_size == 4
        assert c.state.mode == pkg.state.Mode.INACTIVE

    def test_divisible_by_abort(self, pkg):
        with pytest.raises(pkg.exceptions.RestartAbort):
            pkg.rank_assignment.ActiveWorldSizeDivisibleBy(8)(ctx_for(pkg, 0, 4, terminated={1}))

    def test_filter_count_grouped_by_key(self, pkg):
        a = pkg.rank_assignment.FilterCountGroupedByKey(lambda r: r // 2, lambda n: n == 2)
        c = a(ctx_for(pkg, 0, 6, terminated={1}))
        assert c.state.mode == pkg.state.Mode.INACTIVE
        c = a(ctx_for(pkg, 2, 6, terminated={1}))
        assert c.state.mode == pkg.state.Mode.ACTIVE and c.state.active_rank == 0

    def test_demote_degraded(self, pkg):
        ra = pkg.rank_assignment
        ctx = ra.RankAssignmentCtx(pkg.state.State(rank=1, world_size=3), frozenset(),
                                   frozenset({1}))
        assert ra.DemoteDegraded(max_active_world_size=2)(ctx).state.mode == pkg.state.Mode.INACTIVE
        ctx = ra.RankAssignmentCtx(pkg.state.State(rank=2, world_size=3), frozenset(),
                                   frozenset({1}))
        c = ra.DemoteDegraded(max_active_world_size=2)(ctx)
        assert (c.state.mode, c.state.active_rank) == (pkg.state.Mode.ACTIVE, 1)


class TestTree:
    def test_dissolve_under_min(self, pkg):
        ra = pkg.rank_assignment
        tree = ra.Tree(layers=[ra.Layer(min_ranks=2, max_ranks=2, key_or_fn=lambda r: r // 2,
                                        flag=ra.LayerFlag.RESERVE)])
        c = tree(ctx_for(pkg, 2, 8, terminated={3}))
        assert c.state.mode == pkg.state.Mode.INACTIVE
        c = tree(ctx_for(pkg, 0, 8, terminated={3}))
        assert c.state.mode == pkg.state.Mode.ACTIVE and c.state.active_world_size == 6

    def test_backfill_across_hosts_within_slice(self, pkg):
        ra = pkg.rank_assignment
        tree = ra.Tree(layers=[
            ra.Layer(min_ranks=2, max_ranks=4, key_or_fn=lambda r: r // 4,
                     flag=ra.LayerFlag.BACKFILL),
            ra.Layer(min_ranks=2, max_ranks=2, key_or_fn=lambda r: r // 2,
                     flag=ra.LayerFlag.RESERVE),
        ])
        c = tree(ctx_for(pkg, 2, 8, terminated={3}))
        assert c.state.mode == pkg.state.Mode.ACTIVE
        assert c.state.active_world_size == 7
        actives = set()
        for r in range(8):
            if r == 3:
                continue
            cc = tree(ctx_for(pkg, r, 8, terminated={3}))
            assert cc.state.mode == pkg.state.Mode.ACTIVE
            actives.add(cc.state.active_rank)
        assert actives == set(range(7))

    def test_world_size_filter(self, pkg):
        ra = pkg.rank_assignment
        tree = ra.Tree(layers=[ra.Layer(min_ranks=1, key_or_fn=None)],
                       world_size_filter=lambda n: (n // 4) * 4)
        c = tree(ctx_for(pkg, 0, 10, terminated={9}))
        assert c.state.active_world_size == 8


class TestPlugins:
    def test_retry_controller(self, pkg):
        s = pkg.state.State(rank=0, world_size=4)
        pkg.initialize.RetryController(max_iterations=3)(s.freeze())
        s.iteration = 3
        with pytest.raises(pkg.exceptions.RestartAbort):
            pkg.initialize.RetryController(max_iterations=3)(s.freeze())

    def test_retry_controller_min_world(self, pkg):
        s = pkg.state.State(rank=0, world_size=2)
        with pytest.raises(pkg.exceptions.RestartAbort):
            pkg.initialize.RetryController(min_world_size=4)(s.freeze())

    def test_fault_counter(self, pkg):
        st = pkg.state.State(rank=0, world_size=1)
        st.fn_exception = RuntimeError("local fault")
        faulted = st.freeze()
        fc = pkg.health_check.FaultCounter(max_rank_faults=2)
        fc(faulted)
        fc(faulted)
        with pytest.raises(pkg.exceptions.HealthCheckError):
            fc(faulted)

    def test_fault_counter_ignores_peer_rounds(self, pkg):
        clean = pkg.state.State(rank=0, world_size=2).freeze()
        fc = pkg.health_check.FaultCounter(max_rank_faults=1)
        for _ in range(5):
            fc(clean)

    def test_device_health_check_passes(self, pkg):
        s = pkg.state.State(rank=0, world_size=1).freeze()
        assert pkg.device_health_check(60.0)(s) is s

    def test_threaded_finalize_runs(self, pkg):
        hits = []
        s = pkg.state.State(rank=0, world_size=1).freeze()
        pkg.finalize.ThreadedFinalize(timeout=5.0, fn=lambda: hits.append(1))(s)
        assert hits == [1]

    def test_threaded_finalize_timeout(self, pkg):
        s = pkg.state.State(rank=0, world_size=1).freeze()
        with pytest.raises(pkg.exceptions.InternalError):
            pkg.finalize.ThreadedFinalize(timeout=0.2, fn=lambda: time.sleep(5))(s)

    def test_compose(self, pkg):
        f = pkg.compose.Compose(lambda x: x + 1, lambda x: x * 2)
        assert f(3) == 8
        assert pkg.compose.isinstance_or_composed(
            pkg.compose.Compose(pkg.finalize.ThreadedFinalize(1.0, lambda: None)),
            pkg.finalize.Finalize,
        )
        assert not pkg.compose.isinstance_or_composed(
            pkg.compose.Compose(lambda x: x), pkg.finalize.Finalize
        )

    def test_inject_fault_exc(self, pkg):
        with pytest.raises(pkg.inject_fault.InjectedFault):
            pkg.inject_fault.inject_fault(pkg.inject_fault.Fault.EXC)


class TestMonitorThread:
    def test_injects_until_acknowledged(self, pkg, store):
        st = store(timeout=10.0)
        coord = pkg.coordination.RestartCoordinator(st, world_size=2)
        aborted = []
        mt = pkg.monitor_thread.MonitorThread(
            coord, iteration=0, main_thread_id=threading.main_thread().ident,
            atomic_lock=threading.RLock(), abort_fn=lambda: aborted.append(1),
            interval=0.05, last_call_wait=0.0,
        )
        mt.start()
        mt.arm()
        coord.record_interruption(0, 1, pkg.attribution.Interruption.EXCEPTION, "peer failed")
        caught = False
        deadline = time.monotonic() + 10.0
        try:
            while time.monotonic() < deadline:
                time.sleep(0.01)
        except pkg.monitor_thread.RankShouldRestart:
            caught = True
        finally:
            mt.acknowledge()
            mt.shutdown()
        assert caught and aborted == [1] and mt.fired
        st.close()

    def test_atomic_section_defers_injection(self, pkg, store):
        st = store(timeout=10.0)
        coord = pkg.coordination.RestartCoordinator(st, world_size=2)
        lock = threading.RLock()
        mt = pkg.monitor_thread.MonitorThread(
            coord, iteration=0, main_thread_id=threading.main_thread().ident,
            atomic_lock=lock, interval=0.05, last_call_wait=0.0,
        )
        mt.start()
        mt.arm()
        interrupted_inside = False
        try:
            with lock:
                coord.record_interruption(0, 1, pkg.attribution.Interruption.EXCEPTION, "x")
                time.sleep(0.5)
                critical_done = True
        except pkg.monitor_thread.RankShouldRestart:
            interrupted_inside = True
            critical_done = False
        caught_outside = False
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                time.sleep(0.01)
        except pkg.monitor_thread.RankShouldRestart:
            caught_outside = True
        finally:
            mt.acknowledge()
            mt.shutdown()
        assert not interrupted_inside and critical_done and caught_outside
        st.close()

    def test_clean_shutdown_without_interruption(self, pkg, store):
        st = store(timeout=10.0)
        coord = pkg.coordination.RestartCoordinator(st, world_size=1)
        mt = pkg.monitor_thread.MonitorThread(
            coord, iteration=0, main_thread_id=threading.main_thread().ident,
            atomic_lock=threading.RLock(), interval=0.05,
        )
        mt.start()
        mt.shutdown()
        assert not mt.fired
        st.close()


class TestProgressWatchdog:
    def test_auto_and_manual_timestamps(self, pkg):
        reports = []
        wd = pkg.progress_watchdog.ProgressWatchdog(
            interval=0.05, report=lambda k, t: reports.append(k), use_native=False
        )
        wd.start()
        time.sleep(0.5)
        wd.ping()
        wd.shutdown()
        assert {"auto", "manual"} <= set(reports)

    def test_pause_stops_auto(self, pkg):
        reports = []
        wd = pkg.progress_watchdog.ProgressWatchdog(
            interval=0.05, report=lambda k, t: reports.append(k), use_native=False
        )
        wd.pause()
        wd.start()
        time.sleep(0.3)
        wd.shutdown()
        assert "auto" not in set(reports)


def test_the_port_refuses_the_native_probe():
    from tpu_resiliency_torch.inprocess.progress_watchdog import ProgressWatchdog

    with pytest.raises(RuntimeError, match="not ported"):
        ProgressWatchdog(interval=0.05, report=lambda k, t: None, use_native=True)
    assert ProgressWatchdog(interval=0.05, report=lambda k, t: None).native is False


class TestCoordinator:
    def test_interruption_roundtrip(self, pkg, store):
        st = store(timeout=10.0)
        coord = pkg.coordination.RestartCoordinator(st, world_size=4)
        assert not coord.is_interrupted(0)
        coord.record_interruption(0, 2, pkg.attribution.Interruption.SOFT_TIMEOUT, "slow")
        assert coord.is_interrupted(0)
        assert coord.wait_interrupted(0, timeout=1.0)
        recs = coord.get_interruptions(0)
        assert len(recs) == 1 and recs[0].rank == 2
        assert not coord.is_interrupted(1)
        st.close()

    def test_on_behalf_barrier_idempotent(self, pkg, store):
        st = store(timeout=10.0)
        coord = pkg.coordination.RestartCoordinator(st, world_size=2)
        coord.complete_barriers_for(0, 1)
        coord.complete_barriers_for(0, 1)
        coord.join_iteration_barrier(0, 0, timeout=5.0)
        coord.join_completion_barrier(0, 0, timeout=5.0)
        st.close()

    def test_terminated_accumulates(self, pkg, store):
        st = store(timeout=10.0)
        coord = pkg.coordination.RestartCoordinator(st, world_size=4)
        coord.record_terminated([1])
        coord.record_terminated([3])
        assert coord.terminated_ranks() == frozenset({1, 3})
        st.close()


class TestCompletionAndGC:
    def test_completion_barrier_yields_to_interruption(self, pkg, store):
        st = store()
        coord = pkg.coordination.RestartCoordinator(st, world_size=2)
        t0 = time.monotonic()

        def fault_soon():
            time.sleep(0.3)
            coord.record_interruption(0, 1, pkg.attribution.Interruption.EXCEPTION, "peer boom")

        threading.Thread(target=fault_soon, daemon=True).start()
        with pytest.raises(pkg.coordination.CompletionInterrupted):
            coord.join_completion_barrier(0, rank=0, timeout=60.0, poll_interval=0.05)
        assert time.monotonic() - t0 < 5.0
        st.close()

    def test_completion_barrier_releases(self, pkg, store):
        st = store()
        coord = pkg.coordination.RestartCoordinator(st, world_size=2)
        done = []

        def other():
            c2 = pkg.coordination.RestartCoordinator(store(), 2)
            c2.join_completion_barrier(0, rank=1, timeout=10.0, poll_interval=0.05)
            done.append(1)

        t = threading.Thread(target=other, daemon=True)
        t.start()
        coord.join_completion_barrier(0, rank=0, timeout=10.0, poll_interval=0.05)
        t.join(10.0)
        assert done == [1]
        st.close()

    def test_cleanup_iteration_reclaims_round_state(self, pkg, store):
        st = store()
        coord = pkg.coordination.RestartCoordinator(st, world_size=2)
        coord.record_interruption(3, 0, pkg.attribution.Interruption.SOFT_TIMEOUT, "slow")
        coord.complete_barriers_for(3, 0)
        coord.record_terminated([1])
        coord.cleanup_iteration(3)
        assert coord.get_interruptions(3) == []
        assert not coord.is_interrupted(3)
        assert st.barrier_status("barrier/iteration/3") is None
        assert coord.terminated_ranks() == frozenset({1})
        st.close()


def test_the_port_store_talks_to_the_reference_store():
    """The wire protocol is one: a port client on a reference server and back."""
    import tpu_resiliency.platform.store as ref_store
    import tpu_resiliency_torch.platform.store as port_store

    for server_mod, client_mod in ((ref_store, port_store), (port_store, ref_store)):
        server = server_mod.KVServer(host="127.0.0.1", port=0)
        try:
            a = client_mod.CoordStore("127.0.0.1", server.port, timeout=10.0)
            b = server_mod.CoordStore("127.0.0.1", server.port, timeout=10.0)
            a.set("k", {"v": [1, 2]})
            assert b.get("k") == {"v": [1, 2]}
            a.close()
            b.close()
        finally:
            server.close()
