"""The port's fault-tolerance callbacks, held against the FT tests of
``tests/integrations/test_loop_callbacks.py`` (heartbeats and the finished flag, the
simulated fault, the sections callback, saves inside the loop's checkpoint brackets,
and a cooperative stop that writes no flag). Each scenario runs through both
packages, each callback on its own package's loop and spawned monitor, and must give
the same outcome: loop state, heartbeats, flags, the section names the calculator
saw and the FT event kinds.
"""

import contextlib
import importlib
import os
import types

import pytest
import torch

PACKAGES = ("tpu_resiliency", "tpu_resiliency_torch")


def load(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, integrations=mod("integrations"), ft=mod("integrations.ft_callbacks"),
        ipc=mod("platform.ipc"), events=mod("utils.events"), watchdog=mod("watchdog"),
        local_manager=mod("checkpoint.local_manager"),
    )


@contextlib.contextmanager
def monitored(root, tmp_path):
    """One package's namespace, with its own spawned monitor on ``$MONITOR_SOCKET``."""
    p = load(root)
    sock = str(tmp_path / f"m_{root.rsplit('_', 1)[-1]}.sock")
    cfg = p.watchdog.FaultToleranceConfig(initial_rank_heartbeat_timeout=30.0,
                                          rank_heartbeat_timeout=30.0,
                                          workload_check_interval=0.5)
    proc = p.watchdog.RankMonitorServer.run_in_subprocess(cfg, sock, start_method="spawn")
    old = os.environ.get(p.ipc.MONITOR_SOCKET_ENV)
    os.environ[p.ipc.MONITOR_SOCKET_ENV] = sock
    try:
        yield p
    finally:
        if old is None:
            os.environ.pop(p.ipc.MONITOR_SOCKET_ENV, None)
        else:
            os.environ[p.ipc.MONITOR_SOCKET_ENV] = old
        proc.terminate()
        proc.join(timeout=10)
        assert not proc.is_alive()


def same_outcome(scenario, tmp_path):
    """``scenario(pkg, tmp_path)`` through each package, one after the other, each
    under its own monitor; returns the outcome both gave."""
    outcomes = []
    for root in PACKAGES:
        work = tmp_path / root
        work.mkdir()
        with monitored(root, work) as pkg:
            outcomes.append(scenario(pkg, work))
    assert outcomes[0] == outcomes[1], dict(zip(PACKAGES, outcomes))
    return outcomes[0]


def ft_callback_heartbeats_and_finished_flag(pkg, tmp_path):
    flag = str(tmp_path / "finished.flag")
    sd_path = str(tmp_path / "ft_state.pkl")
    cb = pkg.integrations.FaultToleranceCallback(
        autoresume=True, finished_flag_path=flag, state_dict_path=sd_path)
    seen = []
    pkg.events.add_sink(seen.append)
    try:
        ctx = pkg.integrations.run_training(lambda s, i: s + 1, 0, 5, callbacks=[cb])
    finally:
        pkg.events.remove_sink(seen.append)
    kinds = sorted({e.kind for e in seen if e.source == "ft"})
    tc = next(e for e in seen if e.kind == "timeouts_calculated")
    assert tc.payload["initial_s"] > 0 and tc.payload["subsequent_s"] > 0
    cb2 = pkg.integrations.FaultToleranceCallback(autoresume=True, finished_flag_path=flag)
    ctx2 = pkg.integrations.run_training(lambda s, i: s + 1, 0, 5, callbacks=[cb2])
    outcome = (ctx.state, cb.machine.heartbeats >= 5, cb.machine.finished,
               os.path.exists(flag), os.path.exists(sd_path), kinds, ctx2.state,
               ctx2.should_stop)
    assert outcome[:5] == (5, True, True, True, True)
    assert {"timeouts_calculated", "training_finished"} <= set(kinds)
    return outcome


def ft_callback_simulated_fault(pkg, tmp_path):
    cb = pkg.integrations.FaultToleranceCallback(simulated_fault_step=2)
    with pytest.raises(pkg.ft.SimulatedFault, match="simulated fault"):
        pkg.integrations.run_training(lambda s, i: s + 1, 0, 5, callbacks=[cb])
    outcome = (cb.machine.exception_seen, cb.machine.finished, cb.machine.heartbeats)
    assert outcome[:2] == (True, False)
    return outcome


def ft_sections_callback(pkg, tmp_path):
    cb = pkg.integrations.FaultToleranceSectionsCallback()
    ctx = pkg.integrations.run_training(lambda s, i: s + 1, 0, 4, callbacks=[cb],
                                        checkpoint_every=2, checkpoint_fn=lambda s, i: None)
    calc = cb.client.timeouts_calc
    assert all(v >= 0 for v in calc.section_max_elapsed.values())
    outcome = (ctx.state, sorted(calc.section_max_elapsed))
    assert outcome[0] == 4 and {"setup", "step", "checkpointing"} <= set(outcome[1])
    return outcome


def checkpoint_saves_inside_the_loops_brackets(pkg, tmp_path):
    """``save_now`` wired as ``checkpoint_fn``: the sections callback attributes the
    saves to ``checkpointing``. The port's state is a CPU tensor; the JAX package's a
    jax array."""
    if pkg.root == "tpu_resiliency_torch":
        zero, one, device = torch.zeros(()), torch.ones(()), {"device": "cpu"}
    else:
        import jax.numpy as jnp

        zero, one, device = jnp.zeros(()), jnp.ones(()), {}
    mgr = pkg.local_manager.LocalCheckpointManager(str(tmp_path / "local"), rank=0)
    ckpt_cb = pkg.integrations.HierarchicalCheckpointCallback(
        local_manager=mgr, local_every=2, to_state_dict=lambda s: {"w": s},
        from_state_dict=lambda s, loaded: loaded["w"], driven_by_loop=True, **device)
    sections = pkg.integrations.FaultToleranceSectionsCallback()
    ctx = pkg.integrations.run_training(lambda s, i: s + one, zero, 4,
                                        callbacks=[sections, ckpt_cb],
                                        checkpoint_every=ckpt_cb.cadence,
                                        checkpoint_fn=ckpt_cb.save_now)
    ckpt_cb.close()
    checkpointing = sections.client.timeouts_calc.section_max_elapsed.get("checkpointing", 0)
    outcome = (float(ctx.state), mgr.find_latest(), checkpointing > 0)
    assert outcome == (4.0, 4, True)
    return outcome


def cooperative_stop_does_not_write_finished_flag(pkg, tmp_path):
    flag = str(tmp_path / "f.flag")

    class StopAtTwo(pkg.integrations.Callback):
        def on_step_end(self, ctx):
            if ctx.step == 2:
                raise pkg.integrations.StopTraining

    cb = pkg.integrations.FaultToleranceCallback(autoresume=True, finished_flag_path=flag)
    ctx = pkg.integrations.run_training(lambda s, i: s + 1, 0, 100,
                                        callbacks=[cb, StopAtTwo()])
    outcome = (ctx.state, os.path.exists(flag), cb.machine.finished)
    assert outcome == (3, False, False)
    return outcome


SCENARIOS = {f.__name__: f for f in (
    ft_callback_heartbeats_and_finished_flag, ft_callback_simulated_fault,
    ft_sections_callback, checkpoint_saves_inside_the_loops_brackets,
    cooperative_stop_does_not_write_finished_flag,
)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_both_packages_give_the_same_outcome(scenario, tmp_path):
    same_outcome(SCENARIOS[scenario], tmp_path)
