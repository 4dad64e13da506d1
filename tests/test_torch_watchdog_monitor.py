"""The port's rank monitor and its client, held against ``tests/watchdog/test_monitor.py``
and ``tests/watchdog/test_hang_forensics.py``: each of their tests runs here on
``tpu_resiliency_torch.watchdog`` (``torch_port_tests``), with the port's store, UDS
framing and spawned monitor processes. The metrics bridge those tests check is the
JAX package's ``utils/metrics.py`` (not ported yet), fed the port's event records: the
records are one schema.

Beside them, the wire is one: a port ``RankMonitorClient`` drives a JAX-package
``RankMonitorServer`` and the other way round (init, config reply, heartbeats,
sections, timeout updates, state, status probes, and a hang the monitor of the other
package detects and kills), and a rank's ``WorkloadControlRequest`` reaches the other
package's launcher listener.
"""

import multiprocessing as mp
import os
import signal
import sys
import time

import pytest

import tpu_resiliency.platform.ipc as ref_ipc
import tpu_resiliency.watchdog as ref_watchdog
import tpu_resiliency.watchdog.data as ref_data
import tpu_resiliency_torch.platform.ipc as port_ipc
import tpu_resiliency_torch.platform.wire as wire
import tpu_resiliency_torch.watchdog as port_watchdog
import tpu_resiliency_torch.watchdog.data as port_data
from tests.torch_port_tests import port_tests


@pytest.fixture
def kv_server():
    from tpu_resiliency_torch.platform.store import KVServer

    server = KVServer(host="127.0.0.1", port=0)
    yield server
    server.close()


@pytest.fixture
def coord_store(kv_server):
    from tpu_resiliency_torch.platform.store import CoordStore

    store = CoordStore("127.0.0.1", kv_server.port, timeout=30.0)
    yield store
    store.close()


METRICS = ("from tpu_resiliency_torch.utils.metrics import MetricsRegistry, observe_record",
           "from tpu_resiliency.utils.metrics import MetricsRegistry, observe_record",
           "utils/metrics.py is not ported: the JAX package's registry reads the port's records")

port_tests("tests/watchdog/test_monitor.py", globals())
port_tests("tests/watchdog/test_hang_forensics.py", globals(), edits=[METRICS])


# -- one wire, both ways ---------------------------------------------------------------

PACKAGES = {"ref": ref_watchdog, "port": port_watchdog}
PAIRS = [("port", "ref"), ("ref", "port")]  # (client's package, server's package)


def start_monitor(pkg, path, **cfg):
    cfg = pkg.FaultToleranceConfig(**{"workload_check_interval": 0.1, **cfg})
    return pkg.RankMonitorServer.run_in_subprocess(cfg, path, start_method="spawn")


def connect(pkg, path, rank=0, pid=None):
    c = pkg.RankMonitorClient()
    c.init_workload_monitoring(
        socket_path=path,
        rank_info=pkg.RankInfo(global_rank=rank, local_rank=rank, host="h",
                               pid=pid or os.getpid()),
    )
    return c


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_a_client_of_either_package_drives_the_other_packages_monitor(
        client_pkg, server_pkg, tmp_uds_path):
    client, server = PACKAGES[client_pkg], PACKAGES[server_pkg]
    mon = start_monitor(server, tmp_uds_path, initial_rank_heartbeat_timeout=None,
                        rank_heartbeat_timeout=None, safety_factor=3.0)
    try:
        c = connect(client, tmp_uds_path, rank=3)
        # The config reply is the server's class, read as the client's own.
        assert type(c.cfg) is client.FaultToleranceConfig
        assert c.cfg.safety_factor == 3.0 and c.cfg.workload_check_interval == 0.1
        assert type(c.hb_timeouts) is client.HeartbeatTimeouts
        for _ in range(3):
            c.send_heartbeat()
            time.sleep(0.01)
        c.start_section("step")
        c.end_section("step")
        c.start_section("checkpointing")
        c.end_all_sections()
        t = c.calculate_and_set_hb_timeouts()
        assert t.calculated and t.are_valid
        state = c.state_dict()
        c2 = client.RankMonitorClient()
        c2.load_state_dict(state)
        assert c2._loaded_state["hb_timeouts"].calculated
        sock = client.RankMonitorClient.__module__  # the client's own ipc module
        ipc = port_ipc if sock.startswith("tpu_resiliency_torch") else ref_ipc
        data = port_data if ipc is port_ipc else ref_data
        probe = ipc.connect(tmp_uds_path, timeout=5.0)
        try:
            ipc.write_object(probe, data.StatusMsg())
            status = ipc.read_object(probe).payload
        finally:
            probe.close()
        assert status["connected"] and status["rank"] == 3 and status["pid"] == os.getpid()
        assert status["open_sections"] == {}
        c.shutdown_workload_monitoring()
    finally:
        mon.terminate()
        mon.join(5.0)


def _silent_rank(pkg_name, path, ready_q):
    """Child: connects with tight heartbeat timeouts, beats once, then hangs."""
    pkg = PACKAGES[pkg_name]
    data = port_data if pkg is port_watchdog else ref_data
    c = connect(pkg, path)
    c._request(data.UpdateTimeoutsMsg(
        hb_timeouts=pkg.HeartbeatTimeouts(initial=0.5, subsequent=0.5, calculated=True)))
    c.send_heartbeat()
    ready_q.put(os.getpid())
    time.sleep(60)
    sys.exit(0)


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_the_other_packages_monitor_kills_a_silent_rank(client_pkg, server_pkg, tmp_uds_path):
    mon = start_monitor(PACKAGES[server_pkg], tmp_uds_path,
                        rank_termination_signal=signal.SIGTERM, stack_dump_grace=0.0)
    try:
        ctx = mp.get_context("fork")
        ready_q = ctx.Queue()
        victim = ctx.Process(target=_silent_rank, args=(client_pkg, tmp_uds_path, ready_q))
        victim.start()
        ready_q.get(timeout=30.0)
        victim.join(15.0)
        assert not victim.is_alive(), "the silent rank was not killed"
        assert victim.exitcode == -signal.SIGTERM
    finally:
        mon.terminate()
        mon.join(5.0)


@pytest.mark.parametrize("sender,receiver", PAIRS)
def test_a_control_request_reaches_the_other_packages_launcher(sender, receiver, tmp_uds_path):
    send_ipc, send_data = (port_ipc, port_data) if sender == "port" else (ref_ipc, ref_data)
    recv_ipc, recv_data = (port_ipc, port_data) if receiver == "port" else (ref_ipc, ref_data)
    rx = recv_ipc.IpcReceiver(tmp_uds_path)
    rx.start()
    try:
        sender_info = send_data.RankInfo(global_rank=2, local_rank=0, host="h", pid=7)
        send_ipc.send_to(tmp_uds_path, send_data.WorkloadControlRequest(
            send_data.WorkloadAction.ShutdownWorkload, sender_info, "stop"))
        deadline = time.monotonic() + 10.0
        msgs = []
        while not msgs and time.monotonic() < deadline:
            msgs = rx.fetch()
            time.sleep(0.01)
    finally:
        rx.stop()
    (msg,) = msgs
    assert isinstance(msg, recv_data.WorkloadControlRequest)
    assert msg.action is recv_data.WorkloadAction.ShutdownWorkload
    assert isinstance(msg.sender, recv_data.RankInfo)
    assert (msg.reason, msg.sender.global_rank, msg.sender.pid) == ("stop", 2, 7)


def test_the_wire_names_the_port_classes_by_the_reference_paths():
    cfg = port_watchdog.FaultToleranceConfig(safety_factor=2.0)
    blob = wire.dumps(port_data.InitReplyMsg(
        config=cfg, hb_timeouts=port_data.HeartbeatTimeouts(), section_timeouts=None))
    assert b"tpu_resiliency_torch" not in blob
    import pickle

    ref = pickle.loads(blob)  # a JAX-package process reads it with plain pickle
    assert type(ref) is ref_data.InitReplyMsg
    assert type(ref.config) is ref_watchdog.FaultToleranceConfig
    assert ref.config.safety_factor == 2.0
    back = wire.loads(pickle.dumps(ref))
    assert type(back) is port_data.InitReplyMsg
    assert type(back.config) is port_watchdog.FaultToleranceConfig
    assert wire.loads(wire.dumps({"k": [1, (2, 3)]})) == {"k": [1, (2, 3)]}
