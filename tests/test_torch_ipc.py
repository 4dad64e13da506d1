"""The port's local IPC, held against ``tests/platform/test_ipc.py`` and
``tests/platform/test_ipc_chaos.py``: each of their tests runs here on
``tpu_resiliency_torch.platform.ipc`` (``torch_port_tests``), with the port's chaos
plans and monitor client. The frames are the port's wire (``platform/wire.py``): beside
them, the same objects framed by either package read back equal in the other, and an
oversized frame is refused as the reference refuses it.
"""

import socket

import pytest

import tpu_resiliency.platform.ipc as ref_ipc
import tpu_resiliency.watchdog.data as ref_data
import tpu_resiliency_torch.platform.ipc as port_ipc
import tpu_resiliency_torch.watchdog.data as port_data
from tests.torch_port_tests import port_tests

port_tests("tests/platform/test_ipc.py", globals())
port_tests("tests/platform/test_ipc_chaos.py", globals())


def messages(data):
    info = data.RankInfo(global_rank=5, local_rank=1, host="h", pid=99)
    return [
        {"n": [1, 2, 3], "s": "x"},
        data.InitMsg(rank_info=info, client_state=None, capabilities={"dump_signal": True}),
        data.HeartbeatMsg(rank=5, timestamp=1.5, location={"section": "step"}),
        data.SectionMsg(rank=5, action=data.SectionAction.OPEN, name="step", timestamp=2.5),
        data.WorkloadControlRequest(data.WorkloadAction.ExcludeThisNode, info, "bad"),
    ]


@pytest.mark.parametrize("index", range(5))
@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_a_frame_of_either_package_reads_back_equal_in_the_other(index, direction):
    send, recv = (port_ipc, ref_ipc) if direction == "port->ref" else (ref_ipc, port_ipc)
    send_data, recv_data = ((port_data, ref_data) if direction == "port->ref"
                            else (ref_data, port_data))
    a, b = socket.socketpair()
    try:
        send.write_object(a, messages(send_data)[index])
        got = recv.read_object(b)
    finally:
        a.close()
        b.close()
    assert got == messages(recv_data)[index]


def test_an_oversized_frame_is_refused():
    a, b = socket.socketpair()
    try:
        a.sendall((1 << 40).to_bytes(8, "big"))
        with pytest.raises(ValueError, match="frame too large"):
            port_ipc.read_object(b)
    finally:
        a.close()
        b.close()
